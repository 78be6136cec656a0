"""Build and load the hand-written CUDA kernels (``carel_tpu_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, into an object with a plain C interface; the objects are linked into
one shared library that ``ctypes`` loads. The build happens at first use, into
``build/carel_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the sources, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing here runs at import time: this module imports
on machines without ``nvcc`` or a GPU, where only the plain versions run.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "carel_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# C entry points and their argument types; pointers and the stream are
# c_void_p so that 64-bit addresses are not cut to 32 bits
_SIGNATURES = {
    "carel_error_string": ([_I], ctypes.c_char_p),
    "carel_mmd_max_dim": ([], _I),
    "carel_mmd_max_alphas": ([], _I),
    "carel_mmd_tile_rows": ([], _I),
    # x y mask | B d | alphas[4] n_alphas | scratch buf stream
    "carel_mmd_fwd": ([_P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P, _P],
                      _I),
    # x y mask | B d | alphas[4] n_alphas | res g dx dy stream
    "carel_mmd_bwd": ([_P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P, _P, _P,
                       _P], _I),
    "carel_hsic_residuals": ([_I], _I),
    "carel_hsic_max_dim": ([], _I),
    "carel_hsic_max_rows": ([], _I),
    "carel_hsic_fwd_scratch": ([_I], _I),
    # x y mask | B d | s_x s_y | res scratch out stream
    "carel_hsic_fwd": ([_P, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P], _I),
    "carel_hsic_bwd": ([_P, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P], _I),
    "carel_bow_max_dim": ([], _I),
    "carel_bow_fwd_scratch": ([_I, _I, _I, _I], _LL),
    "carel_bow_bwd_scratch": ([_I, _I, _I, _I], _LL),
    "carel_bow_fwd": ([_P, _P, _P, _I, _I, _I, _P, _P, _P], _I),
    # h W b | B D V | columns a chunk, blocks, keep z | scratch out stream
    "carel_bow_fwd_planned": ([_P, _P, _P] + [_I] * 6 + [_P, _P, _P], _I),
    "carel_bow_bwd": ([_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    # h W b | B D V | columns a chunk, blocks | rowp dW db dh scratch stream
    "carel_bow_bwd_planned": ([_P, _P, _P] + [_I] * 5 + [_P] * 6, _I),
    "carel_flash_takes_head_dim": ([_I], _I),
    # q k v seg o lse | B h L hd | strides of qkv, o | scale is_bf16 stream
    "carel_flash_fwd": ([_P] * 6 + [_I] * 4 + [_LL] * 6 + [_F, _I, _P], _I),
    # q k v seg o do lse delta dq | B h L hd | strides of qkv, o, do, dq | ...
    "carel_flash_bwd_dq": ([_P] * 9 + [_I] * 4 + [_LL] * 12 + [_F, _I, _P],
                           _I),
    # q k v seg do lse delta dk dv | B h L hd | strides of qkv, do, dkv | ...
    # (flash.cu sends bf16 inputs of all three on to flash_mma.cu)
    "carel_flash_bwd_dkv": ([_P] * 9 + [_I] * 4 + [_LL] * 9 + [_F, _I, _P],
                            _I),
}

_lib = None

# the library's limits and constants (every entry point that takes no
# argument), read once when it loads: {name: value}
consts: dict = {}


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): cannot build the "
                           "carel_tpu_torch CUDA kernels")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libcarel_kernels_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path. An existing library for the same sources is reused."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler",
                   "-fPIC", "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
            if not argtypes and restype is _I:
                consts[name] = fn()
        _lib = handle
    return _lib


def check_input(t: torch.Tensor, name: str, shape: tuple,
                device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype (float32
    unless given) and shape on ``device`` — what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream(device: torch.device) -> int:
    """The address of the current stream on ``device`` (the current device
    where it has no index): the raw handle, without a Stream object."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib().carel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
