"""At-first-use build of the _fastingest C extension.

Invokes the system C compiler directly (``$CC``, else ``cc``) on
``carel_tpu_torch/csrc/fastingest.c`` against this interpreter's headers,
into ``build/carel_tpu_torch/`` at the root of the checkout, never next to
the module. The file name carries a hash of the source and of the
interpreter's extension suffix, so an edited source is rebuilt. Two
processes that build at once each write a temporary file and rename it into
place; the last rename wins, with the same bytes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fastingest.c"
BUILD_DIR = _PKG.parent / "build" / "carel_tpu_torch"

_CACHED = None
_TRIED = False
# why the last build or load failed ("" when it did not)
last_error = ""


def so_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(SOURCE.read_bytes() + suffix.encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"_fastingest_{digest}{suffix}"


def build(verbose: bool = False) -> Optional[Path]:
    """The built extension's path, or None when it does not build."""
    global last_error
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_paths()["include"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cc, "-shared", "-fPIC", "-O3", f"-I{include}", str(SOURCE),
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, OSError) as e:
        last_error = (getattr(e, "stderr", "") or str(e)).strip()[-500:]
        if os.path.exists(tmp):
            os.unlink(tmp)
        if verbose:
            print(f"fastingest build failed: {last_error}", file=sys.stderr)
        return None


def load_fastingest():
    """The _fastingest module, or None when it cannot be built or loaded
    (tried once a process)."""
    global _CACHED, _TRIED, last_error
    if _TRIED:
        return _CACHED
    _TRIED = True
    so = build()
    if so is None:
        return None
    spec = importlib.util.spec_from_file_location("_fastingest", so)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        _CACHED = mod
    except (ImportError, OSError) as e:
        last_error = str(e)
        _CACHED = None
    return _CACHED
