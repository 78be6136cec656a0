"""The PyTorch port imports nothing of JAX or of the JAX package.

A runtime "jax not in sys.modules" check proves nothing where jax is
pre-imported at interpreter start, so the check is twofold: an AST scan of
every import statement in carel_tpu_torch (and chip_smoke.py), and a
subprocess that imports every module of the port and then looks for
carel_tpu / carel_tpu.* in sys.modules.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "carel_tpu_torch"
# the root bench.py and __graft_entry__.py import jax and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "carel_tpu",
             "__graft_entry__", "bench")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


# chip_smoke.py and the kernel tests run on the GPU machine, which has no JAX
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_carel_tpu_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("carel_tpu.data.bow")
    assert _forbidden("jax.numpy")
    assert not _forbidden("carel_tpu_torch.data.bow")
    assert not _forbidden("jaxtyping")
    assert _forbidden("__graft_entry__") and _forbidden("bench")
    assert not _forbidden("carel_tpu_torch.bench")


def test_importing_the_port_loads_no_jax_package_module():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__main__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'carel_tpu' or m.startswith('carel_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# modules of the adapter, bf16-mu and pair slice, of the embedder, CIT and
# original slice, of the pretraining and tools slice, of the mesh and
# segmentation-cache slice and the bench: the scan above must
# reach them (it walks the package, so a module moved out of it would drop
# out)
SLICE_MODULES = ("ops/entmax.py", "models/pair_classifier.py",
                 "train/pair_trainer.py", "tools/memorization_plot.py",
                 "pretrain/mlm.py", "embeddings.py", "data/triples.py",
                 "train/cit_trainer.py", "models/drl_original.py",
                 "train/steps_original.py", "train/original_driver.py",
                 "tools/clustering.py", "tools/mlm_scorer.py",
                 "tools/ordering.py", "tools/case_analysis.py",
                 "tools/hpo.py", "tools/convert.py", "tools/vis.py",
                 "tools/event_analysis.py", "utils/text.py",
                 "ops/pairwise.py", "cli/main.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/sharding.py", "parallel/tp.py",
                 "data/synthetic.py", "bench.py")


# the host tools import sklearn, matplotlib and jieba only where they use
# them: the GPU machine has none of the three; bench.py imports
# transformers only inside the reference's step
LAZY = ("sklearn", "matplotlib", "jieba", "transformers")


@pytest.mark.parametrize("rel", ("tools/vis.py", "tools/event_analysis.py",
                                 "pretrain/mlm.py", "cli/main.py",
                                 "data/bow.py", "data/synthetic.py",
                                 "bench.py"))
def test_host_libraries_are_imported_lazily(rel):
    tree = ast.parse((PORT / rel).read_text(encoding="utf8"))
    top = [mod for node in tree.body
           for mod in ([a.name for a in node.names]
                       if isinstance(node, ast.Import) else
                       [node.module or ""] if isinstance(node, ast.ImportFrom)
                       else [])]
    assert not [m for m in top if m.split(".")[0] in LAZY], (rel, top)


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_scan_covers_the_slice_modules(rel):
    path = PORT / rel
    assert path in SOURCES, rel
    assert not [mod for _, mod in _imports(path) if _forbidden(mod)]
