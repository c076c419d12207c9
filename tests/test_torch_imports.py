"""The port stands alone: no module of onda_torch/ and not chip_smoke.py
imports jax, flax, orbax or onda_tpu, and the package imports with jax
unavailable."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "onda_tpu")


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "onda_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_the_scan_covers_every_port_package():
    """The sources scanned include the parallel package (the spatial axis
    among it), the metadata scanner's entry point, the quality run with its
    synthetic dataset, and the DeepLab-v3 zoo."""
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for rel in ("onda_torch/parallel/__init__.py", "onda_torch/parallel/distributed.py",
                "onda_torch/parallel/mesh.py", "onda_torch/parallel/spatial.py",
                "onda_torch/make_metadata.py", "onda_torch/data/metadata.py",
                "onda_torch/quality_run.py", "onda_torch/data/synthetic.py",
                "onda_torch/models/deeplabv3.py"):
        assert rel in scanned


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_onda_tpu_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_package_imports_without_jax():
    modules = ["onda_torch." + os.path.relpath(p, ROOT)[len("onda_torch/"):-3].replace(os.sep, ".")
               for p in _sources() if p.startswith(os.path.join(ROOT, "onda_torch"))]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import sys\n"
            + "".join(f"sys.modules[{name!r}] = None\n" for name in FORBIDDEN)
            + "import importlib\n"
            + f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            + "import chip_smoke\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_pandas_or_pil_imports(path):
    # the card's machine need not have them: metadata tables are read with
    # json, PNGs are decoded by the C++ prep and written with zlib
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("pandas", "PIL"), f"{path}:{node.lineno} imports {name}"
