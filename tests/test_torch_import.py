"""The PyTorch port stands alone: it imports with jax absent, and no
module of it imports jax or the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "skypilot_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def test_every_module_imports_with_jax_absent():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'skypilot_tpu' or "
            "k.startswith('skypilot_tpu.') for k in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "skypilot_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for name in _imported(tree):
        assert name.split(".")[0] not in ("jax", "skypilot_tpu"), name


def test_the_adapter_catalog_is_covered():
    """``infer/adapters.py`` keeps its own copies of what it needs from
    the reference's host-only modules (the metric families, the load
    retry) and takes its fault point from the port's own chaos layer:
    it is among the modules imported with jax absent above, and its
    source names none of the reference's."""
    assert "skypilot_tpu_torch.infer.adapters" in MODULES
    src = (PKG / "infer" / "adapters.py").read_text()
    for name in ("utils.retry", "observability.tracing"):
        assert f"import {name}" not in src and f".{name} import" not in src
    assert "from skypilot_tpu_torch import DeviceLike, chaos," in src
    assert "skypilot_tpu.chaos" not in src
