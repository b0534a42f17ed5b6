"""The PyTorch port imports neither jax nor the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "mpc_collisionavoidance_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_package_and_chip_smoke_import_with_jax_blocked():
    """In a fresh interpreter where `import jax` fails, every module of the
    port and chip_smoke.py's imports load."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['mpc_collisionavoidance_tpu'] = None",
        f"for name in {MODULES!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mpc_collisionavoidance_tpu\b"
    r"(?!_torch)|from\s+mpc_collisionavoidance_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), path
