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
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    + sorted((REPO / "tools").glob("*.py"))))
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_rt_server_help_with_jax_blocked():
    """The serving modules import, and `python -m
    mpc_collisionavoidance_tpu_torch.rt.server --help` exits 0, in an
    interpreter where `import jax` fails."""
    assert {"mpc_collisionavoidance_tpu_torch.rt.server",
            "mpc_collisionavoidance_tpu_torch.rt.protocol"} <= set(MODULES)
    code = "\n".join([
        "import runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['mpc_collisionavoidance_tpu'] = None",
        "sys.argv = ['server', '--help']",
        "runpy.run_module('mpc_collisionavoidance_tpu_torch.rt.server',",
        "                 run_name='__main__')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--rti-split" in proc.stdout and "--device" in proc.stdout
    assert "--engine" in proc.stdout


def test_cli_with_jax_blocked():
    """In an interpreter where `import jax` fails, `python -m
    mpc_collisionavoidance_tpu_torch --help`, `run --help` and `models`
    exit 0; `--device` shows in the run help, and models lists 13."""
    assert {"mpc_collisionavoidance_tpu_torch.cli",
            "mpc_collisionavoidance_tpu_torch.__main__"} <= set(MODULES)
    code = "\n".join([
        "import contextlib, io, runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['mpc_collisionavoidance_tpu'] = None",
        "for argv in (['--help'], ['run', '--help'], ['models']):",
        "    sys.argv = ['mpc_collisionavoidance_tpu_torch'] + argv",
        "    buf = io.StringIO()",
        "    try:",
        "        with contextlib.redirect_stdout(buf):",
        "            runpy.run_module('mpc_collisionavoidance_tpu_torch',",
        "                             run_name='__main__')",
        "    except SystemExit as e:",
        "        assert e.code in (0, None), (argv, e.code)",
        "    print('>>', ' '.join(argv))",
        "    print(buf.getvalue())",
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.split(">> ")
    assert out[1].startswith("--help") and "mission" in out[1]
    assert out[2].startswith("run --help") and "--device" in out[2]
    assert len(out[3].strip().splitlines()) == 14     # ">> models" + 13


# the per-instance engine's modules (ROADMAP A7)
INSTANCE_MODULES = {
    f"mpc_collisionavoidance_tpu_torch.{m}" for m in (
        "ops.integrators", "ops.riccati", "ops.linearize", "ops.ipm",
        "ops.condense", "ops.dense_qp", "solver.sqp_rti", "parity.goldens")}


def test_instance_engine_runs_with_jax_blocked():
    """In a fresh interpreter where `import jax` fails, the per-instance
    engine's modules import, an RTI tick of each QP backend runs on the
    CPU and a committed golden loads; jax never enters sys.modules."""
    assert INSTANCE_MODULES <= set(MODULES)
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['mpc_collisionavoidance_tpu'] = None",
        "import numpy as np, torch",
        "from mpc_collisionavoidance_tpu_torch.config import SolverConfig",
        "from mpc_collisionavoidance_tpu_torch.ocp import builders",
        "from mpc_collisionavoidance_tpu_torch.parity import goldens",
        "spec = builders.usv_guidance_ca1(Tf=1.0, N=5)",
        "for backend in ('riccati', 'dense'):",
        "    s = SolverConfig(engine='instance', ipm_iters=4,",
        "                     qp_backend=backend).build(",
        "        spec, device='cpu', dtype=torch.float64)",
        "    x0 = np.array([0.7, 0, -4.0, -1.57, -1.57, 0, 0, 0])",
        "    _, out = s.step_fn(s.init_state(x0), x0, np.full(16, 100.0),",
        "                       np.zeros(8))",
        "    assert torch.isfinite(out.u0).all()",
        "assert goldens.load_golden('usv_guidance_ca1', 'rti').simU.shape",
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# the acados parity bridge: casadi and acados_template only inside the
# functions that call acados
PARITY_BRIDGE = {
    f"mpc_collisionavoidance_tpu_torch.parity.{m}" for m in (
        "casadi_models", "acados_oracle", "run_acados_parity")}


def test_parity_bridge_imports_neither_jax_nor_casadi():
    """In a fresh interpreter where `import jax`, `import casadi` and
    `import acados_template` fail, the bridge's modules import, the torch
    binding of the flagship's transcription runs, and none of the three
    enters sys.modules; `make_casadi_model_fn` builds and raises
    ImportError only when called."""
    assert PARITY_BRIDGE <= set(MODULES)
    code = "\n".join([
        "import importlib, sys",
        "for m in ('jax', 'mpc_collisionavoidance_tpu', 'casadi',",
        "          'acados_template'):",
        "    sys.modules[m] = None",
        f"for name in {sorted(PARITY_BRIDGE)!r}:",
        "    importlib.import_module(name)",
        "import torch",
        "from mpc_collisionavoidance_tpu_torch.parity import (",
        "    acados_oracle, casadi_models)",
        "f = casadi_models.numeric_f('usv_guidance_ca1')",
        "assert f(torch.zeros(8), torch.zeros(1), torch.zeros(16)).shape "
        "== (8,)",
        "assert not acados_oracle.acados_available()",
        "fn = casadi_models.make_casadi_model_fn('usv_guidance_ca1')",
        "try:",
        "    fn()",
        "    raise SystemExit('no ImportError')",
        "except ImportError:",
        "    pass",
        "loaded = [m for m in sys.modules if sys.modules[m]]",
        "assert not {'jax', 'casadi', 'acados_template'} & set(loaded), "
        "loaded",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
