"""The port's acados parity runner (`parity/run_acados_parity.py`), float64
on the CPU, without acados: `_scenario` against the JAX package's for
every variant; the fixture format's round trip through the port's own
closed loop; fixtures written by either package's `RTISolver` replayed by
the other's `replay_fixture` (the flagship and the hull with its
per-stage yref) within the per-instance engine's parity of 1e-8; a
perturbed fixture failing; `main`'s replay line, its exit codes and its
default device; and every committed acados fixture (tests/goldens/acados,
none yet) replayed within the <1e-3 target."""

import contextlib
import glob
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.parity import run_acados_parity as jrap
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JaxRTI
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.parity import casadi_models
from mpc_collisionavoidance_tpu_torch.parity import run_acados_parity as rap
from tests.torch_guidance import one_torch_thread  # noqa: F401

ACADOS_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "goldens",
                                  "acados")
FLAGSHIP, HULL = "usv_guidance_ca1", "usv_pf_ca"
# the port's CPU tick (N=100, 30 IPM iterations, float64) takes ~1.2 s of
# the flagship and ~1.8 s of the hull, most of it the plain Riccati
# sweep's stage loop: the recordings and replays run 10 ticks each
TICKS = 10
# the per-instance engine's parity with JAX's (tests/test_torch_sqp_rti.py)
CROSS_TOL = 1e-8
KEYS = ("variant", "ticks", "max_u_dev", "max_x_dev", "target", "ok")


@pytest.mark.parametrize("name", sorted(set(casadi_models.VARIANTS)))
def test_scenario_matches_jax(name):
    got = rap._scenario(name, builders.build(name))
    want = jrap._scenario(name, jbuilders.build(name))
    for what, g, w in zip(("x0", "params", "lh", "yref", "yref_e"), got,
                          want):
        assert (g is None) == (w is None), (name, what)
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{name} {what}")


def _jax_fixture(path, name, ticks):
    """`name`'s closed loop recorded by the JAX package's RTISolver
    (ipm_iters=30, ipm_tol=1e-10, float64: the recipe of
    tests/test_acados_fixtures.py) on `_scenario`'s inputs, written in the
    fixture format."""
    spec = jbuilders.build(name)
    x0, params, lh, yref, yref_e = rap._inputs(name, builders.build(name))
    solver = JaxRTI(spec, ipm_iters=30, ipm_tol=1e-10)
    st = solver.init_state(jnp.asarray(x0), dtype=jnp.float64)
    x = jnp.asarray(np.asarray(x0, float))
    opt = (lambda a: None if a is None else jnp.asarray(a))
    ua, xa = [], []
    for _ in range(ticks):
        st, out = solver.step(st, x, jnp.asarray(params), opt(lh),
                              yref=opt(yref), yref_e=opt(yref_e))
        ua.append(np.asarray(out.u0, float).reshape(-1))
        xa.append(np.asarray(out.x1, float).reshape(-1))
        x = jnp.asarray(xa[-1])
    rap.write_fixture(path, name, ticks, x0, params, lh, yref, yref_e, ua,
                      xa)
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """{(writer, name): path}: the flagship's and the hull's fixtures
    written by the JAX package ("jax"), the flagship's by the port
    ("torch")."""
    d = tmp_path_factory.mktemp("acados_fixtures")
    out = {("jax", name): _jax_fixture(d / f"jax_{name}.npz", name, TICKS)
           for name in (FLAGSHIP, HULL)}
    out[("torch", FLAGSHIP)] = rap.record_fixture(
        str(d / f"torch_{FLAGSHIP}.npz"), FLAGSHIP, TICKS, device="cpu")
    return out


def test_fixture_keys_match_jax_format(fixtures, tmp_path):
    """The port's fixtures hold the JAX package's keys, shapes and dtypes:
    the flagship's recording, and the hull's inputs (per-stage yref)
    written with one tick of controls and states."""
    x0, params, lh, yref, yref_e = rap._inputs(HULL, builders.build(HULL))
    hull = tmp_path / "hull.npz"
    with np.load(fixtures[("jax", HULL)]) as z:
        rap.write_fixture(hull, HULL, TICKS, x0, params, lh, yref, yref_e,
                          z["ua"], z["xa"])
    for name, path in ((FLAGSHIP, fixtures[("torch", FLAGSHIP)]),
                       (HULL, hull)):
        with np.load(path) as t, np.load(fixtures[("jax", name)]) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                assert t[k].shape == j[k].shape, (name, k)
                assert t[k].dtype == j[k].dtype, (name, k)
                if k not in ("ua", "xa"):
                    np.testing.assert_array_equal(t[k], j[k])
    with np.load(hull) as t:
        assert t["yref"].shape == (100, 16) and t["yref_e"].shape == (14,)


def test_fixture_roundtrip_self(fixtures):
    """The port's own flagship loop, recorded and replayed: identical
    solver, schedule and inputs reproduce it to float determinism."""
    res = rap.replay_fixture(fixtures[("torch", FLAGSHIP)], rtol=1e-3,
                             device="cpu")
    assert res["variant"] == FLAGSHIP and res["ticks"] == TICKS
    assert res["max_u_dev"] < 1e-12, res
    assert res["max_x_dev"] < 1e-12, res


@pytest.mark.parametrize("name", [FLAGSHIP, HULL])
def test_jax_fixture_replayed_by_port(fixtures, name):
    """JAX-written, port-replayed: measured 5.0e-16 (u) and 2.2e-16 (x1)
    over the flagship's 10 ticks (6.7e-16 over 25), 0 and 2.2e-16 over
    the hull's 10."""
    res = rap.replay_fixture(fixtures[("jax", name)], device="cpu")
    print(f"JAX-written {name} fixture, port replay: {res}")
    assert res["ticks"] == TICKS and res["ok"]
    assert res["max_u_dev"] <= CROSS_TOL and res["max_x_dev"] <= CROSS_TOL, \
        res


def test_port_fixture_replayed_by_jax(fixtures):
    """Port-written, JAX-replayed (the JAX package's own replay_fixture):
    measured 5.0e-16 (u) and 2.2e-16 (x1) over 10 ticks (6.7e-16 over
    25)."""
    res = jrap.replay_fixture(fixtures[("torch", FLAGSHIP)])
    print(f"port-written {FLAGSHIP} fixture, JAX replay: {res}")
    assert res["ticks"] == TICKS and res["ok"]
    assert res["max_u_dev"] <= CROSS_TOL and res["max_x_dev"] <= CROSS_TOL, \
        res


def _shifted(src, dst):
    with np.load(src) as z:
        data = {k: z[k] for k in z.files}
    data["ua"] = data["ua"] + 1e-2
    np.savez_compressed(dst, **data)
    return str(dst)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rap.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_perturbed_fixture_fails(fixtures, tmp_path):
    """A fixture whose controls are off by 1e-2 (past the 1e-3 target)
    fails: `main --replay` prints `ok` false with that deviation and exits
    1."""
    path = _shifted(fixtures[("torch", FLAGSHIP)], tmp_path / "shifted.npz")
    rc, lines = _main(["--replay", path, "--device", "cpu", "--ticks", "1"])
    res = json.loads(lines[-1])
    assert rc == 1 and res["ok"] is False, res
    assert abs(res["max_u_dev"] - 1e-2) < 1e-9, res


def test_main_replay_prints_one_json_line(fixtures):
    rc, lines = _main(["--replay", fixtures[("jax", FLAGSHIP)], "--device",
                       "cpu", "--ticks", "1"])
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert tuple(res) == KEYS and res["ticks"] == 1 and res["ok"]


def test_main_without_acados_exits_2(capsys):
    from mpc_collisionavoidance_tpu_torch.parity.acados_oracle import (
        acados_available)
    if acados_available():
        pytest.skip("acados_template and casadi are installed here")
    assert rap.main(["usv_guidance_ca1", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "acados_template/casadi not installed" in err


def test_default_device_needs_cuda(fixtures):
    """`--device` defaults to cuda, which raises on a host without one
    (RTISolver's ValueError), never a CPU run."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="no CUDA device"):
        rap.main(["--replay", fixtures[("torch", FLAGSHIP)]])
    with pytest.raises(ValueError, match="no CUDA device"):
        rap.replay_fixture(fixtures[("torch", FLAGSHIP)])


def _committed():
    return sorted(glob.glob(os.path.join(ACADOS_FIXTURE_DIR, "*.npz")))


@pytest.mark.parametrize("path", _committed() or [None])
def test_torch_acados_fixture_parity(path):
    """Every committed acados fixture must replay within the <1e-3
    control-deviation target (skips when none are committed: producing
    them needs an acados run, `run_acados_parity --emit-fixtures`)."""
    if path is None:
        pytest.skip("no acados fixtures committed (tests/goldens/acados); "
                    "see parity/run_acados_parity.py --emit-fixtures")
    res = rap.replay_fixture(path, rtol=1e-3, ticks=100, device="cpu")
    assert res["ok"], res
