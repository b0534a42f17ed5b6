"""The port's experiment config (`config.py::FrameworkConfig`), profiling,
checkpointing and Frenet transforms against the JAX package's, on the
CPU: JAX under the suite's x64 conftest, the port on `device="cpu"`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.utils import frenet as jfrenet
from mpc_collisionavoidance_tpu.utils.profiling import SolveTimer as JTimer
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (
    FrameworkConfig, SolverConfig, production_engine)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           LaneSolverAdapter)
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from mpc_collisionavoidance_tpu_torch.utils import frenet
from mpc_collisionavoidance_tpu_torch.utils.checkpointing import (
    restore_state, save_state)
from mpc_collisionavoidance_tpu_torch.utils.profiling import (
    SolveTimer, device_memory_stats, trace)
from tests.torch_guidance import one_torch_thread  # noqa: F401

F64 = torch.float64


# ---------------------------------------------------------------------------
# config

def test_config_roundtrip_and_build():
    cfg = FrameworkConfig(model="usv_guidance_ca1", N=20, Tf=1.0,
                          solver=SolverConfig(engine="lane", ipm_iters=6))
    d = json.loads(json.dumps(cfg.to_dict()))
    assert "linearize" not in d["solver"] and "dtype" not in d["solver"]
    assert "parallel" not in d
    assert d["solver"]["riccati"] == "sweep"
    cfg2 = FrameworkConfig.from_dict(d)
    assert cfg2 == cfg
    spec = cfg2.build_spec()
    assert spec.N == 20 and spec.model.name == "usv_guidance_ca1"
    solver = cfg2.build_solver(device="cpu", dtype=torch.float32)
    assert isinstance(solver, LaneRTISolver)
    assert solver.dtype == torch.float32 and solver.device.type == "cpu"


# JAX FrameworkConfigs whose to_dict() the port must load: each engine,
# every riccati name, linearize, dtype, the production preset on both
# platforms and Mehrotra with mu0="auto"
JAX_SOLVERS = {
    "lane": lambda: jconfig.SolverConfig(),
    "instance": lambda: jconfig.SolverConfig(engine="instance", ipm_iters=6),
    "instance_dense": lambda: jconfig.SolverConfig(engine="instance",
                                                   qp_backend="dense"),
    **{f"riccati_{r}": (lambda r=r: jconfig.SolverConfig(riccati=r))
       for r in ("lax", "pallas", "pallas_interpret", "pscan", "fused",
                 "fused_interpret")},
    "linearize_pallas": lambda: jconfig.SolverConfig(linearize="pallas"),
    "linearize_pallas_interpret": lambda: jconfig.SolverConfig(
        riccati="pallas", linearize="pallas_interpret"),
    "dtype_float64": lambda: jconfig.SolverConfig(engine="instance",
                                                  dtype="float64"),
    "production_cpu": lambda: jconfig.production_engine("cpu"),
    "production_tpu": lambda: jconfig.production_engine("tpu"),
    "mehrotra_auto_lane": lambda: jconfig.SolverConfig(
        centering="mehrotra", mu0="auto"),
    "mehrotra_auto_instance": lambda: jconfig.SolverConfig(
        engine="instance", centering="mehrotra", mu0="auto"),
}
RICCATI = {"lax": "sweep", "pallas": "sweep", "pallas_interpret": "sweep",
           "pscan": "pscan", "fused": "fused", "fused_interpret": "fused"}


def _schedule(s):
    return (s.ipm_iters, s.ipm_tol, s.centering, s.mu0,
            getattr(s, "extra_iters", 0), getattr(s, "stall_tol", None))


@pytest.mark.parametrize("name", sorted(JAX_SOLVERS))
def test_loads_jax_config_dict(name):
    """JAX's `FrameworkConfig.to_dict()`, through JSON, loads into the port
    and builds an engine of the same kind and IPM schedule as JAX's own
    `build_solver()`; the riccati name maps onto the port's backend."""
    jcfg = jconfig.FrameworkConfig(model="usv_guidance_ca1", N=10, Tf=0.5,
                                   solver=JAX_SOLVERS[name]())
    cfg = FrameworkConfig.from_dict(json.loads(json.dumps(jcfg.to_dict())))
    assert (cfg.model, cfg.N, cfg.Tf) == ("usv_guidance_ca1", 10, 0.5)
    want = jcfg.build_solver()
    got = cfg.build_solver(device="cpu", dtype=F64)
    assert type(got).__name__ == type(want).__name__
    assert _schedule(got) == _schedule(want)
    if jcfg.solver.engine == "lane":
        assert got.riccati == RICCATI[jcfg.solver.riccati]
    else:
        assert got.qp_backend == jcfg.solver.qp_backend


@pytest.mark.parametrize("solver, match", [
    ({"engine": "gpu"}, "unknown engine"),
    ({"riccati": "cusparse"}, "unknown riccati backend"),
    ({"linearize": "triton"}, "unknown linearize backend"),
    ({"engine": "instance", "riccati": "pallas"},
     "pallas riccati requires the lane engine"),
    ({"engine": "instance", "linearize": "pallas"},
     "pallas linearize requires the lane engine"),
    ({"mu0": "bogus"}, "mu0"),
    ({"centering": "mehrotra", "riccati": "fused"}, "fused"),
    ({"centering": "bogus"}, "unknown centering"),
    ({"qp_backend": "qpoases"}, "unknown qp_backend"),
    ({"engine": "instance", "riccati": "pscan"},
     "riccati requires the lane engine"),
    ({"engine": "instance", "riccati": "fused_interpret"},
     "riccati requires the lane engine"),
])
def test_rejects_what_jax_rejects(solver, match):
    """A solver dict that JAX's `from_dict` refuses, the port refuses with
    JAX's message."""
    d = {"model": "usv_guidance_ca1", "solver": solver}
    with pytest.raises(ValueError, match=match):
        jconfig.FrameworkConfig.from_dict(d)
    with pytest.raises(ValueError, match=match):
        FrameworkConfig.from_dict(d)


def test_jax_parallel_dict_is_checked_and_dropped():
    """JAX's `parallel` part (ParallelConfig) loads and is dropped, as the
    port's mesh always spans every rank on one "dp" axis (`parallel/`);
    a key JAX's ParallelConfig does not take is refused by both."""
    jd = jconfig.FrameworkConfig(
        parallel=jconfig.ParallelConfig(n_devices=4, batch_per_device=256)
    ).to_dict()
    assert FrameworkConfig.from_dict(jd) == FrameworkConfig()
    bad = {"parallel": {"n_devices": 4, "mesh": "2x2"}}
    with pytest.raises(TypeError, match="mesh"):
        jconfig.FrameworkConfig.from_dict(bad)
    with pytest.raises(ValueError, match="mesh"):
        FrameworkConfig.from_dict(bad)


def test_config_validation():
    with pytest.raises(ValueError, match="unknown model"):
        FrameworkConfig(model="usv_nonexistent")
    with pytest.raises(ValueError, match="bad horizon"):
        FrameworkConfig(N=0)
    with pytest.raises(ValueError, match="unknown dtype"):
        FrameworkConfig.from_dict({"solver": {"dtype": "float16"}})
    assert FrameworkConfig.from_dict(
        {"model": "race_cars_dev", "N": 10, "Tf": 0.4}).model == \
        "race_cars_dev"


def test_production_engine_matches_jax():
    """The CLI's default engine is JAX's production preset, backend
    names mapped."""
    jd = jconfig.FrameworkConfig(
        solver=jconfig.production_engine("tpu")).to_dict()
    assert FrameworkConfig.from_dict(jd).solver == production_engine()


# ---------------------------------------------------------------------------
# profiling

def test_solve_timer_summary_matches_jax_keys():
    t, jt = SolveTimer(batch=10), JTimer(batch=10)
    for _ in range(5):
        with t.tick(), jt.tick():
            pass
    s = t.summary()
    assert sorted(s) == sorted(jt.summary())
    assert s["ticks"] == 5 and s["batch"] == 10
    assert s["solves_per_s"] > 0
    assert s["max_ms"] >= s["avg_ms"] >= 0


def test_trace_writes_chrome_trace_and_cpu_has_no_memory_stats(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert data["traceEvents"]
    assert device_memory_stats("cpu") is None
    assert device_memory_stats(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# Frenet

def test_frenet_roundtrip_matches_jax():
    x1, y1, ak = 2.0, -1.0, 0.7
    s, ye = 3.3, -0.8
    x, y = frenet.seg_to_xy(x1, y1, ak, s, ye)
    jx, jy = jfrenet.seg_to_xy(x1, y1, ak, s, ye)
    np.testing.assert_allclose([float(x), float(y)], [float(jx), float(jy)],
                               rtol=0, atol=1e-12)
    s2, ye2 = frenet.xy_to_seg(x1, y1, ak, x, y)
    np.testing.assert_allclose([float(s2), float(ye2)], [s, ye], atol=1e-12)


def test_polyline_project():
    """tests/test_utils_config.py::test_polyline_project on the port."""
    wp = torch.zeros((6, 2), dtype=F64)
    wp[:4] = torch.tensor([[0, 0], [10, 0], [10, 10], [0, 10]])
    k, s, ye = frenet.polyline_project(wp, 4, 5.0, 0.5)
    assert int(k) == 0
    np.testing.assert_allclose(float(s), 5.0, atol=1e-6)
    np.testing.assert_allclose(float(ye), 0.5, atol=1e-6)
    k, s, ye = frenet.polyline_project(wp, 4, 10.4, 3.0)
    assert int(k) == 1
    np.testing.assert_allclose(float(s), 13.0, atol=1e-6)
    np.testing.assert_allclose(float(ye), -0.4, atol=1e-6)
    k, s, ye = frenet.polyline_project(wp, 4, -1.0, 11.0)   # not padding
    assert int(k) == 2


def _vmapped(table, n, pts):
    want = jax.vmap(lambda x, y: jfrenet.polyline_project(
        jnp.asarray(table), n, x, y))(pts[:, 0], pts[:, 1])
    got = torch.vmap(lambda x, y: frenet.polyline_project(
        torch.as_tensor(table), n, x, y))(
        torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1]))
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_polyline_project_matches_jax_under_vmap():
    """Random points on a random padded polyline under torch.vmap and
    jax.vmap, and one at a time: k identical, s and ye at 1e-12.  Points
    whose two nearest segments lie within 1e-9 of each other are left
    out: their k turns on the last bit of each package's cos/sin."""
    rng = np.random.default_rng(3)
    wp = np.zeros((8, 2))
    wp[:6] = np.cumsum(rng.uniform(-5, 5, (6, 2)), axis=0)
    p1, seg = wp[:5], wp[1:6] - wp[:5]
    L = np.hypot(seg[:, 0], seg[:, 1])
    # points beside the legs (random leg, arc and offset up to 2 m either
    # side) and anywhere around them
    i = rng.integers(0, 5, 192)
    unit = seg[i] / L[i, None]
    pts = np.concatenate([
        p1[i] + rng.uniform(0, 1, (192, 1)) * seg[i]
        + rng.uniform(-2, 2, (192, 1)) * unit[:, ::-1] * [-1, 1],
        rng.uniform(-15, 15, (64, 2))])
    got, want = _vmapped(wp, 6, pts)
    # the two smallest masked distances of each point, from numpy
    s = np.clip(((pts[:, None] - p1) * seg).sum(-1) / L, 0, L)
    foot = p1 + s[..., None] * seg / L[:, None]
    d = np.sort(np.hypot(*(pts[:, None] - foot).transpose(2, 0, 1)), -1)
    clear = d[:, 1] - d[:, 0] > 1e-9
    assert clear.sum() > 150
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[clear], w[clear], rtol=0, atol=1e-12)
    for i in np.flatnonzero(clear)[:8]:
        one = frenet.polyline_project(torch.as_tensor(wp), 6,
                                      float(pts[i, 0]), float(pts[i, 1]))
        assert int(one[0]) == int(want[0][i])
        np.testing.assert_allclose([float(one[1]), float(one[2])],
                                   [want[1][i], want[2][i]], atol=1e-12)


def test_polyline_project_tie_takes_the_first_segment():
    """A point exactly equidistant from two segments (collinear legs, both
    at heading 0, the point above their shared vertex) takes the first,
    as jnp.argmin does, batched or not."""
    wp = np.array([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0], [0.0, 0.0]])
    pts = np.array([[10.0, 3.0], [10.0, -2.0], [4.0, 1.0]])
    got, want = _vmapped(wp, 3, pts)
    np.testing.assert_array_equal(want[0], [0, 0, 0])
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert int(frenet.polyline_project(torch.as_tensor(wp), 3, 10.0,
                                       3.0)[0]) == 0


# ---------------------------------------------------------------------------
# checkpointing

def _lane_adapter(N=10):
    pe = production_engine()
    return LaneSolverAdapter(pe.build(builders.usv_guidance_ca1(Tf=0.5, N=N),
                                      device="cpu", dtype=torch.float32))


def test_checkpoint_roundtrip_states(tmp_path):
    """SolverState, LaneState and a guidance carry come back with their
    types, values, dtypes and devices."""
    from mpc_collisionavoidance_tpu_torch.guidance import (
        GuidanceController, Measurements)
    rng = np.random.default_rng(0)
    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=10),
                       device="cpu", dtype=F64)
    st = solver.init_state(np.arange(8.0))
    st = st._replace(ubar=st.ubar + 0.25)
    lane = interop.lane_state_from_numpy(
        rng.standard_normal((8, 11, 3)), rng.standard_normal((1, 10, 3)),
        device="cpu", dtype=torch.float32)
    ctrl = GuidanceController(builders.usv_guidance_ca1(Tf=1.0, N=10),
                              solver=_lane_adapter())
    carry = ctrl.init_state(Measurements(0.7, 0.0, 4.0, -5.0, 1.5),
                            np.array([[4.0, -5.0], [4.0, 25.0]]), 2)
    for i, tree in enumerate((st, lane, carry)):
        path = save_state(str(tmp_path / f"ckpt{i}"), tree)
        back = restore_state(path, tree)
        assert type(back) is type(tree)
        flat = [(a, b) for a, b in zip(_flat(back), _flat(tree))]
        assert len(flat) == len(_flat(tree)) > 0
        for a, b in flat:
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
    assert type(carry.mission).__name__ == "MissionState"
    assert restore_state(str(tmp_path / "ckpt2"), carry).mission.k.dtype \
        == torch.int32


def _flat(tree):
    if isinstance(tree, tuple):
        return [leaf for c in tree for leaf in _flat(c)]
    return [tree]


def test_checkpoint_rejects_wrong_template(tmp_path):
    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=10),
                       device="cpu", dtype=F64)
    st = solver.init_state(np.zeros(8))
    path = save_state(str(tmp_path / "ckpt"), st)
    with pytest.raises(ValueError, match="leaves but the template has"):
        restore_state(path, (st, st))
    other = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=12),
                      device="cpu", dtype=F64).init_state(np.zeros(8))
    with pytest.raises(ValueError, match="has shape"):
        restore_state(path, other)


def test_resumed_closed_loop_is_bitwise_equal(tmp_path):
    """The flagship on the production lane engine (float32): 15 ticks in
    one go, and 10 ticks, (state, x) saved, restored into a fresh solver
    and 5 more ticks: every output bitwise equal."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()

    def ticks(solver, state, x, n):
        outs = []
        for _ in range(n):
            state, out = solver.step_fn(state, x, sc.params, sc.lh)
            x = out.x1
            outs.append(out)
        return state, x, outs

    a = _lane_adapter()
    x = torch.as_tensor(sc.x0, dtype=torch.float32)
    _, _, straight = ticks(a, a.init_state(x), x, 15)
    st, x10, first = ticks(a, a.init_state(x), x, 10)
    path = save_state(str(tmp_path / "tick10"), (st, x10))
    b = _lane_adapter()
    st_b, x_b = restore_state(path, (b.init_state(x), x))
    _, _, rest = ticks(b, st_b, x_b, 5)
    for got, want in zip(first + rest, straight):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
