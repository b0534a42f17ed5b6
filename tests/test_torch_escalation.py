"""Stall escalation in the port (`ops/ipm_lanes.py`: `extra_iters` guarded
steps) against the JAX package's `lax.while_loop`, on the CPU: the same
number of escalation iterations and the same results, float64 (the IPM at
1e-10, ticks at 5e-6, identical status), and the race car's float32
escalation counts per warm tick.

JAX's count is read without editing the JAX package: `jax.lax.while_loop`
is replaced, for the test, by a wrapper that calls it and hands the
loop's final counter (the escalation loop carries `(k, carry)`) to a
`jax.debug.callback`, which runs eagerly and under jit alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import ipm_lanes as jipm
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu.utils import track as jtrack
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import ipm_lanes
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
from mpc_collisionavoidance_tpu_torch.utils import track as trk

JTRACK = jtrack.make_synthetic_track()
_PE = jconfig.production_engine("cpu")
PRODUCTION = dict(ipm_iters=_PE.ipm_iters, ipm_tol=_PE.ipm_tol,
                  centering=_PE.centering, mu0=_PE.mu0,
                  extra_iters=_PE.extra_iters, stall_tol=_PE.stall_tol)
# tests/test_escalation.py:36-48: two fixed iterations leave the flagship's
# first tick far above the gate
STARVED = dict(ipm_iters=2, ipm_tol=1e-7, centering="fixed", mu0=1.0,
               extra_iters=24, stall_tol=None)

# name -> (OCP, builder keywords, schedule, B, seed): the starved flagship
# at the builder's N=100, the hull, usv_guidance_ca (its hard rows escalate
# every warm tick) and the race car on the synthetic curved track
CASES = {
    "flagship_starved": ("usv_guidance_ca1", {}, STARVED, 4, 3),
    "hull": ("usv_pf_ca", dict(N=20), PRODUCTION, 4, 5),
    "guidance_ca": ("usv_guidance_ca", dict(N=25), PRODUCTION, 4, 1),
    "race_cars_curved": ("race_cars", dict(N=10, Tf=0.4, curved=True),
                         PRODUCTION, 4, 7),
}


@pytest.fixture
def jax_escalations(monkeypatch):
    """The escalation iterations of every JAX lane IPM solved while the
    fixture is active, in order."""
    counts = []
    real = jax.lax.while_loop

    def counting(cond, body, init):
        k, carry = real(cond, body, init)
        jax.debug.callback(lambda n: counts.append(int(n)), k, ordered=True)
        return k, carry

    monkeypatch.setattr(jax.lax, "while_loop", counting)
    return counts


def _specs(name, kw):
    kw = dict(kw)
    curved = kw.pop("curved", False)
    jkw = dict(kw, track=JTRACK) if curved else kw
    tkw = dict(kw, track=trk.make_synthetic_track()) if curved else kw
    return jbuilders.build(name, **jkw), builders.build(name, **tkw)


def _inputs(name, B, seed, dtype=np.float64):
    """x0 (B, nx) of the OCP's default scenario, its perturbed coordinate
    moved by 0.1 N(0, 1); params (B, np); lh (B, nh)."""
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    rng = np.random.default_rng(seed)
    x0s = np.array(np.broadcast_to(sc.x0, (B, len(sc.x0))), dtype)
    x0s[:, coord] += 0.1 * rng.standard_normal(B)
    params = np.array(np.broadcast_to(sc.params, (B, len(sc.params))), dtype)
    lh = np.array(np.broadcast_to(sc.lh, (B, len(sc.lh))), dtype)
    return x0s, params, lh


def _solvers(case):
    name, kw, schedule, B, seed = CASES[case]
    jspec, tspec = _specs(name, kw)
    js = JaxLane(jspec, **schedule)
    ts = SolverConfig(**schedule).build(tspec, device="cpu",
                                        dtype=torch.float64)
    return js, ts, _inputs(name, B, seed)


def _ipm_kw(schedule):
    return dict(iters=schedule["ipm_iters"], tol=schedule["ipm_tol"],
                centering=schedule["centering"], mu0=schedule["mu0"],
                extra_iters=schedule["extra_iters"],
                stall_tol=schedule["stall_tol"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_ipm_escalation_matches_jax_while_loop(case, jax_escalations):
    """One lane IPM on JAX's QP after one warm JAX tick: the port's guarded
    steps run as many iterations as JAX's while_loop, with dx, du, gap at
    1e-10 and identical status."""
    js, ts, (x0s, params, lh) = _solvers(case)
    jst = js.init_state(x0s, dtype=jnp.float64)
    jx, jp, jl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    jst, out = js.step_fn(jst, jx, jp, jl)
    qp = js._build_qp(jst, out.x1, jp, jl)
    jax_escalations.clear()
    kw = _ipm_kw(CASES[case][2])
    sol_j = jipm.ipm_solve_lanes(qp, js.idxbu, js.idxbx, riccati="lax",
                                 **kw)
    np.asarray(sol_j.gap)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    esc = ipm_lanes.Escalation("cpu")
    sol_t = ipm_lanes.ipm_solve_lanes(qp_t, js.idxbu, js.idxbx,
                                      escalation=esc, **kw)
    assert len(jax_escalations) == 1
    assert int(esc.iters) == jax_escalations[0] > 0
    for field in ("dx", "du"):
        np.testing.assert_allclose(getattr(sol_t, field).numpy(),
                                   np.asarray(getattr(sol_j, field)),
                                   rtol=0, atol=1e-10, err_msg=field)
    np.testing.assert_allclose(sol_t.gap.numpy(), np.asarray(sol_j.gap),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(sol_t.status.numpy(),
                                  np.asarray(sol_j.status))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tick_escalation_matches_jax_while_loop(case, jax_escalations):
    """Three warm-started ticks (x0 <- x1), each from JAX's warm start
    carried across as numpy: the port's tick (`last_esc_iters`) escalates
    as often as JAX's, u0/x1 at 5e-6, identical status."""
    js, ts, (x0s, params, lh) = _solvers(case)
    jst = js.init_state(x0s, dtype=jnp.float64)
    tst = ts.init_state(x0s)
    jx, jp, jl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    tx, tp, tl = (to_lanes(torch.as_tensor(a)) for a in (x0s, params, lh))
    counts = []
    for tick in range(3):
        jst, out_j = js.step_fn(jst, jx, jp, jl)
        tst, out_t = ts.step_fn(tst, tx, tp, tl)
        counts.append(int(ts.last_esc_iters))
        np.asarray(out_j.x1)
        assert counts == jax_escalations, tick
        for field in ("u0", "x1"):
            np.testing.assert_allclose(getattr(out_t, field).numpy(),
                                       np.asarray(getattr(out_j, field)),
                                       rtol=0, atol=5e-6, err_msg=field)
        np.testing.assert_array_equal(out_t.status.numpy(),
                                      np.asarray(out_j.status))
        jx = out_j.x1
        tx = torch.as_tensor(np.array(out_j.x1))
        tst = interop.lane_state_from_numpy(
            np.asarray(jst.xbar), np.asarray(jst.ubar), device="cpu",
            dtype=torch.float64)
    assert sum(counts) > 0


class _EveryStep(ipm_lanes.Escalation):
    """Tests the predicate before every one of the n steps, as the
    captured tick's conditional nodes do, and runs a step only where it
    holds; records each predicate and the carry after each step slot."""

    def __init__(self, snapshot):
        super().__init__("cpu")
        self.preds, self.carries, self._snapshot = [], [], snapshot

    def loop(self, n, stalled, step):
        for _ in range(n):
            pred = bool(stalled())
            self.preds.append(pred)
            if pred:
                step()
                self.iters += 1
            self.carries.append(self._snapshot())


def test_false_predicate_leaves_the_carry_unchanged(monkeypatch):
    """The starved flagship stops escalating well before its 24 steps.
    Testing the predicate at every step slot, as the captured tick does:
    once it is false it stays false, the carry after every later slot is
    bitwise the carry at the stop, and the result equals the plain guard's
    (which stops at the first false predicate)."""
    js, ts, (x0s, params, lh) = _solvers("flagship_starved")
    jx, jp, jl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    qp = js._build_qp(js.init_state(x0s, dtype=jnp.float64), jx, jp, jl)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    kw = _ipm_kw(STARVED)
    plain = ipm_lanes.Escalation("cpu")
    want = ipm_lanes.ipm_solve_lanes(qp_t, js.idxbu, js.idxbx,
                                     escalation=plain, **kw)

    # the carry's leaves, seen through the step closure's copy targets
    leaves = []
    real_leaves = ipm_lanes._leaves

    def recording(carry):
        out = real_leaves(carry)
        if not leaves:
            leaves.extend(out)
        return out

    monkeypatch.setattr(ipm_lanes, "_leaves", recording)
    every = _EveryStep(lambda: [t.clone() for t in leaves])
    got = ipm_lanes.ipm_solve_lanes(qp_t, js.idxbu, js.idxbx,
                                    escalation=every, **kw)
    k = int(plain.iters)
    assert 0 < k < STARVED["extra_iters"]
    assert every.preds == [True] * k + [False] * (len(every.preds) - k)
    assert int(every.iters) == k
    for later in every.carries[k:]:
        for a, b in zip(later, every.carries[k - 1]):
            assert torch.equal(a, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_race_car_float32_escalation_counts_match_jax(jax_escalations):
    """The race car's float32 closed loop on the synthetic curved track at
    the production schedule (the inputs of tests/test_torch_race_cars.py::
    test_jax_race_loop_at_full_width at B=32, its builder's N=50, 10
    ticks): JAX's lane engine escalates on every warm tick, and the port's
    tick, started each tick from JAX's state in float32, runs the same
    number of escalation iterations."""
    B = 32
    sc = scenarios.DEFAULTS["race_cars"][0]()
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, 6)).copy()
    x0s[:, 1] += 0.1 * rng.standard_normal(B)
    x0s = x0s.astype(np.float32)
    lh = np.broadcast_to(sc.lh, (B, 5)).astype(np.float32)
    ts = SolverConfig(**PRODUCTION).build(
        builders.build("race_cars", track=trk.make_synthetic_track()),
        device="cpu", dtype=torch.float32)
    tp = torch.zeros((0, B), dtype=torch.float32)
    tl = to_lanes(torch.as_tensor(lh))
    port = []
    with jax.enable_x64(False):
        js = JaxLane(jbuilders.build("race_cars", track=JTRACK), **PRODUCTION)
        st = js.init_state(x0s, dtype=jnp.float32)
        x = jax_lanes(jnp.asarray(x0s))
        p = jnp.zeros((0, B), jnp.float32)
        jl = jax_lanes(jnp.asarray(lh))
        step = jax.jit(lambda st, x: js.step_fn(st, x, p, jl))
        for _ in range(10):
            tst = interop.lane_state_from_numpy(
                np.asarray(st.xbar), np.asarray(st.ubar), device="cpu",
                dtype=torch.float32)
            tx = torch.as_tensor(np.array(x))
            ts.step_fn(tst, tx, tp, tl)
            port.append(int(ts.last_esc_iters))
            st, out = step(st, x)
            x = out.x1
        np.asarray(x)
    assert port == jax_escalations
    assert all(k > 0 for k in jax_escalations[1:])


def test_settle_counts_released_programs_steps():
    """`capture.settle_launch_counts` adds the escalation steps of a
    program released since the last settle: its `_Steps` (the device step
    count, one step's launches, the steps already counted) outlive it."""
    from mpc_collisionavoidance_tpu_torch.kernels import riccati
    from mpc_collisionavoidance_tpu_torch.solver import capture
    steps = capture._Steps(torch.tensor(3), (1, 0, 0))
    before = riccati.launches
    steps.settle()                       # settled while the program lived
    steps.total += 2                     # two more steps, then released
    capture._RELEASED.append(steps)
    capture.settle_launch_counts()
    assert riccati.launches - before == 5 and not capture._RELEASED
    capture.settle_launch_counts()
    assert riccati.launches - before == 5
