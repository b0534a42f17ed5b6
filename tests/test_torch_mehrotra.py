"""Mehrotra predictor-corrector centering in the port's lane IPM vs the JAX
package's, float64 on the CPU, on LaneQPs from JAX's `_build_qp` at each
OCP's default scenario (carried across with `interop.lane_qp_from_numpy`);
then JAX's own Mehrotra checks (tests/test_adaptive_centering.py) on the
port."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import ipm_lanes as jipm
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import ipm_lanes
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)

N = 20
# (JAX builder, scenario, lane batch, index of ye in x): the flagship at
# Tf = 5 N/100 and the hull at Tf = N/100 keep the reference's stage length
OCPS = {
    "flagship": (lambda: jbuilders.usv_guidance_ca1(Tf=1.0, N=N),
                 jscenarios.guidance_ca1_default, 8, 2),
    "hull": (lambda: jbuilders.usv_pf_ca(Tf=0.2, N=N),
             jscenarios.pf_ca_default, 4, 6),
}
# a fixed 12 iterations; 2 then escalation (mu0 "auto", as the production
# schedule), where 2 leave lanes above the gate
SCHEDULES = {"fixed12": dict(iters=12),
             "escalation": dict(iters=2, extra_iters=24, mu0="auto")}


@functools.cache
def _jax_qp(name):
    """JAX's lane QP of the OCP (built once per process: JAX's eager
    assembly takes seconds) and its port-side copy; read-only."""
    build, scenario, B, ye = OCPS[name]
    spec, sc = build(), scenario()
    m = spec.model
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, ye] += 0.2 * rng.standard_normal(B)
    solver = JaxLane(spec)
    st = solver.init_state(x0s, dtype=jnp.float64)
    lanes = [jax_lanes(jnp.asarray(np.broadcast_to(a, (B, len(a))),
                                   jnp.float64))
             for a in (sc.params, sc.lh)]
    qp = solver._build_qp(st, jax_lanes(jnp.asarray(x0s, jnp.float64)),
                          *lanes)
    qp_t = interop.lane_qp_from_numpy(
        {k: np.asarray(v) for k, v in qp._asdict().items()}, device="cpu",
        dtype=torch.float64)
    return solver, qp, qp_t


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OCPS))
def test_mehrotra_matches_jax(name, schedule):
    kw = SCHEDULES[schedule]
    solver, qp, qp_t = _jax_qp(name)
    args = (solver.idxbu, solver.idxbx)
    if schedule == "escalation":
        starved = ipm_lanes.ipm_solve_lanes(qp_t, *args,
                                            centering="mehrotra", iters=2,
                                            mu0="auto")
        assert float(starved.gap.max()) > 1e-7        # escalation runs
    sol_j = jipm.ipm_solve_lanes(qp, *args, riccati="lax",
                                 centering="mehrotra", **kw)
    sol_t = ipm_lanes.ipm_solve_lanes(qp_t, *args, centering="mehrotra",
                                      **kw)
    np.testing.assert_allclose(sol_t.dx.numpy(), np.asarray(sol_j.dx),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol_t.du.numpy(), np.asarray(sol_j.du),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol_t.gap.numpy(), np.asarray(sol_j.gap),
                               rtol=1e-9, atol=0)
    np.testing.assert_array_equal(sol_t.status.numpy(),
                                  np.asarray(sol_j.status))


def _port_qp(B=4, N=16, dtype=torch.float64):
    """The flagship QP of tests/test_adaptive_centering.py::_flagship_qp,
    from the port's own assembly."""
    spec = builders.usv_guidance_ca1(Tf=5.0 * N / 100, N=N)
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(3)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(B)
    solver = LaneRTISolver(spec, ipm_iters=30, device="cpu", dtype=dtype)
    lanes = [to_lanes(torch.as_tensor(a, dtype=dtype)) for a in (
        x0s, np.broadcast_to(sc.params, (B, 16)).copy(),
        np.broadcast_to(sc.lh, (B, 8)).copy())]
    return solver, solver._build_qp(solver.init_state(x0s), *lanes)


def test_mehrotra_same_fixed_point():
    """The predictor-corrector follows the same central path to the same
    solution as the fixed schedule (tests/test_adaptive_centering.py::
    test_mehrotra_same_fixed_point)."""
    solver, qp = _port_qp()
    args = (qp, solver.idxbu, solver.idxbx)
    sol_f = ipm_lanes.ipm_solve_lanes(*args, iters=60, tol=1e-10,
                                      centering="fixed")
    sol_m = ipm_lanes.ipm_solve_lanes(*args, iters=60, tol=1e-10,
                                      centering="mehrotra")
    assert (sol_m.status == 0).all() and (sol_f.status == 0).all()
    np.testing.assert_allclose(sol_m.du.numpy(), sol_f.du.numpy(), atol=1e-7)
    np.testing.assert_allclose(sol_m.dx.numpy(), sol_f.dx.numpy(), atol=1e-7)


def test_mehrotra_converges_faster_per_iteration():
    solver, qp = _port_qp()
    args = (qp, solver.idxbu, solver.idxbx)
    g_f = ipm_lanes.ipm_solve_lanes(*args, iters=12, centering="fixed").gap
    g_m = ipm_lanes.ipm_solve_lanes(*args, iters=12,
                                    centering="mehrotra").gap
    assert (g_m < torch.clamp_min(g_f, 1e-12)).all(), (g_f, g_m)


def test_mehrotra_runs_two_sweeps_per_iteration(monkeypatch):
    """The affine probe and the corrector are one Riccati sweep each (on
    CUDA tensors: two K1 launches per iteration), escalation included."""
    calls = []
    sweep = ipm_lanes.lqr_solve_lanes

    def counted(d):
        calls.append(1)
        return sweep(d)

    monkeypatch.setattr(ipm_lanes, "lqr_solve_lanes", counted)
    solver, qp = _port_qp()
    args = (qp, solver.idxbu, solver.idxbx)
    for centering, per_iter in (("fixed", 1), ("mehrotra", 2)):
        calls.clear()
        ipm_lanes.ipm_solve_lanes(*args, iters=12, centering=centering)
        assert len(calls) == 12 * per_iter, centering
    calls.clear()
    sol = ipm_lanes.ipm_solve_lanes(*args, iters=1, extra_iters=24,
                                    centering="mehrotra")
    assert len(calls) % 2 == 0 and 2 < len(calls) <= 50, len(calls)
    assert (sol.status == 0).all()


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_mehrotra_nan_lane(schedule):
    """One NaN lane in dx0: that lane ends at status 2 (the aff_ok fallback
    keeps its NaNs to itself) and every other lane is untouched."""
    kw = SCHEDULES[schedule]
    solver, qp = _port_qp(B=6)
    args = (solver.idxbu, solver.idxbx)
    clean = ipm_lanes.ipm_solve_lanes(qp, *args, centering="mehrotra", **kw)
    dx0 = qp.dx0.clone()
    dx0[0, 3] = float("nan")
    bad = ipm_lanes.ipm_solve_lanes(qp._replace(dx0=dx0), *args,
                                    centering="mehrotra", **kw)
    assert int(bad.status[3]) == 2
    others = [i for i in range(6) if i != 3]
    assert torch.equal(bad.status[others], clean.status[others])
    assert torch.equal(bad.du[..., others], clean.du[..., others])
    assert torch.equal(bad.dx[..., others], clean.dx[..., others])


def test_fused_backend_rejects_mehrotra():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    with pytest.raises(ValueError, match="fused"):
        LaneRTISolver(spec, centering="mehrotra", riccati="fused",
                      device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="fused"):
        SolverConfig(centering="mehrotra", riccati="fused")
    solver = SolverConfig(centering="mehrotra").build(spec, device="cpu",
                                                      dtype=torch.float64)
    assert solver.centering == "mehrotra"
