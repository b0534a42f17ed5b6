"""The port's lane IPM vs the JAX package's on the same LaneQPs, float64 on
the CPU.  The QPs are built by JAX's `LaneRTISolver._build_qp` and carried
across with `interop.lane_qp_from_numpy`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import ipm_lanes as jipm
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.ops import ipm_lanes

PRODUCTION = dict(ipm_iters=4, ipm_tol=3e-6, extra_iters=24, stall_tol=3e-6,
                  mu0="auto", centering="adaptive")


def _jax_qp(spec, sc, B, seed, perturb, solver_kw, warm_ticks):
    """A LaneQP from JAX's own QP assembly, after `warm_ticks` JAX ticks."""
    m = spec.model
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, 2] += perturb * rng.standard_normal(B)
    solver = LaneRTISolver(spec, **solver_kw)
    st = solver.init_state(x0s, dtype=jnp.float64)
    x = to_lanes(jnp.asarray(x0s, jnp.float64))
    p = to_lanes(jnp.asarray(np.broadcast_to(sc.params, (B, m.np_)),
                             jnp.float64))
    lh = to_lanes(jnp.asarray(np.broadcast_to(sc.lh, (B, m.nh)),
                              jnp.float64))
    for _ in range(warm_ticks):
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
    return solver, solver._build_qp(st, x, p, lh)


def _solve_both(solver, qp, **kw):
    sol_j = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx,
                                 riccati="lax", **kw)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    sol_t = ipm_lanes.ipm_solve_lanes(qp_t, solver.idxbu, solver.idxbx, **kw)
    return sol_j, sol_t


def _assert_match(sol_j, sol_t):
    np.testing.assert_allclose(sol_t.dx.numpy(), np.asarray(sol_j.dx),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol_t.du.numpy(), np.asarray(sol_j.du),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol_t.gap.numpy(), np.asarray(sol_j.gap),
                               rtol=1e-6)
    np.testing.assert_array_equal(sol_t.status.numpy(),
                                  np.asarray(sol_j.status))
    assert sol_t.status.dtype == torch.int32


def _kw(solver_kw):
    return dict(iters=solver_kw["ipm_iters"], tol=solver_kw["ipm_tol"],
                centering=solver_kw["centering"], mu0=solver_kw["mu0"],
                extra_iters=solver_kw["extra_iters"],
                stall_tol=solver_kw["stall_tol"])


def test_flagship_soft_rows_and_control_box():
    spec = jbuilders.usv_guidance_ca1(Tf=2.0, N=25)
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca1_default(), B=5,
                         seed=0, perturb=0.2, solver_kw=PRODUCTION,
                         warm_ticks=1)
    assert qp.Cs.shape[1] == 8 and len(solver.idxbu) == 1
    _assert_match(*_solve_both(solver, qp, **_kw(PRODUCTION)))


def test_flagship_escalation_fires():
    """The escalation case of tests/test_escalation.py (ipm_iters=2,
    extra_iters=24, B=4, seed 3) at N=100: two fixed iterations leave the
    lanes above the gate, and escalation must run the same extra
    iterations in both packages."""
    kw = dict(ipm_iters=2, ipm_tol=1e-7, extra_iters=24, stall_tol=None,
              mu0=1.0, centering="fixed")
    spec = jbuilders.usv_guidance_ca1()
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca1_default(), B=4,
                         seed=3, perturb=0.1, solver_kw=kw, warm_ticks=0)
    starved = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx, iters=2,
                                   tol=1e-7, riccati="lax")
    assert np.asarray(starved.gap).max() > 1e-5      # escalation needed
    sol_j, sol_t = _solve_both(solver, qp, **_kw(kw))
    assert np.asarray(sol_j.gap).max() < 1e-7
    _assert_match(sol_j, sol_t)


def test_guidance_ca_hard_rows_and_state_box():
    spec = jbuilders.usv_guidance_ca(N=25)
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca_default(), B=5,
                         seed=1, perturb=0.2, solver_kw=PRODUCTION,
                         warm_ticks=1)
    assert qp.Ch.shape[1] == 8 and qp.Cs.shape[1] == 0
    assert len(solver.idxbx) == 1 and len(solver.idxbu) == 1
    _assert_match(*_solve_both(solver, qp, **_kw(PRODUCTION)))


def test_unported_options_raise():
    spec = jbuilders.usv_guidance_ca1(Tf=1.0, N=5)
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca1_default(), B=2,
                         seed=0, perturb=0.1, solver_kw={}, warm_ticks=0)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    with pytest.raises(ValueError, match="mehrotra"):
        ipm_lanes.ipm_solve_lanes(qp_t, (0,), (), riccati="fused",
                                  centering="mehrotra")
    with pytest.raises(NotImplementedError, match="Dh/Ds"):
        ipm_lanes.ipm_solve_lanes(qp_t._replace(Dh=qp_t.Ch), (0,), ())


# the OCPs of the gap-trace tests: (builder, scenario, N)
TRACE_OCPS = {"flagship": (jbuilders.usv_guidance_ca1,
                           jscenarios.guidance_ca1_default, 25),
              "hull": (jbuilders.usv_pf_ca, jscenarios.pf_ca_default, 20)}


@pytest.mark.parametrize("centering", ["fixed", "adaptive"])
@pytest.mark.parametrize("ocp", sorted(TRACE_OCPS))
def test_gap_trace_matches_jax(ocp, centering):
    """`return_gap_trace` on the sweep backend: (solution, gaps) with gaps
    (iters, L), the duality gap at the start of each fixed iteration, as
    JAX's lax lane IPM returns it; float64, with escalation on (whose
    iterations the trace leaves out in both)."""
    build, scenario, N = TRACE_OCPS[ocp]
    kw = dict(PRODUCTION, centering=centering, ipm_iters=6)
    solver, qp = _jax_qp(build(N=N), scenario(), B=5, seed=4, perturb=0.2,
                         solver_kw=kw, warm_ticks=1)
    sol_j, gaps_j = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx,
                                         riccati="lax", return_gap_trace=True,
                                         **_kw(kw))
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    sol_t, gaps_t = ipm_lanes.ipm_solve_lanes(
        qp_t, solver.idxbu, solver.idxbx, return_gap_trace=True, **_kw(kw))
    assert tuple(gaps_t.shape) == np.asarray(gaps_j).shape == (6, 5)
    np.testing.assert_allclose(gaps_t.numpy(), np.asarray(gaps_j),
                               rtol=1e-9, atol=1e-14)
    _assert_match(sol_j, sol_t)


def test_gap_trace_of_no_iterations_is_empty():
    """iters=0: an empty (0, L) trace, as JAX's scan of length 0."""
    spec = jbuilders.usv_guidance_ca1(Tf=1.0, N=5)
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca1_default(), B=3,
                         seed=0, perturb=0.1, solver_kw={}, warm_ticks=0)
    _, gaps_j = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx,
                                     iters=0, riccati="lax",
                                     return_gap_trace=True)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    _, gaps_t = ipm_lanes.ipm_solve_lanes(qp_t, solver.idxbu, solver.idxbx,
                                          iters=0, return_gap_trace=True)
    assert tuple(gaps_t.shape) == np.asarray(gaps_j).shape == (0, 3)


def test_fused_backend_ignores_gap_trace():
    """The fused backend returns the solution alone, flag or not, as the
    JAX package's fused branch does."""
    spec = jbuilders.usv_guidance_ca1(Tf=1.0, N=5)
    solver, qp = _jax_qp(spec, jscenarios.guidance_ca1_default(), B=3,
                         seed=0, perturb=0.1, solver_kw={}, warm_ticks=0)
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    args = (qp_t, solver.idxbu, solver.idxbx)
    with_flag = ipm_lanes.ipm_solve_lanes(*args, riccati="fused",
                                          return_gap_trace=True)
    without = ipm_lanes.ipm_solve_lanes(*args, riccati="fused")
    assert isinstance(with_flag, ipm_lanes.LaneIPMSolution)
    for g, w in zip(with_flag, without):
        assert torch.equal(g, w)
