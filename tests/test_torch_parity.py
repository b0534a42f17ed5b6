"""The port's parity oracles (`parity/kkt.py`, `parity/nlp_oracle.py`)
against the JAX package's, and the port's converged `RTISolver` against
the port's oracle (the criterion of tests/test_parity.py:19-55), float64
on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.parity import kkt_report as jkkt_report
from mpc_collisionavoidance_tpu.parity import (
    solve_ocp_nlp_dense as jsolve_dense)
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JaxRTI
from mpc_collisionavoidance_tpu.solver.sqp_rti import (
    SolverState as JaxState)
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.parity import (kkt_report,
                                                     solve_ocp_nlp_dense)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from tests.torch_guidance import one_torch_thread  # noqa: F401

F64 = torch.float64
SC = scenarios.guidance_ca1_default()


@pytest.fixture(scope="module")
def converged():
    """The port's converged SQP on the flagship at Tf=1, N=10 (the obstacle
    at (4, 4) cuts the path): 12 SQP iterations, by which the step is at
    machine precision (the JAX suite runs 50)."""
    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=10),
                       ipm_iters=30, device="cpu", dtype=F64)
    st = solver.init_state(SC.x0)
    st, out = solver.solve_converged(st, SC.x0, SC.params, SC.lh,
                                     sqp_iters=12)
    return solver, st, out


def test_oracle_matches_jax(converged):
    """The port's SLSQP oracle and JAX's, warm started from the same
    trajectory: xtraj, utraj, slacks and objective within 1e-5."""
    _, _, out = converged
    x_init, u_init = out.xtraj.numpy(), out.utraj.numpy()
    got = solve_ocp_nlp_dense(builders.usv_guidance_ca1(Tf=1.0, N=10),
                              SC.x0, SC.params, SC.lh, x_init=x_init,
                              u_init=u_init, device="cpu")
    want = jsolve_dense(jbuilders.usv_guidance_ca1(Tf=1.0, N=10), SC.x0,
                        SC.params, SC.lh, x_init=x_init, u_init=u_init)
    assert got.success and want.success, (got.message, want.message)
    for f in ("xtraj", "utraj", "sl", "su"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-5, err_msg=f)
    assert abs(got.objective - want.objective) < 1e-5


def test_converged_rti_matches_oracle(converged):
    """The port's converged SQP against the port's oracle: controls and
    states within 1e-3 (BASELINE.md's parity criterion)."""
    _, _, out = converged
    oracle = solve_ocp_nlp_dense(builders.usv_guidance_ca1(Tf=1.0, N=10),
                                 SC.x0, SC.params, SC.lh,
                                 x_init=out.xtraj.numpy(),
                                 u_init=out.utraj.numpy(), device="cpu")
    assert oracle.success, oracle.message
    assert np.abs(out.utraj.numpy() - oracle.utraj).max() < 1e-3
    assert np.abs(out.xtraj.numpy() - oracle.xtraj).max() < 1e-3
    assert np.isfinite(oracle.objective)


def test_kkt_report_matches_jax(converged):
    """`kkt_report` of the port and of JAX on the same iterates (the
    converged one, and it perturbed from a seed, carried over with
    `interop.solver_state_from_numpy`, and it with two stages moved near
    an obstacle): every field within 1e-10; the converged iterate reports
    ok, the perturbed one not, and the moved one's h violation counts the
    soft band."""
    solver, st, _ = converged
    jsolver = JaxRTI(jbuilders.usv_guidance_ca1(Tf=1.0, N=10), ipm_iters=30)
    # JAX's report calls step_fn eagerly; its jitted step is the same
    # function, compiled
    jfacade = types.SimpleNamespace(spec=jsolver.spec,
                                    step_fn=jsolver._jitted_step)
    rng = np.random.default_rng(0)
    xb, ub = st.xbar.numpy(), st.ubar.numpy()
    # stages 3 and 6 moved 1.4 m (inside the 0.2 m soft band of lh = 1.5)
    # and 1.0 m (past it) east of the first obstacle
    near = xb.copy()
    near[3, 5:7] = SC.params[:2] + [0.0, 1.4]
    near[6, 5:7] = SC.params[:2] + [0.0, 1.0]
    reports = []
    for xbar, ubar in ((xb, ub),
                       (xb + 0.01 * rng.standard_normal(xb.shape),
                        ub + 0.01 * rng.standard_normal(ub.shape)),
                       (near, ub)):
        got = kkt_report(solver, interop.solver_state_from_numpy(
            xbar, ubar, device="cpu", dtype=F64), SC.x0, SC.params, SC.lh)
        want = jkkt_report(jfacade, JaxState(xbar=jnp.asarray(xbar),
                                             ubar=jnp.asarray(ubar)),
                           SC.x0, SC.params, SC.lh)
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                                   atol=1e-10)
        reports.append(got)
    assert reports[0].ok(tol=1e-6, band_tol=1e-5), reports[0]
    assert not reports[1].ok(), reports[1]
    assert reports[1].rti_step_norm > 1e-3
    np.testing.assert_allclose(reports[2].h_violation, 1.5 - 1.0 - 0.2,
                               atol=1e-12)


@pytest.mark.slow
def test_full_horizon_kkt_certificate_flagship():
    """tests/test_parity.py::test_full_horizon_kkt_certificate_flagship on
    the port: the converged float64 SQP at N=100, at the start of the
    mission and mid-avoidance, is an NLP-KKT point."""
    spec = builders.usv_guidance_ca1()            # Tf=5, N=100
    solver = RTISolver(spec, ipm_iters=30, ipm_tol=1e-10, device="cpu",
                       dtype=F64)
    st = solver.init_state(SC.x0)
    st, _ = solver.solve_converged(st, SC.x0, SC.params, SC.lh,
                                   sqp_iters=100, step_alpha=0.5)
    rep = kkt_report(solver, st, SC.x0, SC.params, SC.lh)
    assert rep.ok(tol=1e-6, band_tol=1e-6), rep
    x_mid = np.array([0.7, 0.0, 0.0, 0.0, 0.0, 4.0, -1.0, np.pi / 2])
    st2 = solver.init_state(x_mid)
    st2, _ = solver.solve_converged(st2, x_mid, SC.params, SC.lh,
                                    sqp_iters=100, step_alpha=0.5)
    rep2 = kkt_report(solver, st2, x_mid, SC.params, SC.lh)
    assert rep2.ok(tol=1e-6, band_tol=1e-6), rep2
    p = torch.as_tensor(SC.params, dtype=F64)
    hmin = spec.model.h(st2.xbar[:-1].T, p).T[:, :4].min()
    assert float(hmin) < 1.8, float(hmin)


@pytest.mark.slow
def test_full_horizon_kkt_certificate_pf_ca():
    """tests/test_parity.py::test_full_horizon_kkt_certificate_pf_ca on the
    port: the hull with hard rows at its true Tf=1, N=100."""
    spec = builders.usv_pf_ca()
    solver = RTISolver(spec, ipm_iters=30, ipm_tol=1e-10, device="cpu",
                       dtype=F64)
    sc = scenarios.pf_ca_default()
    yref = np.tile(np.asarray(sc.yref, np.float64), (spec.N, 1))
    st = solver.init_state(sc.x0)
    st, _ = solver.solve_converged(st, sc.x0, sc.params, sc.lh,
                                   sqp_iters=100, step_alpha=0.5,
                                   yref=yref, yref_e=sc.yref_e)
    rep = kkt_report(solver, st, sc.x0, sc.params, sc.lh, yref=yref,
                     yref_e=sc.yref_e)
    assert rep.ok(tol=1e-6, band_tol=1e-6), rep
