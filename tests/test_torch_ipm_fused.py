"""The port's fused IPM backend (`riccati="fused"`, K3's plain version on
the CPU) vs the JAX package's, float64 on the CPU.

The flagship is held to JAX's fused Pallas kernel in interpret mode (as
tests/test_ipm_fused.py runs it); the hull to JAX's lax lane IPM, which
tests/test_ipm_fused.py::test_fused_ipm_full_hull_nx14 proves equal to the
fused kernel at that shape.  The QPs are built by JAX's
`LaneRTISolver._build_qp` and carried across with
`interop.lane_qp_from_numpy`."""

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
from mpc_collisionavoidance_tpu_torch.kernels import ipm as ipm_kernel
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import ipm_lanes
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)

ITERS = 5


def _case(ocp, N, L, seed):
    """(JAX solver, JAX LaneQP, port LaneQP) at the OCP's default scenario,
    the bench's coordinate (ye) perturbed, from a cold start."""
    if ocp == "flagship":
        spec = jbuilders.usv_guidance_ca1(Tf=0.4, N=N)
        sc, ye = jscenarios.guidance_ca1_default(), 2
    else:
        spec = jbuilders.usv_pf_ca(Tf=0.4, N=N)
        sc, ye = jscenarios.pf_ca_default(), 6
    m = spec.model
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (L, m.nx)).copy()
    x0s[:, ye] += 0.1 * rng.standard_normal(L)
    solver = JaxLane(spec, ipm_iters=ITERS)
    st = solver.init_state(x0s, dtype=jnp.float64)
    qp = solver._build_qp(
        st, jax_lanes(jnp.asarray(x0s)),
        jax_lanes(jnp.asarray(np.broadcast_to(sc.params, (L, m.np_)))),
        jax_lanes(jnp.asarray(np.broadcast_to(sc.lh, (L, m.nh)))))
    fields = {k: np.asarray(v) for k, v in qp._asdict().items()}
    qp_t = interop.lane_qp_from_numpy(fields, device="cpu",
                                      dtype=torch.float64)
    return solver, qp, qp_t


def _port_qp(N=4, L=2):
    """A flagship LaneQP from the port's own QP assembly (no JAX)."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=N)
    solver = LaneRTISolver(spec, device="cpu", dtype=torch.float64)
    x0s = np.zeros((L, 8))
    x0s[:, 0] = 0.7
    p = torch.full((16, L), 100.0, dtype=torch.float64)
    return solver._build_qp(solver.init_state(x0s),
                            to_lanes(torch.as_tensor(x0s)), p, None)


def _assert_match(dx, du, gap, status, ref):
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref.dx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref.du), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(gap.numpy(), np.asarray(ref.gap), rtol=1e-10)
    np.testing.assert_array_equal(status.numpy(), np.asarray(ref.status))


def _check_both_entry_points(solver, qp_t, ref):
    before = ipm_kernel.launches
    sol = ipm_lanes.ipm_solve_lanes(qp_t, solver.idxbu, solver.idxbx,
                                    iters=ITERS, riccati="fused")
    assert ipm_kernel.launches == before          # CPU: the plain version
    _assert_match(sol.dx, sol.du, sol.gap, sol.status, ref)
    dx, du, gap, eq_res = ipm_lanes.fused_ipm_lanes_plain(
        qp_t, solver.idxbu, solver.idxbx, iters=ITERS)
    assert torch.equal(dx, sol.dx) and torch.equal(du, sol.du)
    assert torch.equal(gap, sol.gap) and torch.equal(eq_res, sol.eq_res)


@pytest.mark.parametrize("L", [5, 128])
def test_flagship_matches_jax_fused_kernel_interpret(L):
    solver, qp, qp_t = _case("flagship", N=8, L=L, seed=L)
    ref = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx, iters=ITERS,
                               riccati="fused_interpret",
                               fused_static=solver._fused_static)
    assert qp_t.Cs.shape[1] == 8 and qp_t.Ch.shape[1] == 0
    _check_both_entry_points(solver, qp_t, ref)


def test_hull_matches_jax_lax():
    solver, qp, qp_t = _case("hull", N=8, L=33, seed=33)
    ref = jipm.ipm_solve_lanes(qp, solver.idxbu, solver.idxbx, iters=ITERS,
                               riccati="lax")
    assert (len(solver.idxbu), len(solver.idxbx), qp_t.Ch.shape[1],
            qp_t.Cs.shape[1]) == (2, 5, 4, 0)
    _check_both_entry_points(solver, qp_t, ref)


def test_nan_lane_reports_status_2():
    solver, _, qp_t = _case("flagship", N=8, L=5, seed=0)
    dx0 = qp_t.dx0.clone()
    dx0[0, 2] = float("nan")
    sol = ipm_lanes.ipm_solve_lanes(qp_t._replace(dx0=dx0), solver.idxbu,
                                    solver.idxbx, iters=ITERS,
                                    riccati="fused")
    status = sol.status.tolist()
    assert status[2] == 2
    assert all(s in (0, 1) for i, s in enumerate(status) if i != 2)


def test_fused_tick_matches_jax_lax_tick():
    """One LaneRTISolver(riccati="fused") tick vs JAX's lax tick at the
    fixed schedule."""
    B = 5
    sc = jscenarios.guidance_ca1_default()
    rng = np.random.default_rng(7)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(B)
    params = np.broadcast_to(sc.params, (B, 16)).copy()
    lhs = np.broadcast_to(sc.lh, (B, 8)).copy()
    js = JaxLane(jbuilders.usv_guidance_ca1(Tf=0.4, N=8), ipm_iters=ITERS,
                 riccati="lax")
    _, out_j = js.step_fn(js.init_state(x0s, dtype=jnp.float64),
                          *(jax_lanes(jnp.asarray(a))
                            for a in (x0s, params, lhs)))
    ts = SolverConfig(ipm_iters=ITERS, riccati="fused").build(
        builders.usv_guidance_ca1(Tf=0.4, N=8), device="cpu",
        dtype=torch.float64)
    assert isinstance(ts, LaneRTISolver) and ts.riccati == "fused"
    _, out_t = ts.step_fn(ts.init_state(x0s),
                          *(to_lanes(torch.as_tensor(a))
                            for a in (x0s, params, lhs)))
    np.testing.assert_allclose(out_t.u0.numpy(), np.asarray(out_j.u0),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out_t.x1.numpy(), np.asarray(out_j.x1),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))


@pytest.mark.parametrize("kw", [
    dict(centering="adaptive"), dict(centering="mehrotra"),
    dict(mu0="auto"), dict(extra_iters=4)])
def test_fused_rejects_what_the_kernel_bakes(kw):
    """As tests/test_escalation.py and tests/test_adaptive_centering.py
    hold the JAX package: fused bakes fixed sigma, a scalar mu0 and a fixed
    iteration count."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    with pytest.raises(ValueError, match="fused"):
        LaneRTISolver(spec, riccati="fused", device="cpu",
                      dtype=torch.float64, **kw)
    with pytest.raises(ValueError, match="fused"):
        SolverConfig(riccati="fused", **kw)
    qp_t = _port_qp()
    with pytest.raises(ValueError, match="fused"):
        ipm_lanes.ipm_solve_lanes(qp_t, (0,), (), riccati="fused", **kw)


def test_unknown_backend_and_kernel_guards():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    with pytest.raises(ValueError, match="riccati"):
        LaneRTISolver(spec, riccati="pallas", device="cpu",
                      dtype=torch.float64)
    with pytest.raises(ValueError, match="riccati"):
        SolverConfig(riccati="lax")
    qp_t = _port_qp()
    with pytest.raises(ValueError, match="fused"):
        ipm_lanes.ipm_solve_lanes(qp_t._replace(Dh=qp_t.Ch), (0,), (),
                                  riccati="fused")
    # the kernel's wrapper takes CUDA tensors of an instantiated structure
    with pytest.raises(ValueError, match="CUDA device"):
        ipm_kernel.fused_ipm_lanes_cuda(qp_t, (0,), ())
    with pytest.raises(ValueError, match="no instance"):
        ipm_kernel.fused_ipm_lanes_cuda(qp_t, (), ())
