"""The port's parallel-scan Riccati (`ops/riccati_pscan.py`) and the lane
algebra it shares with partial condensing, against the plain sequential
sweep and the JAX package, on the CPU.

The scan solves the same LQR as the sweep, so the two agree to round-off
in float64 (rtol 1e-8, atol 1e-9, JAX's tests/test_riccati_pscan.py
shapes) and within float32 noise over the flagship's 100 stages.  The
lane engine's `riccati="pscan"` tick equals its sweep tick at 1e-10.
JAX's own pscan runs are `slow` in its suite; the ones here that run it
at a lane-engine size are `slow` too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ops import lanes as jln
from mpc_collisionavoidance_tpu.ops import riccati_lanes as jricc
from mpc_collisionavoidance_tpu.ops.riccati_pscan import (
    lqr_solve_pscan as jax_pscan)
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import lanes as ln
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import check_schedule
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    lqr_solve_lanes_plain)
from mpc_collisionavoidance_tpu_torch.ops.riccati_pscan import (
    lqr_solve_pscan)
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)
from tests.test_torch_riccati import random_lqr


def _lqr(N, nx, nu, L, seed, dtype=torch.float64):
    return interop.lane_lqr_from_numpy(
        *random_lqr(N=N, nx=nx, nu=nu, L=L, seed=seed), device="cpu",
        dtype=dtype)


@pytest.mark.parametrize("N,nx,nu", [(1, 3, 1), (2, 3, 1), (7, 8, 1),
                                     (16, 8, 2), (33, 5, 2), (25, 8, 10)])
def test_pscan_matches_sweep(N, nx, nu):
    """JAX's shapes, and a condensed flagship's macro shape (8, 10)."""
    d = _lqr(N, nx, nu, L=4, seed=N)
    for got, want in zip(lqr_solve_pscan(d), lqr_solve_lanes_plain(d)):
        torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-9)


def test_pscan_long_horizon_f32():
    """N = 100 (the flagship's horizon) in float32: within float32 noise."""
    d = _lqr(100, 8, 1, L=8, seed=3, dtype=torch.float32)
    for got, want in zip(lqr_solve_pscan(d), lqr_solve_lanes_plain(d)):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)


def test_pscan_matches_jax_pscan():
    """The port's scan against JAX's `lqr_solve_pscan` on the same LQR
    (the same combination tree, so round-off apart)."""
    fields = random_lqr(N=3, nx=3, nu=2, L=3, seed=11)
    d = interop.lane_lqr_from_numpy(*fields, device="cpu",
                                    dtype=torch.float64)
    want = jax_pscan(jricc.LaneLQR(*(jnp.asarray(a) for a in fields)))
    for got, w in zip(lqr_solve_pscan(d), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def test_lane_helpers_match_jax():
    """transpose, smtv, sgram_cross and ge_solve_mat against JAX's
    `ops/lanes.py` on the same arrays."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 4, 6))
    np.testing.assert_array_equal(ln.transpose(torch.as_tensor(A)).numpy(),
                                  np.asarray(jln.transpose(jnp.asarray(A))))
    S = rng.standard_normal((5, 3, 4, 6))
    x = rng.standard_normal((5, 3, 6))
    np.testing.assert_allclose(
        ln.smtv(torch.as_tensor(S), torch.as_tensor(x)).numpy(),
        np.asarray(jln.smtv(jnp.asarray(S), jnp.asarray(x))), rtol=1e-13,
        atol=1e-14)
    D = rng.standard_normal((5, 2, 4, 6))
    C = rng.standard_normal((5, 2, 3, 6))
    w = rng.standard_normal((5, 2, 6))
    np.testing.assert_allclose(
        ln.sgram_cross(*map(torch.as_tensor, (D, C, w))).numpy(),
        np.asarray(jln.sgram_cross(*map(jnp.asarray, (D, C, w)))),
        rtol=1e-13, atol=1e-14)
    M = np.eye(5)[:, :, None] + 0.3 * rng.standard_normal((5, 5, 6))
    Bm = rng.standard_normal((5, 3, 6))
    got = ln.ge_solve_mat(torch.as_tensor(M), torch.as_tensor(Bm))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jln.ge_solve_mat(jnp.asarray(M),
                                                 jnp.asarray(Bm))),
        rtol=1e-11, atol=1e-12)
    # leading stage axes are batched
    Ms = torch.as_tensor(np.stack([M, 2 * M]))
    Bs = torch.as_tensor(np.stack([Bm, Bm]))
    torch.testing.assert_close(ln.ge_solve_mat(Ms, Bs)[1], 0.5 * got,
                               rtol=1e-12, atol=1e-13)


def _flagship_inputs(Bn=8):
    sc = jscenarios.guidance_ca1_default()
    rng = np.random.default_rng(4)
    x0s = np.broadcast_to(sc.x0, (Bn, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(Bn)
    return (x0s, to_lanes(torch.as_tensor(x0s)),
            to_lanes(torch.as_tensor(np.broadcast_to(sc.params,
                                                     (Bn, 16)).copy())),
            to_lanes(torch.as_tensor(np.broadcast_to(sc.lh, (Bn, 8)).copy())))


@pytest.mark.parametrize("schedule", ["fixed15", "production"])
def test_pscan_tick_matches_sweep_tick(schedule):
    """The flagship's lane tick (N=25) with riccati='pscan' against the
    sweep backend, float64: 15 fixed iterations (JAX's
    test_lane_engine_with_pscan_backend) and the production schedule
    (adaptive centering, mu0='auto', escalation), two warm ticks."""
    spec = builders.usv_guidance_ca1(Tf=2.0, N=25)
    x0s, xL, pL, lhL = _flagship_inputs()
    cfg = (SolverConfig(ipm_iters=15) if schedule == "fixed15"
           else production_engine())
    outs = {}
    for backend in ("sweep", "pscan"):
        solver = dataclasses.replace(cfg, riccati=backend).build(
            spec, device="cpu", dtype=torch.float64)
        assert solver.riccati == backend
        st = solver.init_state(x0s)
        x = xL
        for _ in range(2):
            st, out = solver.step_fn(st, x, pL, lhL)
            x = out.x1
        outs[backend] = (out, st, int(solver.last_esc_iters))
    (o_s, st_s, e_s), (o_p, st_p, e_p) = outs["sweep"], outs["pscan"]
    torch.testing.assert_close(o_p.u0, o_s.u0, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(st_p.xbar, st_s.xbar, rtol=1e-8, atol=1e-10)
    assert torch.equal(o_p.status, o_s.status) and e_p == e_s


def test_pscan_schedule_validation():
    for centering in ("fixed", "adaptive", "mehrotra"):
        check_schedule("pscan", centering, "auto", 24)
    solver = SolverConfig(riccati="pscan", centering="mehrotra").build(
        builders.usv_guidance_ca1(Tf=1.0, N=10), device="cpu",
        dtype=torch.float64)
    assert isinstance(solver, LaneRTISolver) and solver.riccati == "pscan"
    with pytest.raises(ValueError, match="lane engine"):
        SolverConfig(engine="instance", riccati="pscan")
    with pytest.raises(ValueError, match="unknown riccati"):
        SolverConfig(riccati="lax")


@pytest.mark.slow
def test_pscan_tick_matches_jax_pscan_tick():
    """The port's pscan tick against JAX's lane engine with
    riccati='pscan' (slow in JAX's suite: its associative scan's
    compile)."""
    import jax

    from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
    from mpc_collisionavoidance_tpu.solver.batch import (
        LaneRTISolver as JaxLane)
    from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jl
    x0s, xL, pL, lhL = _flagship_inputs()
    js = JaxLane(jbuilders.usv_guidance_ca1(Tf=2.0, N=25), ipm_iters=15,
                 riccati="pscan")
    jst = js.init_state(x0s, dtype=jnp.float64)
    _, out_j = jax.jit(js.step_fn)(jst, jl(jnp.asarray(x0s)),
                                   jnp.asarray(pL.numpy()),
                                   jnp.asarray(lhL.numpy()))
    ts = LaneRTISolver(builders.usv_guidance_ca1(Tf=2.0, N=25),
                       ipm_iters=15, riccati="pscan", device="cpu",
                       dtype=torch.float64)
    _, out_t = ts.step_fn(ts.init_state(x0s), xL, pL, lhL)
    np.testing.assert_allclose(out_t.u0.numpy(), np.asarray(out_j.u0),
                               rtol=0, atol=5e-6)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))
