"""Partial condensing in the port (`ops/condense_partial.py`, the lane
IPM's control-coupled rows and stage-varying cost, `LaneRTISolver(...,
condense=M)`) against the port's full-resolution tick and against the JAX
package, float64 on the CPU.

The condensed QP is an exact elimination of the interior states, so the
condensed tick reaches the full one's optimum (atol 1e-9, as JAX's
`tests/test_condense_partial.py`), the port's condensing equals JAX's on
the same LaneQP to round-off (atol 1e-12), and the port's condensed tick
equals JAX's at the lane engine's parity tolerance (5e-6, identical
status).  The three constraint regimes: the flagship (soft h rows and a
u-box), the hull usv_pf_ca (hard h rows and hard state boxes: general
hard rows with control coupling, `Dh`) and race_cars_dev (a softened
state box among its soft rows, `Ds`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import condense_partial as jcp
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import condense_partial as cp
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import ipm_solve_lanes
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)

B = 4
F64 = dict(device="cpu", dtype=torch.float64)
# reference-scale dt (Tf/N = 0.01): the hull's RK4 diverges at dt ~ 1/12
SPEC_KW = dict(Tf=0.12, N=12)


def _inputs(name, Bn=B):
    """x0 (B, nx), params (B, np), lh (B, nh) or None, as JAX's
    tests/test_condense_partial.py makes them."""
    m = jbuilders.build(name, **SPEC_KW).model
    if name == "usv_guidance_ca1":
        sc = jscenarios.guidance_ca1_default()
        return (np.broadcast_to(sc.x0, (Bn, m.nx)).copy(),
                np.broadcast_to(sc.params, (Bn, m.np_)).copy(),
                np.broadcast_to(sc.lh, (Bn, m.nh)).copy())
    rng = np.random.default_rng(0)
    x0 = 0.1 * rng.standard_normal((Bn, m.nx))
    params = np.full((Bn, m.np_), 100.0)
    lh = (np.broadcast_to(np.asarray(m.lh), (Bn, m.nh)).copy() if m.nh
          else None)
    return x0, params, lh


def _lanes(a):
    return None if a is None else to_lanes(torch.as_tensor(a))


@functools.cache
def _port_ticks(name, M, ticks=3):
    """u0, xbar, status after `ticks` warm-started ticks (25 fixed IPM
    iterations, x0 held) of the port's tick condensed by M."""
    x0, params, lh = _inputs(name)
    solver = LaneRTISolver(builders.build(name, **SPEC_KW), ipm_iters=25,
                           condense=M, **F64)
    st = solver.init_state(x0)
    for _ in range(ticks):
        st, out = solver.step_fn(st, _lanes(x0), _lanes(params), _lanes(lh))
    return out.u0, st.xbar, out.status


@pytest.mark.parametrize("name,M", [
    ("usv_guidance_ca1", 2), ("usv_guidance_ca1", 3), ("usv_guidance_ca1", 4),
    ("usv_pf_ca", 2), ("usv_pf_ca", 4),
    ("race_cars_dev", 2), ("race_cars_dev", 4),
])
def test_condensed_matches_full(name, M):
    u0_ref, xbar_ref, status_ref = _port_ticks(name, 1)
    assert torch.all(status_ref == 0)
    u0, xbar, status = _port_ticks(name, M)
    assert torch.all(status == 0), (name, M, status)
    torch.testing.assert_close(u0, u0_ref, rtol=0, atol=1e-9)
    torch.testing.assert_close(xbar, xbar_ref, rtol=0, atol=1e-9)


@functools.cache
def _jax_qp(name, ticks=1):
    """A full-resolution JAX LaneQP off a warm-started iterate, and the
    JAX solver that built it."""
    spec = jbuilders.build(name, **SPEC_KW)
    x0, params, lh = _inputs(name)
    solver = JaxLane(spec, ipm_iters=8)
    st = solver.init_state(x0, dtype=jnp.float64)
    xL = jax_lanes(jnp.asarray(x0, jnp.float64))
    pL = jax_lanes(jnp.asarray(params, jnp.float64))
    lhL = None if lh is None else jax_lanes(jnp.asarray(lh, jnp.float64))
    for _ in range(ticks):
        st, out = jax.jit(solver.step_fn)(st, xL, pL, lhL)
    return jax.jit(solver._build_qp)(st, out.x1, pL, lhL), solver


def _numpy_fields(qp):
    return {k: None if v is None else np.asarray(v)
            for k, v in qp._asdict().items()}


@pytest.mark.parametrize("name,M", [("usv_guidance_ca1", 4),
                                    ("usv_pf_ca", 2), ("race_cars_dev", 2)])
def test_condense_and_expand_match_jax(name, M):
    """The port's condensing of JAX's own LaneQP (fed through `interop`)
    equals JAX's field by field, the macro index set too, and so does
    the expansion of a random macro solution."""
    jqp, js = _jax_qp(name)
    jqp_c, jidxbu_c, jaux = jax.jit(jcp.condense_lane_qp,
                                    static_argnums=(1, 2, 3))(
        jqp, M, js.idxbu, js.idxbx)
    qp = interop.lane_qp_from_numpy(_numpy_fields(jqp), **F64)
    assert qp.Dh is None and qp.Ds is None
    qp_c, idxbu_c, aux = cp.condense_lane_qp(qp, M, js.idxbu, js.idxbx)
    assert idxbu_c == jidxbu_c
    for field, want in _numpy_fields(jqp_c).items():
        got = getattr(qp_c, field)
        if want is None:
            assert got is None, field
            continue
        assert tuple(got.shape) == want.shape, field
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12,
                                   err_msg=field)
    assert aux.M == jaux.M and aux.nu == jaux.nu

    rng = np.random.default_rng(M)
    G, L = qp_c.A.shape[0], qp_c.A.shape[-1]
    dx_c = rng.standard_normal((G + 1, qp_c.A.shape[1], L))
    du_c = rng.standard_normal((G, qp_c.B.shape[2], L))
    want = jcp.expand_solution(jaux, jnp.asarray(dx_c), jnp.asarray(du_c))
    got = cp.expand_solution(aux, torch.as_tensor(dx_c),
                             torch.as_tensor(du_c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def _jax_production_kw():
    pe = jconfig.production_engine("cpu")
    return dict(ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                centering=pe.centering, mu0=pe.mu0,
                extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)


@pytest.mark.parametrize("name,M", [("usv_guidance_ca1", 4),
                                    ("usv_pf_ca", 2), ("race_cars_dev", 2)])
def test_condensed_tick_matches_jax(name, M):
    """Two warm-started closed-loop ticks (x0 <- x1) of the production
    schedule condensed by M, port vs JAX's jitted condensed step_fn."""
    x0, params, lh = _inputs(name)
    js = JaxLane(jbuilders.build(name, **SPEC_KW), condense=M,
                 **_jax_production_kw())
    jst = js.init_state(x0, dtype=jnp.float64)
    jstep = jax.jit(js.step_fn)
    jx = jax_lanes(jnp.asarray(x0, jnp.float64))
    jp = jax_lanes(jnp.asarray(params, jnp.float64))
    jlh = None if lh is None else jax_lanes(jnp.asarray(lh, jnp.float64))
    cfg = production_engine()
    ts = LaneRTISolver(builders.build(name, **SPEC_KW), condense=M,
                       ipm_iters=cfg.ipm_iters, ipm_tol=cfg.ipm_tol,
                       centering=cfg.centering, mu0=cfg.mu0,
                       extra_iters=cfg.extra_iters, stall_tol=cfg.stall_tol,
                       **F64)
    tst = ts.init_state(x0)
    tx, tp, tlh = _lanes(x0), _lanes(params), _lanes(lh)
    for _ in range(2):
        jst, out_j = jstep(jst, jx, jp, jlh)
        tst, out_t = ts.step_fn(tst, tx, tp, tlh)
        for f in ("u0", "x1"):
            np.testing.assert_allclose(getattr(out_t, f).numpy(),
                                       np.asarray(getattr(out_j, f)),
                                       rtol=0, atol=5e-6, err_msg=f)
        np.testing.assert_array_equal(out_t.status.numpy(),
                                      np.asarray(out_j.status))
        jx, tx = out_j.x1, out_t.x1
    np.testing.assert_allclose(tst.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=5e-6)


@pytest.mark.parametrize("condense", [1, 2])
def test_prepare_feedback_split_exact(condense):
    """prepare_fn + feedback_fn compose to exactly step_fn, condensed or
    not (JAX's tests/test_lane_engine.py::
    test_lane_prepare_feedback_split_exact)."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    sc = jscenarios.guidance_ca1_default()
    rng = np.random.default_rng(3)
    x0s = np.broadcast_to(sc.x0, (6, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(6)
    pL = _lanes(np.broadcast_to(sc.params, (6, 16)).copy())
    lhL = _lanes(np.broadcast_to(sc.lh, (6, 8)).copy())
    solver = LaneRTISolver(spec, ipm_iters=8, condense=condense, **F64)
    st = solver.init_state(x0s)
    st, out = solver.step_fn(st, _lanes(x0s), pL, lhL)
    st, out = solver.step_fn(st, out.x1, pL, lhL)
    x_meas = out.x1 + 0.01
    st_ref, out_ref = solver.step_fn(st, x_meas, pL, lhL)
    qp = solver.prepare_fn(st, pL, lhL)
    st_split, out_split = solver.feedback_fn(st, qp, x_meas)
    for got, want in ((out_split.u0, out_ref.u0),
                      (st_split.xbar, st_ref.xbar),
                      (st_split.ubar, st_ref.ubar)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_condense_validation():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    with pytest.raises(ValueError, match="divide"):
        LaneRTISolver(spec, condense=3, **F64)
    with pytest.raises(ValueError, match="divide"):
        LaneRTISolver(spec, condense=0, **F64)
    with pytest.raises(ValueError, match="fused"):
        LaneRTISolver(spec, condense=2, riccati="fused", mu0=1.0, **F64)
    assert LaneRTISolver(spec, condense=5, riccati="pscan",
                         **F64).condense == 5

    jqp, js = _jax_qp("usv_guidance_ca1")
    qp = interop.lane_qp_from_numpy(_numpy_fields(jqp), **F64)
    with pytest.raises(ValueError, match="divide"):
        cp.condense_lane_qp(qp, 5, js.idxbu, js.idxbx)
    qp_c, idxbu_c, _ = cp.condense_lane_qp(qp, 4, js.idxbu, js.idxbx)
    with pytest.raises(ValueError, match="full-resolution"):
        cp.condense_lane_qp(qp_c, 3, idxbu_c, ())
    # the fused whole-IPM kernel refuses the condensed QP, as JAX's
    with pytest.raises(ValueError, match="control-coupled"):
        ipm_solve_lanes(qp_c, idxbu_c, (), riccati="fused")
    # the condensed QP solves on the sweep and the pscan backends alike
    sols = [ipm_solve_lanes(qp_c, idxbu_c, (), iters=25, riccati=r)
            for r in ("sweep", "pscan")]
    assert torch.all(sols[0].status == 0)
    torch.testing.assert_close(sols[1].du, sols[0].du, rtol=0, atol=1e-10)
