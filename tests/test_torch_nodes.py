"""The port's other guidance nodes — `PFController` (usv_pf),
`ThrustMPCController` (usv_acados) and `VariantGuidanceController` over
its table (usv_guidance..5, usv_guidance_ca) — vs the JAX package's,
float64 on the CPU: 20 ticks each at reduced N, both sides fed the same
measurements (the JAX suite's plants driven by the JAX side's commands),
commands at 1e-6 and identical status."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance.nodes import (
    PFController as JaxPF, PFMeasurements as JaxPFMeas,
    ThrustMPCController as JaxThrust, ThrustMeasurements as JaxThrustMeas)
from mpc_collisionavoidance_tpu.guidance.variants import (
    VariantGuidanceController as JaxVariant,
    VariantMeasurements as JaxVariantMeas)
from mpc_collisionavoidance_tpu_torch.guidance.nodes import (
    PFController, PFMeasurements, ThrustMPCController, ThrustMeasurements)
from mpc_collisionavoidance_tpu_torch.guidance.variants import (
    _TABLE, VariantGuidanceController, VariantMeasurements)
from tests.torch_guidance import (heading_plant, jax_vehicle_tick,  # noqa: F401
                                 one_torch_thread, rate_plant)

F64 = torch.float64
TICKS = 20
ATOL = 1e-6


def _assert_cmds(got, want):
    for f in want._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        if f in ("solver_status", "active"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                       err_msg=f)


def test_pf_node_matches_jax():
    """usv_pf at N=20, Tf=0.2 pulling a laterally offset hull onto an
    eastward path (tests/test_nodes.py's mission, shortened)."""
    wps = np.array([[0.0, 0.0], [40.0, 0.0]])
    jctrl = JaxPF(ipm_iters=10, N=20, Tf=0.2)
    ctrl = PFController(ipm_iters=10, N=20, Tf=0.2, device="cpu", dtype=F64)
    veh = jnp.asarray([0.0, 0.001, 0.0, 0.0, 0.0, 1.5], jnp.float64)

    def meas_of(v):
        return (v[1], v[2], v[3], v[4], v[5], v[0])

    jst = jctrl.init_state(JaxPFMeas(*meas_of(veh)), wps, 2,
                           dtype=jnp.float64)
    st = ctrl.init_state(PFMeasurements(*map(np.asarray, meas_of(veh))),
                         wps, 2)
    jtick = jax.jit(jctrl.tick)
    for _ in range(TICKS):
        jst, jc = jtick(jst, JaxPFMeas(*meas_of(veh)), jnp.asarray(wps), 2)
        st, c = ctrl.tick(st, PFMeasurements(*map(np.asarray, meas_of(veh))),
                          wps, 2)
        _assert_cmds(c, jc)
        np.testing.assert_allclose(st.past_t_port.numpy(),
                                   np.asarray(jst.past_t_port), atol=ATOL)
        veh = jax_vehicle_tick(veh, jc.t_port, jc.t_stbd, c=1.0, dt=0.01)
    assert float(np.abs(c.t_port.numpy())) > 0.0


def test_pf_node_zero_thrust_when_mission_done():
    """Within the capture radius of the final waypoint the node publishes
    zero thrust and zero desired speed (reference nmpc_pf.cpp:259-267)."""
    wps = np.array([[0.0, 0.0], [0.8, 0.0]])
    ctrl = PFController(ipm_iters=6, N=20, Tf=0.2, device="cpu", dtype=F64)
    meas = PFMeasurements(u=0.001, v=0.0, r=0.0, nedx=0.0, nedy=0.0, psi=0.0)
    st = ctrl.init_state(meas, wps, 2)
    st, cmds = ctrl.tick(st, meas, wps, 2)
    assert not bool(cmds.active)
    assert float(cmds.t_port) == 0.0 and float(cmds.t_stbd) == 0.0
    assert float(cmds.u_d) == 0.0


def test_thrust_node_matches_jax():
    """usv_acados at its builder's N=20 tracking u_des = 1.0 from rest
    against the true hull (c = 0.78, 20 Hz)."""
    jctrl = JaxThrust(ipm_iters=8)
    ctrl = ThrustMPCController(ipm_iters=8, device="cpu", dtype=F64)
    veh = jnp.asarray([0.0, 0.001, 0.0, 0.0, 0.0, 0.0], jnp.float64)
    jst = jctrl.init_state(JaxThrustMeas(veh[1], veh[2], veh[3]),
                           dtype=jnp.float64)
    st = ctrl.init_state(ThrustMeasurements(*np.asarray(veh[1:4])))
    jtick = jax.jit(jctrl.tick)
    for _ in range(TICKS):
        jst, jc = jtick(jst, JaxThrustMeas(veh[1], veh[2], veh[3]))
        st, c = ctrl.tick(st, ThrustMeasurements(*np.asarray(veh[1:4])))
        _assert_cmds(c, jc)
        np.testing.assert_allclose(st.past_t_stbd.numpy(),
                                   np.asarray(jst.past_t_stbd), atol=ATOL)
        veh = jax_vehicle_tick(veh, jc.t_port, jc.t_stbd, c=0.78, dt=0.05)
    assert float(veh[1]) > 0.1                        # it accelerated


VARIANT_TF = {"usv_guidance_ca": 5.0}


@pytest.mark.parametrize("name", sorted(_TABLE))
def test_variant_matches_jax(name):
    """Each table entry at N=20 on a straight north path from 1.5 m off
    it, heading off by 0.3 rad (tests/test_guidance_variants.py's run,
    shortened): the heading plant closes the loop, or the rate plant for
    usv_guidance3, which publishes no heading."""
    wps = np.array([[0.0, -5.0], [0.0, 25.0]])
    Tf = VARIANT_TF.get(name, 1.0)
    jctrl = JaxVariant(name, Tf=Tf, N=20, ipm_iters=10)
    ctrl = VariantGuidanceController(name, Tf=Tf, N=20, ipm_iters=10,
                                     device="cpu", dtype=F64)
    meas = (0.7, 0.0, 0.0, 1.5, 0.0, 0.3)
    jst = jctrl.init_state(JaxVariantMeas(*meas), wps, 2, dtype=jnp.float64)
    st = ctrl.init_state(VariantMeasurements(*meas), wps, 2)
    np.testing.assert_allclose(st.memory.numpy(), np.asarray(jst.memory),
                               atol=1e-12)
    jtick = jax.jit(jctrl.tick)
    for _ in range(TICKS):
        jst, jc = jtick(jst, JaxVariantMeas(*map(jnp.asarray, meas)),
                        jnp.asarray(wps), 2)
        st, c = ctrl.tick(st, VariantMeasurements(*meas), wps, 2)
        _assert_cmds(c, jc)
        np.testing.assert_allclose(st.memory.numpy(), np.asarray(jst.memory),
                                   rtol=0, atol=ATOL)
        if name == "usv_guidance3":
            meas = rate_plant(meas, float(jc.r_d), float(jc.u_d))
        else:
            meas = heading_plant(meas, float(jc.psi_d), float(jc.u_d))
    assert not bool((c.solver_status == 2).any())


def test_variant_table_rejects_ca_models():
    for name in ("usv_guidance_ca1", "usv_pf_ca"):
        with pytest.raises(ValueError, match="not a plain guidance variant"):
            VariantGuidanceController(name, device="cpu")
