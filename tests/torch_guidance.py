"""Helpers of the guidance stack's CPU parity tests (`test_torch_guidance`,
`test_torch_missions`, `test_torch_fleet`, `test_torch_cascade`,
`test_torch_nodes`): the JAX production schedule's keywords, the vehicle
plants of the JAX suite's node tests in both packages, and a fixture that
runs a module on one torch thread."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.models import hydro as jhydro
from mpc_collisionavoidance_tpu.ops.integrators import rk4_step as jrk4_step
from mpc_collisionavoidance_tpu_torch.models import hydro
from mpc_collisionavoidance_tpu_torch.ops.integrators import rk4_step


def jax_production_kw():
    """The keywords of JAX's LaneRTISolver on the production schedule."""
    pe = jconfig.production_engine("cpu")
    return dict(ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                centering=pe.centering, mu0=pe.mu0,
                extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)


def jax_vehicle_tick(veh, t_port, t_stbd, c, dt):
    """tests/test_nodes.py::_vehicle_tick: the 6-state (psi, u, v, r,
    nedx, nedy) hull under the commanded thrusts."""

    def f(s, thr, _p):
        psi, u, v, r = s[0], s[1], s[2], s[3]
        tu, tr = jhydro.thrust_map(thr[0], thr[1], c)
        ud, vd, rd = jhydro.uvr_dot(u, v, r, tu, tr)
        return jnp.stack([r, ud, vd, rd,
                          u * jnp.cos(psi) - v * jnp.sin(psi),
                          u * jnp.sin(psi) + v * jnp.cos(psi)])

    return jrk4_step(f, veh, jnp.stack([t_port, t_stbd]), None, dt)


def vehicle_tick(veh, t_port, t_stbd, c, dt):
    """The same plant in torch (state-first dynamics, as the port's)."""

    def f(s, thr, _p):
        psi, u, v, r = s[0], s[1], s[2], s[3]
        tu, tr = hydro.thrust_map(thr[0], thr[1], c)
        ud, vd, rd = hydro.uvr_dot(u, v, r, tu, tr)
        return torch.stack([r, ud, vd, rd,
                            u * torch.cos(psi) - v * torch.sin(psi),
                            u * torch.sin(psi) + v * torch.cos(psi)])

    return rk4_step(f, veh, torch.stack([t_port, t_stbd]),
                    veh.new_zeros(0), dt)


def heading_plant(meas, psi_d, u_d, dt=0.05, T1=0.5):
    """tests/test_guidance_variants.py::_plant_tick on numpy floats: a
    first-order heading response + kinematics.  `meas` is (u, v, r, nedx,
    nedy, psi)."""
    _, v, _, nedx, nedy, psi0 = meas
    err = np.mod(psi_d - psi0 + np.pi, 2 * np.pi) - np.pi
    psi = psi0 + dt * err / T1
    return (u_d, v * 0.0, (psi - psi0) / dt, nedx + dt * u_d * np.cos(psi),
            nedy + dt * u_d * np.sin(psi), psi)


def rate_plant(meas, r_d, u_d, dt=0.05, T1=0.3):
    """tests/test_guidance_variants.py::_rate_plant_tick on numpy floats."""
    _, v, r0, nedx, nedy, psi0 = meas
    r = r0 + dt * (r_d - r0) / T1
    psi = psi0 + dt * r
    return (u_d, v * 0.0, r, nedx + dt * u_d * np.cos(psi),
            nedy + dt * u_d * np.sin(psi), psi)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch CPU ops on one thread, restored after it:
    the per-instance engine's tiny per-stage factorizations otherwise pay
    for waking the intra-op pool on every call (torch.linalg.cholesky_ex
    of a 2x2 took 7 ms with 8 threads on a loaded 8-core host, 4 us with
    one), which dominates these modules' CPU time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
