"""The hull family's models with no obstacle rows and the kinematic
guidance family, for the tests of the port (this module imports no JAX:
tests/test_torch_cuda.py runs on the card, where there is none)."""

import numpy as np

from mpc_collisionavoidance_tpu_torch.models import registry

FAMILY = ("usv_pf", "usv_low_level", "usv_acados", "usv_position_control")
# the state coordinates (u, v, r, Tport, Tstbd) of each model
HYDRO = {"usv_pf": (3, 4, 5, 12, 13), "usv_low_level": (3, 4, 5, 6, 7),
         "usv_acados": (0, 1, 2, 3, 4),
         "usv_position_control": (3, 4, 5, 6, 7)}


def random_point(name, N, L, seed, dt=0.01):
    """(x (nx, N, L), u (2, N, L), p (0, L)) around the hull's operating
    range: surge 0.2-2 m/s on both sides of the 1.25 m/s drag switch,
    thrusts -20..30; lane 0 has v = 0 exactly with r != 0 (the kink of
    |v|), lane 1 (where L > 1) has v = r = 0.  Sway is ~0.1 m/s at an RK4
    step `dt` of 0.01 s and scaled down with a longer step: the sway
    drag's stiffness (~750 |v| per second) leaves RK4 stable only while
    |v| dt stays below ~1/750."""
    m = registry.get(name)
    iu, iv, ir, ip, istbd = HYDRO[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m.nx, N, L)) * 0.5
    x[iu] = rng.uniform(0.2, 2.0, size=(N, L))
    x[iv] = rng.normal(size=(N, L)) * 0.1 * min(1.0, 0.01 / dt)
    x[iv, :, 0] = 0.0
    x[ir, :, 0] = rng.uniform(0.2, 0.6, size=N) * np.sign(
        rng.normal(size=N))
    x[[iv, ir], :, 1:2] = 0.0
    x[[ip, istbd]] = rng.uniform(-20.0, 30.0, size=(2, N, L))
    u = rng.normal(size=(m.nu, N, L)) * 5.0
    return x, u, np.zeros((0, L))


# the kinematic guidance family, in porting order, with the state
# coordinate of each model's surge u
GUIDANCE = ("usv_guidance_ca", "usv_guidance", "usv_guidance2",
            "usv_guidance3", "usv_guidance4", "usv_guidance5")
SURGE = {"usv_guidance_ca": 0, "usv_guidance": 5, "usv_guidance2": 5,
         "usv_guidance3": 5, "usv_guidance4": 0, "usv_guidance5": 0}


def guidance_point(name, N, L, seed):
    """(x (nx, N, L), u (1, N, L), p (np, L)) of a guidance model: states
    ~0.5 N(0, 1) with a forward surge of 0.2-1.5 m/s (away from the crab
    angle's branch cut at u + 0.001 < 0, v = 0), controls ~0.2 N(0, 1);
    usv_guidance_ca's 8 obstacle centres 2-50 m out, as the flagship's
    (tests/test_linearize_pallas.py)."""
    m = registry.get(name)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m.nx, N, L)) * 0.5
    x[SURGE[name]] = rng.uniform(0.2, 1.5, size=(N, L))
    u = rng.normal(size=(m.nu, N, L)) * 0.2
    return x, u, rng.uniform(2.0, 50.0, size=(m.np_, L))
