"""Shared 3-DOF ASV hydrodynamics (surge/sway/yaw) in torch (counterpart of
`mpc_collisionavoidance_tpu/models/hydro.py`).

The equations of motion of the full-model variants (reference
scripts/usv_pf_ca/usv_model.py:61-77,137-160): piecewise surge drag
switching at u > 1.25 m/s, sway drag proportional to |v|, speed-dependent
yaw drag and the differential-thrust map with asymmetry `c`.

Two derivative rules follow JAX's, so that `torch.func.jvp` gives the
JAX package's Jacobians everywhere, kinks included:
- `_abs` is `where(x >= 0, x, -x)`: its derivative at 0 is +1, as JAX's
  `jnp.abs`; `torch.abs` would give 0 there;
- the drag switch is `where(u > 1.25, ...)`, the same comparison as
  `jnp.where`, so the one-sided derivative at the switch matches.
The CUDA form of the same equations is `csrc/models/hydro.cuh`.
"""

import torch

# Added-mass / damping / geometry constants
# (reference scripts/usv_pf_ca/usv_model.py:61-76)
X_U_DOT = -2.25
Y_V_DOT = -23.13
Y_R_DOT = -1.31
N_V_DOT = -16.41
N_R_DOT = -2.79
YVV = -99.99
YVR = -5.49
YRV = -5.49
YRR = -8.8
NVV = -5.49
NVR = -8.8
NRV = -8.8
NRR = -3.49
MASS = 30.0
IZ = 4.1
BEAM = 0.41

# Sway-drag scalar factor (reference scripts/usv_pf_ca/usv_model.py:139)
_YV_FACTOR = (1.1 + 0.0045 * (1.01 / 0.09) - 0.1 * (0.27 / 0.09)
              + 0.016 * ((0.27 / 0.09) ** 2))


def _abs(x):
    """|x| with derivative +1 at 0 (JAX's rule)."""
    return torch.where(x >= 0, x, -x)


def _select(cond, a: float, b: float, like):
    return torch.where(cond, torch.full_like(like, a),
                       torch.full_like(like, b))


def thrust_map(tport, tstbd, c):
    """Tu = Tport + c*Tstbd ; Tr = (Tport - c*Tstbd)*B/2
    (reference scripts/usv_pf_ca/usv_model.py:141-142)."""
    tu = tport + c * tstbd
    tr = (tport - c * tstbd) * BEAM / 2.0
    return tu, tr


def uvr_dot(u, v, r, tu, tr):
    """Body-frame accelerations (udot, vdot, rdot), with the reference's
    sign groupings (reference scripts/usv_pf_ca/usv_model.py:137-151)."""
    fast = u > 1.25
    xu = _select(fast, 64.55, -25.0, u)
    xuu = _select(fast, -70.92, 0.0, u)
    yv = 0.5 * (-40.0 * 1000.0 * _abs(v)) * _YV_FACTOR
    nr = -0.52 * torch.sqrt(u * u + v * v)

    u_dot = (
        tu
        - (-MASS + 2.0 * Y_V_DOT) * v
        - (Y_R_DOT + N_V_DOT) * r * r
        - (-xu * u - xuu * _abs(u) * u)
    ) / (MASS - X_U_DOT)
    v_dot = (
        -(MASS - X_U_DOT) * u * r - (-yv - YVV * _abs(v) - YVR * _abs(r)) * v
    ) / (MASS - Y_V_DOT)
    r_dot = (
        tr
        - (-2.0 * Y_V_DOT * u * v - (Y_R_DOT + N_V_DOT) * r * u
           + X_U_DOT * u * r)
        - (-nr * r - NRV * _abs(v) * r - NRR * _abs(r) * r)
    ) / (IZ - N_R_DOT)
    return u_dot, v_dot, r_dot
