"""CasADi model transcriptions for all fourteen reference OCP variants
(counterpart of `mpc_collisionavoidance_tpu/parity/casadi_models.py`).

For every variant this module holds the symbolic dynamics and constraint
expressions the reference builds in ``scripts/<variant>/usv_model.py``,
written ONCE against a tiny backend-agnostic op set and bindable to

- **casadi** (`make_casadi_model_fn(name)`): feeds
  :func:`parity.acados_oracle.build_acados_solver` wherever
  acados_template + casadi are installed, and
- **torch** (`numeric_f(name)` / `numeric_h(name)`): an independent
  numeric binding that the tests hold against the port's production
  models (`models/variants.py`) and `chip_smoke.py` against the CUDA
  forms of the models (`csrc/models/*.cuh`), so a transcription typo or a
  kernel's slip is caught without acados.

The expression builders are the JAX package's text, copied unchanged, and
cite the reference CasADi files inline: e.g. the flagship dynamics from
scripts/usv_guidance_ca1/usv_model.py:117-128, the shared hull EOM from
scripts/usv_pf_ca/usv_model.py:137-160, the bicycle model from
scripts/race_cars/bycicle_model.py:100-145.  They are kept *textually
independent* of models/variants.py (reference sign groupings, explicit
distance rows), so the two implementations only agree if both are right.

Layout of the torch binding: state-first, as the port's models
(`models/base.py`): x (nx, ...), u (nu, ...), p (np, ...), whose trailing
batch axes broadcast against each other (p (np,) is shared), on any
device and in the dtype of x.  `ops.integrators` and `torch.func` compose
with it as with a model's f and h.
"""

from typing import Callable, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Backend op sets
# ---------------------------------------------------------------------------

def _abs_jax(x):
    """|x| with the derivative +1 at 0 (`jnp.abs`'s rule)."""
    return torch.where(x >= 0, x, -x)


class _TorchOps:
    """torch binding: the op set on tensors of one dtype and device (those
    of the state), to which Python constants are cast.

    `fabs` differentiates as the JAX binding's `jnp.abs` does, +1 at 0,
    which both packages' models follow (`models/hydro.py`,
    `csrc/models/hydro.cuh`).  CasADi's derivative there is sign(0) = 0;
    the two differ only in Jacobians at a point where an argument of |.|
    is exactly 0 (a hull at rest in sway or yaw)."""

    sin, cos = staticmethod(torch.sin), staticmethod(torch.cos)
    atan2, sqrt = staticmethod(torch.atan2), staticmethod(torch.sqrt)
    tanh, fabs = staticmethod(torch.tanh), staticmethod(_abs_jax)

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def if_else(self, cond, a, b):
        return torch.where(cond, self._tensor(a), self._tensor(b))

    def vertcat(self, *args):
        args = [self._tensor(a) for a in args]
        shape = torch.broadcast_shapes(*[a.shape for a in args])
        return torch.stack([a.expand(shape) for a in args])


class _CasadiOps:
    """casadi binding (only constructible where casadi is installed)."""

    def __init__(self):
        import casadi as ca
        self.sin, self.cos = ca.sin, ca.cos
        self.atan2, self.sqrt, self.tanh = ca.atan2, ca.sqrt, ca.tanh
        self.fabs = ca.fabs
        self.if_else = ca.if_else
        self.vertcat = ca.vertcat


# ---------------------------------------------------------------------------
# Shared hull EOM (reference scripts/usv_pf_ca/usv_model.py:61-77,137-151;
# identical text in usv_acados / usv_low_level / usv_position_control up to
# the thrust asymmetry constant c)
# ---------------------------------------------------------------------------

def _hull_uvr_dot(o, u, v, r, Tport, Tstbd, c):
    X_u_dot = -2.25
    Y_v_dot = -23.13
    Y_r_dot = -1.31
    N_v_dot = -16.41
    N_r_dot = -2.79
    Yvv = -99.99
    Yvr = -5.49
    Nrv = -8.8
    Nrr = -3.49
    m = 30
    Iz = 4.1
    B = 0.41
    Xu = o.if_else(u > 1.25, 64.55, -25)
    Xuu = o.if_else(u > 1.25, -70.92, 0)
    Yv = 0.5 * (-40 * 1000 * o.fabs(v)) * (
        1.1 + 0.0045 * (1.01 / 0.09) - 0.1 * (0.27 / 0.09)
        + 0.016 * ((0.27 / 0.09) * (0.27 / 0.09)))
    Nr = (-0.52) * o.sqrt(u * u + v * v)
    Tu = Tport + c * Tstbd
    Tr = (Tport - c * Tstbd) * B / 2
    udot = (Tu - (-m + 2 * Y_v_dot) * v - (Y_r_dot + N_v_dot) * r * r
            - (-Xu * u - Xuu * o.fabs(u) * u)) / (m - X_u_dot)
    vdot = (-(m - X_u_dot) * u * r
            - (-Yv - Yvv * o.fabs(v) - Yvr * o.fabs(r)) * v) / (m - Y_v_dot)
    rdot = (Tr - (-2 * Y_v_dot * u * v - (Y_r_dot + N_v_dot) * r * u
                  + X_u_dot * u * r)
            - (-Nr * r - Nrv * o.fabs(v) * r - Nrr * o.fabs(r) * r)) \
        / (Iz - N_r_dot)
    return udot, vdot, rdot


def _distances(o, xp, yp, p, n_obs):
    """distance_i = sqrt((xp-oxi)^2 + (yp-oyi)^2), p = (ox1,oy1,...)
    (reference scripts/usv_guidance_ca1/usv_model.py:133-140)."""
    rows = []
    for i in range(n_obs):
        dx = xp - p[2 * i]
        dy = yp - p[2 * i + 1]
        rows.append(o.sqrt(dx * dx + dy * dy))
    return o.vertcat(*rows)


# ---------------------------------------------------------------------------
# Per-variant expression builders: (x, U, p, ops) -> (f_expl, h_expr|None)
# ---------------------------------------------------------------------------

def _usv_acados(x, U, p, o):
    """reference scripts/usv_acados/usv_model.py:86-123 (c=0.78 at :77)."""
    u, v, r, Tport, Tstbd = x[0], x[1], x[2], x[3], x[4]
    udot, vdot, rdot = _hull_uvr_dot(o, u, v, r, Tport, Tstbd, c=0.78)
    return o.vertcat(udot, vdot, rdot, U[0], U[1]), None


def _usv_low_level(x, U, p, o):
    """reference scripts/usv_low_level/usv_model.py:89-131 (c=0.78;
    Tstbd integrates UTstbddot/c)."""
    c = 0.78
    psi, u, v, r = x[0], x[3], x[4], x[5]
    Tport, Tstbd = x[6], x[7]
    udot, vdot, rdot = _hull_uvr_dot(o, u, v, r, Tport, Tstbd, c=c)
    return o.vertcat(
        r,
        o.cos(psi) * r,
        -o.sin(psi) * r,
        udot, vdot, rdot,
        U[0],
        U[1] / c,
    ), None


def _usv_position_control(x, U, p, o):
    """reference scripts/usv_position_control/usv_model.py:89-130 (c=0.78;
    both thrusts integrate their rates directly)."""
    psi, u, v, r = x[2], x[3], x[4], x[5]
    Tport, Tstbd = x[6], x[7]
    udot, vdot, rdot = _hull_uvr_dot(o, u, v, r, Tport, Tstbd, c=0.78)
    return o.vertcat(
        u * o.cos(psi) - v * o.sin(psi),
        u * o.sin(psi) + v * o.cos(psi),
        r,
        udot, vdot, rdot,
        U[0],
        U[1],
    ), None


def _pf_f(x, U, p, o):
    """Shared 14-state pf dynamics (reference scripts/usv_pf_ca/
    usv_model.py:137-160; c=1.0 at :77)."""
    c = 1.0
    psi, u, v, r = x[0], x[3], x[4], x[5]
    ak = x[9]
    Tport, Tstbd = x[12], x[13]
    udot, vdot, rdot = _hull_uvr_dot(o, u, v, r, Tport, Tstbd, c=c)
    beta = o.atan2(v, u + .001)
    chi = psi + beta
    nedxdot = u * o.cos(psi) - v * o.sin(psi)
    nedydot = u * o.sin(psi) + v * o.cos(psi)
    return o.vertcat(
        r,
        o.cos(chi) * r,
        -o.sin(chi) * r,
        udot, vdot, rdot,
        -nedxdot * o.sin(ak) + nedydot * o.cos(ak),
        0, 0, 0,
        nedxdot,
        nedydot,
        U[0],
        U[1] / c,
    )


def _usv_pf(x, U, p, o):
    return _pf_f(x, U, p, o), None


def _usv_pf_ca(x, U, p, o):
    """pf + 4 obstacle distances on (nedx, nedy) = (x[10], x[11])
    (reference scripts/usv_pf_ca/usv_model.py:122-131,165-168,213)."""
    return _pf_f(x, U, p, o), _distances(o, x[10], x[11], p, 4)


def _usv_guidance(x, U, p, o):
    """reference scripts/usv_guidance/usv_model.py:61-115 (T1=1.0)."""
    T1 = 1.0
    psi, u, v = x[2], x[5], x[6]
    ak, psid = x[8], x[9]
    nedxdot = u * o.cos(psi) - v * o.sin(psi)
    nedydot = u * o.sin(psi) + v * o.cos(psi)
    return o.vertcat(
        nedxdot,
        nedydot,
        (psid - psi) / T1,
        o.cos(psi) * ((psid - psi) / T1),
        -o.sin(psi) * ((psid - psi) / T1),
        0, 0,
        -nedxdot * o.sin(ak) + nedydot * o.cos(ak),
        0,
        U[0],
    ), None


def _usv_guidance2(x, U, p, o):
    """reference scripts/usv_guidance2/usv_model.py:61-120 (T1=0.4)."""
    T1 = 0.4
    psi, u, v, r = x[2], x[5], x[6], x[7]
    ak, rd = x[9], x[11]
    nedxdot = u * o.cos(psi) - v * o.sin(psi)
    nedydot = u * o.sin(psi) + v * o.cos(psi)
    return o.vertcat(
        nedxdot,
        nedydot,
        r,
        o.cos(psi) * r,
        -o.sin(psi) * r,
        0, 0,
        (rd - r) / T1,
        -nedxdot * o.sin(ak) + nedydot * o.cos(ak),
        0,
        rd,
        U[0],
    ), None


def _usv_guidance3(x, U, p, o):
    """reference scripts/usv_guidance3/usv_model.py:61-120 (T1=1.0;
    chi = psi + beta at :106-107)."""
    T1 = 1.0
    psi, u, v, r = x[2], x[5], x[6], x[7]
    ak, rd = x[9], x[10]
    beta = o.atan2(v, u + .001)
    chi = psi + beta
    nedxdot = u * o.cos(psi) - v * o.sin(psi)
    nedydot = u * o.sin(psi) + v * o.cos(psi)
    return o.vertcat(
        nedxdot,
        nedydot,
        r,
        o.cos(chi) * r,
        -o.sin(chi) * r,
        0, 0,
        (rd - r) / T1,
        -nedxdot * o.sin(ak) + nedydot * o.cos(ak),
        0,
        U[0],
    ), None


def _usv_guidance4(x, U, p, o):
    """reference scripts/usv_guidance4/usv_model.py:61-100 (T1=0.2;
    control IS psied)."""
    T1 = 0.2
    u, v, chie = x[0], x[1], x[3]
    beta = o.atan2(v, u + 0.001)
    psie = chie - beta
    return o.vertcat(
        0, 0,
        u * o.sin(psie) + v * o.cos(psie),
        (U[0] - psie) / T1,
    ), None


def _usv_guidance5(x, U, p, o):
    """reference scripts/usv_guidance5/usv_model.py:61-102 (T1=1.0)."""
    T1 = 1.0
    u, v, chie, psied = x[0], x[1], x[3], x[4]
    beta = o.atan2(v, u + 0.001)
    psie = chie - beta
    return o.vertcat(
        0, 0,
        u * o.sin(psie) + v * o.cos(psie),
        (psied - psie) / T1,
        U[0],
    ), None


def _usv_guidance_ca(x, U, p, o):
    """reference scripts/usv_guidance_ca/usv_model.py:61-190 (T1=1.0;
    jerk-level input; 8 distances on (xned, yned) = (x[5], x[6]))."""
    T1 = 1.0
    u, v, chie, psied = x[0], x[1], x[3], x[4]
    psi, psieddot = x[7], x[8]
    beta = o.atan2(v, u + 0.001)
    psie = chie - beta
    return o.vertcat(
        0, 0,
        u * o.sin(psie) + v * o.cos(psie),
        (psied - psie) / T1,
        psieddot,
        u * o.cos(psi) - v * o.sin(psi),
        u * o.sin(psi) + v * o.cos(psi),
        (psied - psie) / T1,
        U[0],
    ), _distances(o, x[5], x[6], p, 8)


def _usv_guidance_ca1(x, U, p, o):
    """FLAGSHIP (reference scripts/usv_guidance_ca1/usv_model.py:113-199,
    T1=1.0; 8 soft distances on (xned, yned) = (x[5], x[6]))."""
    T1 = 1.0
    u, v, chie, psied, psi = x[0], x[1], x[3], x[4], x[7]
    beta = o.atan2(v, u + 0.001)
    psie = chie - beta
    return o.vertcat(
        0, 0,
        u * o.sin(psie) + v * o.cos(psie),
        (psied - psie) / T1,
        U[0],
        u * o.cos(psi) - v * o.sin(psi),
        u * o.sin(psi) + v * o.cos(psi),
        (psied - psie) / T1,
    ), _distances(o, x[5], x[6], p, 8)


def _race_cars(x, U, p, o, kappa_fn=None):
    """reference scripts/race_cars/bycicle_model.py:60-145.  The original
    interpolates kappa(s) from a gitignored tracks/ data dir via a casadi
    bspline interpolant; `kappa_fn` is injectable (default straight track,
    kappa = 0) exactly like models/variants.race_cars."""
    m, C1, C2 = 0.043, 0.5, 15.5
    Cm1, Cm2, Cr0, Cr2 = 0.28, 0.05, 0.011, 0.006
    s, n, alpha, v, D, delta = x[0], x[1], x[2], x[3], x[4], x[5]
    kap = kappa_fn(s) if kappa_fn is not None else 0.0
    Fxd = (Cm1 - Cm2 * v) * D - Cr2 * v * v - Cr0 * o.tanh(5 * v)
    sdota = (v * o.cos(alpha + C1 * delta)) / (1 - kap * n)
    f = o.vertcat(
        sdota,
        v * o.sin(alpha + C1 * delta),
        v * C2 * delta - kap * sdota,
        Fxd / m * o.cos(C1 * delta),
        U[0],
        U[1],
    )
    a_lat = C2 * v * v * delta + Fxd * o.sin(C1 * delta) / m
    a_long = Fxd / m
    return f, o.vertcat(a_long, a_lat, n, D, delta)


_EXPRS = {
    "usv_acados": _usv_acados,
    "usv_low_level": _usv_low_level,
    "usv_position_control": _usv_position_control,
    "usv_pf": _usv_pf,
    "usv_pf_ca": _usv_pf_ca,
    "usv_guidance": _usv_guidance,
    "usv_guidance2": _usv_guidance2,
    "usv_guidance3": _usv_guidance3,
    "usv_guidance4": _usv_guidance4,
    "usv_guidance5": _usv_guidance5,
    "usv_guidance_ca": _usv_guidance_ca,
    "usv_guidance_ca1": _usv_guidance_ca1,
    "race_cars": _race_cars,
    "race_cars_dev": _race_cars,   # same model, dev solver settings
}

VARIANTS = tuple(_EXPRS)


def _registry_name(name: str) -> str:
    """race_cars_dev shares the race_cars model (only solver settings
    differ, reference scripts/race_cars/acados_settings_dev.py)."""
    return "race_cars" if name == "race_cars_dev" else name


# ---------------------------------------------------------------------------
# Bindings
# ---------------------------------------------------------------------------

def make_casadi_model_fn(name: str,
                         kappa_fn: Optional[Callable] = None) -> Callable:
    """Return the `casadi_model_fn` argument of
    :func:`parity.acados_oracle.build_acados_solver` for `name`:
    a zero-arg callable producing (x, u, p, f_expl, h_expr) casadi MX.
    Raises ImportError at call time where casadi is not installed."""
    expr = _EXPRS[name]

    def fn():
        import casadi as ca

        from mpc_collisionavoidance_tpu_torch.models import registry
        m = registry.get(_registry_name(name))
        x = ca.MX.sym("x", m.nx)
        u = ca.MX.sym("u", m.nu)
        p = ca.MX.sym("p", m.np_) if m.np_ else ca.vertcat()
        f, h = _bind(expr, name, kappa_fn)(x, u, p, _CasadiOps())
        return x, u, p, f, h

    return fn


def _bind(expr, name, kappa_fn):
    if name.startswith("race_cars"):
        return lambda x, u, p, o: expr(x, u, p, o, kappa_fn=kappa_fn)
    return expr


def _numeric(b, index):
    """The torch binding of builder `b`'s output `index` (0: f, 1: h) as a
    function of state-first x, u, p; u and p are cast to the dtype and
    device of x."""

    def fn(x, u, p):
        x = torch.as_tensor(x)
        o = _TorchOps(x.dtype, x.device)
        return b(x, o._tensor(u), o._tensor(p), o)[index]

    return fn


def numeric_f(name: str, kappa_fn: Optional[Callable] = None) -> Callable:
    """torch binding of the transcribed dynamics: f(x, u, p) -> xdot, all
    state-first (xdot (nx, ...)).  Held against models/variants.py and
    against the CUDA forms of the models."""
    return _numeric(_bind(_EXPRS[name], name, kappa_fn), 0)


def numeric_h(name: str, kappa_fn: Optional[Callable] = None):
    """torch binding of the transcribed constraint rows, h(x, u, p) ->
    (nh, ...), or None where the variant has none."""
    from mpc_collisionavoidance_tpu_torch.models import registry
    b = _bind(_EXPRS[name], name, kappa_fn)
    m = registry.get(_registry_name(name))
    x0 = torch.as_tensor(np.asarray(m.x0, float))
    probe = _numeric(b, 1)(x0, np.zeros(m.nu), np.zeros(m.np_))
    return None if probe is None else _numeric(b, 1)


def linearize_lanes(name: str, xs, ubar, params, *, dt: float,
                    integrator_steps: int = 1,
                    kappa_fn: Optional[Callable] = None):
    """The transcription's linearization in the layout of the CUDA kernel
    (`kernels/linearize.py::linearize_lanes_cuda`): xs (nx, N, L), ubar
    (nu, N, L), params (np, L) -> (xn (nx, N, L), J (N, nx, nx+nu, L),
    hbar (nh, N, L), C (N, nh, nx, L)).  `numeric_f` goes through
    `ops.integrators.make_discrete_dynamics_with_sens` (RK4 in
    `integrator_steps` substeps of dt / integrator_steps, one jvp per
    column) and `numeric_h` through `torch.func.jacfwd` (of the rows at
    xs + d with respect to one offset d (nx,) shared by all points: the
    rows are pointwise, so this is each point's dh/dx).  Every column is
    computed, also those outside the model's f_dep and h_dep, which the
    kernel does not compute."""
    from mpc_collisionavoidance_tpu_torch.ops.integrators import (
        make_discrete_dynamics_with_sens)
    nx, N, L = xs.shape
    G = make_discrete_dynamics_with_sens(
        numeric_f(name, kappa_fn), dt, integrator_steps)
    xn, A, B = G(xs.movedim(0, -1), ubar.movedim(0, -1),
                 params.movedim(0, -1))      # (N, L, nx), (N, L, nx, nx+nu)
    J = torch.cat([A, B], dim=-1).permute(0, 2, 3, 1)
    h = numeric_h(name, kappa_fn)
    if h is None:
        return (xn.movedim(-1, 0), J, xs.new_zeros((0, N, L)),
                xs.new_zeros((N, 0, nx, L)))

    def rows(d):
        return h(xs + d[:, None, None], ubar, params)

    C = torch.func.jacfwd(rows)(xs.new_zeros(nx))      # (nh, N, L, nx)
    return xn.movedim(-1, 0), J, rows(xs.new_zeros(nx)), \
        C.permute(1, 0, 3, 2)
