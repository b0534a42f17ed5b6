"""Explicit Runge-Kutta shooting integrators (counterpart of
`mpc_collisionavoidance_tpu/ops/integrators.py`).

One classical RK4 step of length dt = Tf/N per shooting interval, as
acados' ERK integrator at its defaults.  The discrete sensitivities are
`torch.func.jvp` of the step, one column per (x, u) coordinate, which
differentiates the same Butcher tableau as `jax.jacfwd` does.

Layouts: these take the JAX package's instance-last shapes, x (..., nx),
u (..., nu), p (..., np), whose leading axes broadcast against each other
(p (np,) is shared).  The port's models take state-first tensors
(`models/base.py`), so `f` is called on x, u and p with their last axis
moved to the front, and its result moved back.
"""

import torch


def _state_first(f):
    """f over state-first tensors -> f over instance-last ones."""
    def fl(x, u, p):
        return f(x.movedim(-1, 0), u.movedim(-1, 0),
                 p.movedim(-1, 0)).movedim(0, -1)
    return fl


def _rk4(f, x, u, p, dt):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * dt * k1, u, p)
    k3 = f(x + 0.5 * dt * k2, u, p)
    k4 = f(x + dt * k3, u, p)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step(f, x, u, p, dt):
    """One classical RK4 step of `xdot = f(x, u, p)` (zero-order hold on
    u); `f` is a model's state-first dynamics."""
    return _rk4(_state_first(f), x, u, p, dt)


def make_discrete_dynamics(f, dt, num_steps: int = 1):
    """Return F(x, u, p) advancing one shooting interval of length `dt` in
    `num_steps` RK4 substeps (acados sim_method_num_steps)."""
    h = dt / num_steps
    fl = _state_first(f)

    def F(x, u, p):
        for _ in range(num_steps):
            x = _rk4(fl, x, u, p, h)
        return x

    return F


def make_discrete_dynamics_with_sens(f, dt, num_steps: int = 1):
    """Return G(x, u, p) -> (x_next, A, B): the discrete step and its exact
    Jacobians d x_next/dx (..., nx, nx) and d x_next/du (..., nx, nu)."""
    F = make_discrete_dynamics(f, dt, num_steps)

    def G(x, u, p):
        nx = x.shape[-1]
        xu = torch.cat([x, u], dim=-1)                 # same leading axes

        def F_wu(z):
            return F(z[..., :nx], z[..., nx:], p)

        x_next = F(x, u, p)
        cols = []
        for k in range(xu.shape[-1]):
            tangent = torch.zeros_like(xu)
            tangent[..., k] = 1.0
            cols.append(torch.func.jvp(F_wu, (xu,), (tangent,))[1])
        J = torch.stack(cols, dim=-1)                  # (..., nx, nx+nu)
        return x_next, J[..., :nx], J[..., nx:]

    return G
