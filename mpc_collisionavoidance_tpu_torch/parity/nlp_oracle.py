"""Dense NLP oracle: the OCP re-solved by scipy SLSQP, slacks and all
(counterpart of `mpc_collisionavoidance_tpu/parity/nlp_oracle.py`).

Independent of every solver-side code path (no Riccati, no IPM, no lane
layout): the full trajectory is one dense decision vector, dynamics are
equality constraints on the same RK4 integrator, and the acados soft-
constraint semantics (zl/Zl linear+quadratic penalties, lsh/ush slack
bounds; reference scripts/usv_guidance_ca1/acados_settings.py:105-178) are
reproduced with explicit slack variables.  The objective, the dynamics
defect and the inequality rows are torch functions of the decision vector
in float64; the gradient is `torch.func.grad` and the Jacobians
`torch.func.jacrev` (one vectorized reverse pass over every row), so SLSQP
converges tightly and the <1e-3 control parity target of BASELINE.md is
meaningful.  scipy is imported when the oracle runs.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.config import require_device
from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops import integrators


class OracleSolution(NamedTuple):
    xtraj: np.ndarray   # (N+1, nx), includes the pinned x0
    utraj: np.ndarray   # (N, nu)
    sl: np.ndarray      # (N, nS)
    su: np.ndarray      # (N, nS)
    objective: float
    success: bool
    message: str


def solve_ocp_nlp_dense(spec: OCPSpec, x0, params,
                        lh: Optional[np.ndarray] = None,
                        x_init=None, u_init=None,
                        maxiter: int = 400, *,
                        device="cuda") -> OracleSolution:
    """Solve the OCP as a dense NLP with scipy SLSQP, the functions and
    their derivatives evaluated in float64 on `device` (a CUDA device on a
    host without one raises ValueError)."""
    from scipy.optimize import minimize

    device = require_device(device)
    f64 = dict(dtype=torch.float64, device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), **f64)

    m = spec.model
    N, nx, nu = spec.N, m.nx, m.nu
    nS = len(spec.soft.idxsh) if spec.soft is not None else 0

    def index(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    soft_idx = index(spec.soft.idxsh) if nS else None
    hard_idx = index(spec.hard_h_rows())
    idxbu, idxbx = index(m.idxbu), index(m.idxbx)
    scale = float(spec.stage_scale)
    x0 = np.asarray(x0, np.float64)
    x0_t = t(x0)
    params = t(params)
    lh_full = t(m.lh if lh is None else lh)
    uh_full = t(m.uh)
    lbu, ubu, lbx, ubx = t(m.lbu), t(m.ubu), t(m.lbx), t(m.ubx)

    F = integrators.make_discrete_dynamics(m.f, spec.dt,
                                           spec.integrator_steps)

    def h_rows(x):
        """h of each stage state x (N, nx) -> (N, nh)."""
        return m.h(x.movedim(-1, 0), params).movedim(0, -1)

    nz = N * nx + N * nu + 2 * N * nS

    def split(z):
        xs = z[: N * nx].reshape(N, nx)              # x_1 .. x_N
        us = z[N * nx: N * (nx + nu)].reshape(N, nu)
        sl = z[N * (nx + nu): N * (nx + nu) + N * nS].reshape(N, nS)
        su = z[N * (nx + nu) + N * nS:].reshape(N, nS)
        return xs, us, sl, su

    def stages(xs):
        """x_0 .. x_{N-1}: the pinned x0, then the decision states."""
        return torch.cat([x0_t[None], xs[:-1]], dim=0)

    Vx, Vu, W = t(spec.cost.Vx), t(spec.cost.Vu), t(spec.cost.W)
    yref = t(spec.cost.yref)
    Vx_e, W_e = t(spec.cost.Vx_e), t(spec.cost.W_e)
    yref_e = t(spec.cost.yref_e)
    if nS:
        zl, Zl = t(spec.soft.zl), t(spec.soft.Zl)
        zu, Zu = t(spec.soft.zu), t(spec.soft.Zu)
        lsh, ush = t(spec.soft.lsh), t(spec.soft.ush)

    def objective(z):
        xs, us, sl, su = split(z)
        y = (stages(xs) @ Vx.T + us @ Vu.T) - yref       # stages 0..N-1
        cost = 0.5 * scale * ((y @ W) * y).sum()
        ye = Vx_e @ xs[-1] - yref_e
        cost = cost + 0.5 * ye @ (W_e @ ye)
        if nS:
            cost = cost + scale * (sl @ zl + su @ zu).sum()
            cost = cost + 0.5 * scale * ((sl * sl) @ Zl
                                         + (su * su) @ Zu).sum()
        return cost

    def dynamics_defect(z):
        xs, us, _, _ = split(z)
        return (F(stages(xs), us, params) - xs).reshape(-1)

    def ineq(z):
        """All inequality rows, >= 0 feasible."""
        xs, us, sl, su = split(z)
        rows = []
        if len(idxbu):
            usel = us[:, idxbu]
            rows += [(usel - lbu).reshape(-1), (ubu - usel).reshape(-1)]
        if len(idxbx):
            xsel = stages(xs)[1:, idxbx]                  # stages 1..N-1
            rows += [(xsel - lbx).reshape(-1), (ubx - xsel).reshape(-1)]
        if m.nh:
            hval = h_rows(stages(xs))                     # (N, nh)
            if len(hard_idx):
                hh = hval[:, hard_idx]
                rows += [(hh - lh_full[hard_idx]).reshape(-1),
                         (uh_full[hard_idx] - hh).reshape(-1)]
            if nS:
                hs = hval[:, soft_idx]
                rows += [(hs - lh_full[soft_idx] + sl).reshape(-1),
                         (uh_full[soft_idx] - hs + su).reshape(-1),
                         (sl - lsh).reshape(-1),
                         (su - ush).reshape(-1)]
        if not rows:
            return z.new_zeros((1,))
        return torch.cat(rows)

    def host(fn):
        """fn over torch float64 on the device -> fn over numpy."""
        def call(z):
            return fn(t(z)).detach().cpu().numpy()
        return call

    obj_g = host(torch.func.grad(objective))
    dyn_j = host(torch.func.jacrev(dynamics_defect))
    ineq_j = host(torch.func.jacrev(ineq))
    dyn_f = host(dynamics_defect)
    ineq_f = host(ineq)

    z0 = np.zeros(nz)
    xs0 = (np.broadcast_to(x0, (N, nx)) if x_init is None
           else np.asarray(x_init, np.float64)[1:])
    z0[: N * nx] = xs0.reshape(-1)
    if u_init is not None:
        z0[N * nx: N * (nx + nu)] = np.asarray(u_init).reshape(-1)
    if nS:
        # feasible slack start: cover current violation, respect bounds
        h0 = h_rows(t(np.concatenate([x0[None], xs0[:-1]])))
        viol = (lh_full[soft_idx][None, :] - h0[:, soft_idx]).cpu().numpy()
        sl0 = np.maximum(viol, np.asarray(spec.soft.lsh)[None, :]) + 0.05
        z0[N * (nx + nu): N * (nx + nu) + N * nS] = sl0.reshape(-1)
        z0[N * (nx + nu) + N * nS:] = np.maximum(
            np.asarray(spec.soft.ush), 0.0).repeat(N)

    res = minimize(
        lambda z: float(objective(t(z))), z0, jac=obj_g,
        method="SLSQP",
        constraints=[dict(type="eq", fun=dyn_f, jac=dyn_j),
                     dict(type="ineq", fun=ineq_f, jac=ineq_j)],
        options=dict(maxiter=maxiter, ftol=1e-12),
    )
    xs, us, sl, su = split(res.x)
    xtraj = np.concatenate([x0[None], np.asarray(xs)])
    return OracleSolution(xtraj=xtraj, utraj=np.asarray(us),
                          sl=np.asarray(sl), su=np.asarray(su),
                          objective=float(res.fun), success=bool(res.success),
                          message=str(res.message))
