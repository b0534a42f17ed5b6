"""NLP feasibility / fixed-point reporting for solver iterates
(counterpart of `mpc_collisionavoidance_tpu/parity/kkt.py`).

The reference surfaces solver health as a single acados status int
(reference scripts/usv_guidance_ca1/main.py:135-137); production debugging
needs more.  `kkt_report` measures, for any iterate of the per-instance
engine (`RTISolver`, one instance, on its device and dtype):

- nonlinear dynamics defect (shooting-gap) max-norm,
- initial-state pin residual,
- box-bound violations,
- nonlinear constraint violation beyond the soft band,
- the RTI fixed-point step norm (one more linearize+QP must not move a
  converged iterate — the practical KKT test for an SQP method).
"""

from typing import NamedTuple

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ops import integrators
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                              SolverState)


class KKTReport(NamedTuple):
    dyn_residual: float      # max |F(x_k, u_k) - x_{k+1}|
    x0_residual: float       # max |x_0 - x0_measured|
    bound_violation: float   # max box-bound violation (0 if feasible)
    h_violation: float       # max soft-band-adjusted h violation
    rti_step_norm: float     # max |Delta u| of one extra RTI step

    def ok(self, tol=1e-6, band_tol=1e-6):
        return (self.dyn_residual < tol and self.x0_residual < tol
                and self.bound_violation < tol
                and self.h_violation < band_tol
                and self.rti_step_norm < 100 * tol)


def kkt_report(solver: RTISolver, state: SolverState, x0, params,
               lh=None, yref=None, yref_e=None) -> KKTReport:
    """`yref`/`yref_e`: the runtime references the iterate was solved
    against (None = the builder's static ones) — the fixed-point RTI step
    must re-solve the SAME problem."""
    spec = solver.spec
    m = spec.model
    xt, ut = state.xbar, state.ubar

    def t(a):
        return torch.as_tensor(a, dtype=xt.dtype, device=xt.device)

    params, x0 = t(params), t(x0)
    F = integrators.make_discrete_dynamics(m.f, spec.dt,
                                           spec.integrator_steps)
    roll = F(xt[:-1], ut, params)
    dyn = float((roll - xt[1:]).abs().max())
    x0r = float((xt[0] - x0).abs().max())

    bviol = 0.0
    if len(m.idxbu):
        usel = ut[:, np.asarray(m.idxbu, np.int64)]
        bviol = max(bviol, float((t(m.lbu) - usel).max()),
                    float((usel - t(m.ubu)).max()))
    if len(m.idxbx):
        xsel = xt[1:-1, np.asarray(m.idxbx, np.int64)]
        bviol = max(bviol, float((t(m.lbx) - xsel).max()),
                    float((xsel - t(m.ubx)).max()))
    bviol = max(bviol, 0.0)

    hviol = 0.0
    if m.nh:
        lh_full = t(m.lh if lh is None else lh)
        hval = m.h(xt[:-1].movedim(-1, 0), params).movedim(0, -1)
        viol = lh_full[None, :] - hval
        if spec.soft is not None:
            band = torch.zeros((m.nh,), dtype=xt.dtype, device=xt.device)
            band[np.asarray(spec.soft.idxsh, np.int64)] = -t(spec.soft.lsh)
            viol = viol - band[None, :]
        hviol = max(float(viol.max()), 0.0)

    _, out2 = solver.step_fn(state, x0, params, lh, yref=yref,
                             yref_e=yref_e)
    step = float((out2.utraj - ut).abs().max())

    return KKTReport(dyn_residual=dyn, x0_residual=x0r,
                     bound_violation=bviol, h_violation=hviol,
                     rti_step_norm=step)
