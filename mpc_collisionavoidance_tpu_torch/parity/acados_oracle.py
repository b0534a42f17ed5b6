"""Optional true-acados oracle bridge (counterpart of
`mpc_collisionavoidance_tpu/parity/acados_oracle.py`).

Where acados_template + CasADi are installed (this module import-gates:
both are imported inside the functions only), build the reference's own
AcadosOcp for a given OCPSpec and solve it, so control trajectories can be
diffed directly against the reference solver stack (<1e-3 target,
BASELINE.md).  The mapping mirrors the information content of the
reference's acados_settings.py (reference scripts/usv_guidance_ca1/
acados_settings.py:42-209): LINEAR_LS cost, idxbu/idxbx bounds, nonlinear
h with soft slacks, PARTIAL_CONDENSING_HPIPM + SQP_RTI + GAUSS_NEWTON +
ERK.

The CasADi dynamics are not derived from the torch models (no symbolic
bridge); callers supply `casadi_model_fn` returning (x, u, p, xdot_expr,
h_expr), as `parity.casadi_models.make_casadi_model_fn` does.  The
port's OCPSpec holds numpy arrays on the host (`ocp/spec.py`), which go
to acados as they are.
"""

import numpy as np


def acados_available() -> bool:
    try:
        import acados_template  # noqa: F401
        import casadi  # noqa: F401
        return True
    except ImportError:
        return False


def build_acados_solver(spec, casadi_model_fn, json_file="acados_ocp.json"):
    """Construct an AcadosOcpSolver for `spec`. Raises ImportError where
    acados is unavailable."""
    import casadi as ca
    from acados_template import AcadosModel, AcadosOcp, AcadosOcpSolver

    x, u, p, xdot_expr, h_expr = casadi_model_fn()
    model = AcadosModel()
    model.name = spec.model.name
    model.x, model.u, model.p = x, u, p
    xdot = ca.SX.sym("xdot", spec.model.nx)
    model.xdot = xdot
    model.f_expl_expr = xdot_expr
    model.f_impl_expr = xdot - xdot_expr
    if h_expr is not None:
        model.con_h_expr = h_expr

    ocp = AcadosOcp()
    ocp.model = model
    ocp.dims.N = spec.N
    m = spec.model
    c = spec.cost
    ocp.cost.cost_type = "LINEAR_LS"
    ocp.cost.cost_type_e = "LINEAR_LS"
    ocp.cost.Vx, ocp.cost.Vu, ocp.cost.W = (np.asarray(c.Vx),
                                            np.asarray(c.Vu),
                                            np.asarray(c.W))
    ocp.cost.Vx_e, ocp.cost.W_e = np.asarray(c.Vx_e), np.asarray(c.W_e)
    ocp.cost.yref, ocp.cost.yref_e = np.asarray(c.yref), np.asarray(c.yref_e)

    ocp.constraints.lbu = np.asarray(m.lbu)
    ocp.constraints.ubu = np.asarray(m.ubu)
    ocp.constraints.idxbu = np.asarray(m.idxbu, dtype=int)
    if len(m.idxbx):
        ocp.constraints.lbx = np.asarray(m.lbx)
        ocp.constraints.ubx = np.asarray(m.ubx)
        ocp.constraints.idxbx = np.asarray(m.idxbx, dtype=int)
    if m.nh:
        ocp.constraints.lh = np.asarray(m.lh)
        ocp.constraints.uh = np.asarray(m.uh)
    if spec.soft is not None:
        s = spec.soft
        ocp.constraints.idxsh = np.asarray(s.idxsh, dtype=int)
        ocp.constraints.lsh = np.asarray(s.lsh)
        ocp.constraints.ush = np.asarray(s.ush)
        ocp.cost.zl, ocp.cost.Zl = np.asarray(s.zl), np.asarray(s.Zl)
        ocp.cost.zu, ocp.cost.Zu = np.asarray(s.zu), np.asarray(s.Zu)
    ocp.constraints.x0 = np.asarray(m.x0)
    ocp.parameter_values = np.zeros(m.np_)

    ocp.solver_options.qp_solver = "PARTIAL_CONDENSING_HPIPM"
    ocp.solver_options.nlp_solver_type = "SQP_RTI"
    ocp.solver_options.hessian_approx = "GAUSS_NEWTON"
    ocp.solver_options.integrator_type = "ERK"
    ocp.solver_options.tf = spec.N * spec.dt
    return AcadosOcpSolver(ocp, json_file=json_file)
