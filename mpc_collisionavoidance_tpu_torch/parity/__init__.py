"""Parity oracles (counterpart of `mpc_collisionavoidance_tpu/parity/`).

The reference's correctness story is acados itself; ours is layered oracles
that re-solve the SAME OCP through independent machinery:

- `goldens`: the committed closed-loop fixtures, recomputed by `RTISolver`;
- `nlp_oracle`: the full nonlinear OCP as a dense scipy SLSQP program with
  exact acados slack semantics — the control-trajectory parity target is
  <1e-3 (BASELINE.md) against the converged SQP solver;
- `kkt`: NLP feasibility/fixed-point reporting for any solver iterate;
- the acados bridge: `casadi_models` (the reference variants' CasADi
  models, transcribed once and bound to casadi and to torch),
  `acados_oracle` (the reference's AcadosOcp for an OCPSpec) and
  `run_acados_parity` (the closed-loop diff against acados, its fixtures,
  and their replay on the port's `RTISolver`).

Only the acados run itself (`acados_oracle.build_acados_solver`,
`run_acados_parity.run_variant`, `casadi_models.make_casadi_model_fn`'s
model) needs acados_template and casadi; those modules import them inside
the functions that need them.  The torch binding of the transcriptions and
the fixtures' replay run without them.
"""

from mpc_collisionavoidance_tpu_torch.parity.kkt import kkt_report  # noqa: F401
from mpc_collisionavoidance_tpu_torch.parity.nlp_oracle import (  # noqa: F401
    solve_ocp_nlp_dense)
