"""Parity oracles (counterpart of `mpc_collisionavoidance_tpu/parity/`).

The reference's correctness story is acados itself; ours is layered oracles
that re-solve the SAME OCP through independent machinery:

- `goldens`: the committed closed-loop fixtures, recomputed by `RTISolver`;
- `nlp_oracle`: the full nonlinear OCP as a dense scipy SLSQP program with
  exact acados slack semantics — the control-trajectory parity target is
  <1e-3 (BASELINE.md) against the converged SQP solver;
- `kkt`: NLP feasibility/fixed-point reporting for any solver iterate.

The JAX package's acados bridge is not ported: it needs casadi and
acados_template, which are not installed.
"""

from mpc_collisionavoidance_tpu_torch.parity.kkt import kkt_report  # noqa: F401
from mpc_collisionavoidance_tpu_torch.parity.nlp_oracle import (  # noqa: F401
    solve_ocp_nlp_dense)
