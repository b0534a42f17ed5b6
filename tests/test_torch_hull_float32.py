"""The hull's float32 QP: the port's float32 solve and the JAX package's,
each against the float64 solve of the same QP, on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from mpc_collisionavoidance_tpu.ops import ipm_lanes as jipm
from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    contiguous_qp, fused_ipm_lanes_plain)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes


def test_hull_float32_qp_spread_is_jax_s_too():
    """The float32 hull QP (usv_pf_ca, N=100, L=128, the fused solver's
    `_build_qp` at the perturbed default scenario, seed 128): the port's
    float32 plain solve and JAX's float32 lane IPM (lax) of the same numpy
    inputs both differ from the float64 solve by ~3.1 in du, on the same
    lanes, and agree with each other to the float32 gap-floor ball.  The
    spread is the QP's in float32 (the hull's cost has R = 0), not a fault
    of the port."""
    L, iters = 128, 12
    spec = builders.build("usv_pf_ca")
    factory, coord = scenarios.DEFAULTS["usv_pf_ca"]
    sc = factory()
    rng = np.random.default_rng(L)
    x0s = np.broadcast_to(sc.x0, (L, 14)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(L)
    solver = SolverConfig(riccati="fused").build(spec, device="cpu",
                                                 dtype=torch.float32)
    lanes = [to_lanes(torch.tensor(np.asarray(a), dtype=torch.float32))
             for a in (x0s, np.broadcast_to(sc.params, (L, 8)),
                       np.broadcast_to(sc.lh, (L, 4)))]
    qp = contiguous_qp(solver._build_qp(solver.init_state(x0s), *lanes))
    iu, ix = solver.idxbu, solver.idxbx
    qp64 = qp._replace(**{k: v.double() for k, v in qp._asdict().items()
                          if v is not None})
    du64 = fused_ipm_lanes_plain(qp64, iu, ix, iters=iters)[1]
    du32 = fused_ipm_lanes_plain(qp, iu, ix, iters=iters)[1].double()
    jqp = jipm.LaneQP(**{k: None if v is None else jnp.asarray(v.numpy())
                         for k, v in qp._asdict().items()})
    sol = jipm.ipm_solve_lanes(jqp, iu, ix, iters=iters, riccati="lax")
    assert sol.du.dtype == jnp.float32
    duj = torch.as_tensor(np.array(sol.du)).double()
    port_err = (du32 - du64).abs().amax(dim=(0, 1))
    jax_err = (duj - du64).abs().amax(dim=(0, 1))
    assert 2.5 < float(port_err.max()) < 4.0
    assert 2.5 < float(jax_err.max()) < 4.0
    assert torch.equal(port_err > 1e-2, jax_err > 1e-2)
    assert float((du32 - duj).abs().max()) < 5e-3
