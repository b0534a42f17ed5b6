"""State carried across from the JAX package, as numpy only.

These take numpy arrays (for example a JAX `LaneQP._asdict()` mapped
through `np.asarray`) and build the port's tensors on a device and dtype.
They never import jax, so the same QPs, LQRs and warm starts can be fed to
both packages.
"""

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import LaneQP
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import LaneLQR
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneState


def _tensor(a, device, dtype):
    # a copy: arrays from jax are read-only
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def lane_state_from_numpy(xbar, ubar, *, device, dtype) -> LaneState:
    """xbar (nx, N+1, L), ubar (nu, N, L) -> LaneState."""
    return LaneState(xbar=_tensor(xbar, device, dtype),
                     ubar=_tensor(ubar, device, dtype))


def lane_qp_from_numpy(fields: dict, *, device, dtype) -> LaneQP:
    """A mapping of LaneQP field names to numpy arrays -> LaneQP.  Fields
    that are None (or numpy's 0-d object array holding None) stay None."""
    out = {}
    for name in LaneQP._fields:
        v = fields.get(name)
        if v is not None and not (isinstance(v, np.ndarray)
                                  and v.dtype == object and v.ndim == 0
                                  and v.item() is None):
            out[name] = _tensor(v, device, dtype)
        else:
            out[name] = None
    missing = [n for n in LaneQP._fields
               if out[n] is None and n not in ("Dh", "Ds")]
    if missing:
        raise ValueError(f"lane_qp_from_numpy: missing fields {missing}")
    return LaneQP(**out)


def lane_lqr_from_numpy(A, B, c, Q, S, R, qx, qu, dx0, *, device,
                        dtype) -> LaneLQR:
    """The nine LaneLQR arrays (lane layout) -> LaneLQR."""
    return LaneLQR(*(_tensor(a, device, dtype)
                     for a in (A, B, c, Q, S, R, qx, qu, dx0)))
