"""How many operations one per-instance tick dispatches, counted on the
CPU: the size of the graph that the card captures for it.

    python -m tools.instance_ops [--only NAME ...] [--batch 1]

For the flagship and the hull (or `--only` models) on both QP backends,
one warm float32 `RTISolver.step_fn` at the builder's N from the model's
scenario, every aten operation that is not a view counted under a
`TorchDispatchMode`.  The K1 and K2 routes stand in as one operation
each (on the card each is one kernel; on the CPU their plain versions
would dispatch thousands): `ops.ipm.lqr_solve` returns zeros, and
`ops.linearize.linearize_lanes` runs outside the count.  "all" counts
every operation; "non-empty" only those with an output element, the
ones that launch a kernel on the card (an operation on an empty tensor,
a model's row family of size 0, launches none).  A CPU count: it says
nothing of time.
"""

import argparse

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import ipm, linearize
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver

# aten operations that make a view (no kernel) or wrap a Python scalar
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "transpose",
         "unsqueeze", "squeeze", "permute", "t", "alias", "as_strided",
         "detach", "unbind", "split", "split_with_sizes", "diagonal",
         "_reshape_alias", "lift_fresh"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.all = self.nonempty = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in VIEWS:
            self.all += 1
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.nonempty += any(isinstance(t, torch.Tensor) and t.numel()
                                 for t in outs)
        return out


def count(name, backend, batch):
    """(all, non-empty) operations of one warm tick of `name`."""
    spec = builders.build(name)
    sc = scenarios.DEFAULTS[name][0]()
    solver = RTISolver(spec, qp_backend=backend, device="cpu",
                       dtype=torch.float32)
    x0 = np.broadcast_to(sc.x0, batch + (spec.model.nx,))
    lh = sc.lh if np.size(sc.lh) else None
    real_lqr, real_lin = ipm.lqr_solve, linearize.linearize_lanes

    def lqr(d, reg=0.0):
        return torch.zeros_like(d.qx), torch.zeros_like(d.qu)

    def lin(*args, **kw):
        with _disable_current_modes():
            return real_lin(*args, **kw)

    ipm.lqr_solve, linearize.linearize_lanes = lqr, lin
    try:
        st, _ = solver.step_fn(solver.init_state(x0), x0, sc.params, lh)
        with Count() as c:
            solver.step_fn(st, x0, sc.params, lh)
    finally:
        ipm.lqr_solve, linearize.linearize_lanes = real_lqr, real_lin
    return c.all, c.nonempty


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", nargs="*",
                   default=["usv_guidance_ca1", "usv_pf_ca"])
    p.add_argument("--batch", type=int, default=1,
                   help="leading batch size (1: unbatched)")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    batch = () if args.batch == 1 else (args.batch,)
    for name in args.only:
        for backend in ("riccati", "dense"):
            n_all, n_nonempty = count(name, backend, batch)
            print(f"{name} {backend} B={args.batch}: {n_all} operations, "
                  f"{n_nonempty} non-empty")


if __name__ == "__main__":
    main()
