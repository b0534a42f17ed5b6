"""Structural input-dependency probes for model Jacobians (counterpart of
`mpc_collisionavoidance_tpu/ops/sparsity.py`).

The models declare `f_dep` (the (x, u) coordinates their dynamics read)
and `h_dep` (the x coordinates their constraints read); the plain lane
linearization (`ops/linearize_lanes.py`) and the K2 forms skip the other
tangents, substituting exact identity (state) and zero (control) Jacobian
columns.  This module checks those declarations: it probes
`torch.func.jacfwd` in float64 at a few generic random points and counts a
column as structurally zero only if it is exactly 0.0 at every sample (a
nonzero smooth term that vanishes at several generic points has measure
zero).  The samples are the JAX package's: the same counts, magnitude
tiers (0.1x / 1x / 10x the band [0.3, 1.7], random signs) and numpy seeds,
so both packages probe the same points.  A dependency gated on a region
that no probe reaches (a branch on |x| > 17) must be declared by hand.
"""

import functools

import numpy as np
import torch


def _probe(apply_jac, n_in, np_, samples, seed):
    """Union of the nonzero Jacobian columns over the random probes."""
    rng = np.random.default_rng(seed)
    dep = np.zeros(n_in, bool)
    scales = (0.1, 1.0, 10.0)
    for k in range(samples):
        scale = scales[k % len(scales)]
        z = torch.as_tensor(scale * rng.uniform(0.3, 1.7, n_in)
                            * rng.choice([-1.0, 1.0], n_in),
                            dtype=torch.float64)
        p = torch.as_tensor(rng.uniform(1.0, 30.0, np_) if np_
                            else np.zeros((0,)), dtype=torch.float64)
        J = apply_jac(z, p).detach().numpy()
        dep |= np.any(J != 0.0, axis=0)
    return tuple(int(i) for i in np.where(dep)[0])


@functools.lru_cache(maxsize=None)
def input_dependency(f, nx, nu, np_, samples=6, seed=0):
    """Indices of the (x, u) coordinates `f(x, u, p)` structurally depends
    on.  Skipped state columns of the discrete map's Jacobian are exact
    identity columns and skipped control columns exact zeros, so a
    linearization restricted to these indices equals the dense one
    bitwise."""
    jac = torch.func.jacfwd(
        lambda xu, p: torch.as_tensor(f(xu[:nx], xu[nx:], p)))
    return _probe(jac, nx + nu, np_, samples, seed)


@functools.lru_cache(maxsize=None)
def constraint_dependency(h, nx, np_, samples=6, seed=1):
    """Indices of the x coordinates `h(x, p)` structurally depends on
    (skipped columns of the constraint Jacobian are exact zeros)."""
    if h is None:
        return ()
    jac = torch.func.jacfwd(lambda x, p: torch.as_tensor(h(x, p)))
    return _probe(jac, nx, np_, samples, seed)
