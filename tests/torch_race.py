"""The race car's inputs for the tests of the port (this module imports
no JAX: tests/test_torch_cuda.py runs on the card, where there is none)."""

import numpy as np

from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.utils import track as trk

# the race OCPs and tracks whose ticks the tests hold: race_cars on the
# curved track, race_cars_dev on both
RACE_CASES = (("race_cars", True), ("race_cars_dev", True),
              ("race_cars_dev", False))


def race_spec(name, curved, **kw):
    """The builder's OCP on the synthetic curved track or the straight
    one."""
    return builders.build(
        name, track=trk.make_synthetic_track() if curved else None, **kw)


def race_point(N, L, seed, length=None):
    """(x (6, N, L), u (2, N, L), p (0, L)) of the race car: arc length s
    spread over [-1.5, 2.5] laps of `length` (the synthetic track's by
    default: negative s, the seam and the second lap are all visited) and
    exactly on table samples and the seam on lane 0, a lateral offset
    |n| < 0.2 (1 - kappa n stays above 0.45 on that track), heading error
    ~0.2 N(0, 1), speed 0.2-1.5 m/s, duty ~0.3 N(0, 1), steering ~0.2
    N(0, 1); rates ~N(0, 1)."""
    if length is None:
        length = trk.make_synthetic_track().length
    rng = np.random.default_rng(seed)
    x = np.empty((6, N, L))
    x[0] = rng.uniform(-1.5, 2.5, size=(N, L)) * length
    x[0, :, 0] = np.arange(N) * length / 512 * 37 - length
    x[1] = rng.uniform(-0.2, 0.2, size=(N, L))
    x[2] = rng.normal(size=(N, L)) * 0.2
    x[3] = rng.uniform(0.2, 1.5, size=(N, L))
    x[4] = rng.normal(size=(N, L)) * 0.3
    x[5] = rng.normal(size=(N, L)) * 0.2
    u = rng.normal(size=(2, N, L))
    return x, u, np.zeros((0, L))
