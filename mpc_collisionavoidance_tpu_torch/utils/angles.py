"""Angle helpers shared by the guidance nodes and the simulations
(counterpart of `mpc_collisionavoidance_tpu/utils/angles.py`).

The reference wraps angles with the idiom
``if |a| > pi: a = sign(a) * (|a| - 2*pi)`` (e.g. reference
src/nmpc_guidance_ca1.cpp:497-501, 588-592).  That idiom is exactly a wrap
to (-pi, pi] for inputs in (-3*pi, 3*pi); both the reference idiom and a
total wrap are provided.  Both keep the shape and dtype of `a`.
"""

import math

import torch


def wrap_once(a):
    """One-shot wrap as written in the reference C++ nodes.

    Mirrors ``if (fabs(a) > M_PI) a = (a/fabs(a)) * (fabs(a) - 2*M_PI)``
    (reference src/nmpc_guidance_ca1.cpp:497-501).  Only correct for
    |a| < 3*pi, like the original.
    """
    return torch.where(a.abs() > math.pi,
                       torch.sign(a) * (a.abs() - 2.0 * math.pi), a)


def ssa(a):
    """Smallest signed angle: total wrap of `a` into [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi
