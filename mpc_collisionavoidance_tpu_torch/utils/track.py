"""Race-track geometry: synthetic closed tracks, a torch curvature
interpolant, and the Frenet <-> Cartesian transforms (counterpart of
`mpc_collisionavoidance_tpu/utils/track.py`).

The reference race-car example builds a CasADi bspline curvature
interpolant ``kapparef_s`` that appears inside the dynamics (reference
scripts/race_cars/bycicle_model.py:46-55).  `Track` and
`make_synthetic_track` are numpy copies of the JAX package's, giving the
same arrays bit for bit; `_interp_periodic` is its periodic Catmull-Rom
in torch, with the same operations in the same order, so that
`torch.func.jvp` differentiates it as `jax.linearize` does (the lap count
and the sample index carry no tangent).  The CUDA form of the same
interpolant is `csrc/models/race_cars.cuh`, which reads the `kapparef`
table that the race-car model carries (`models/variants.py::race_cars`).
"""

from typing import NamedTuple

import numpy as np
import torch


class Track(NamedTuple):
    """Uniform arc-length track table (the content of the reference's
    getTrack(): [s0, xref, yref, psiref, kapparef])."""

    s0: np.ndarray        # (M,) arc length, s0[0] = 0, uniform spacing
    xref: np.ndarray      # (M,) centerline x
    yref: np.ndarray      # (M,) centerline y
    psiref: np.ndarray    # (M,) centerline heading, UNWRAPPED (+2*pi/lap)
    kapparef: np.ndarray  # (M,) signed curvature
    length: float         # total path length (s of closing point)


def make_synthetic_track(n_samples: int = 512, radius: float = 0.45,
                         straight: float = 1.6,
                         chicane_amp: float = 0.35) -> Track:
    """Closed LMS-scale circuit: two straights + two U-turns, with a
    sinusoidal curvature chicane superposed on the straights so kappa is
    smooth, sign-changing, and non-trivial everywhere (path length ~= the
    upstream LMS track's 8.71 m).

    Built by integrating psi' = kappa(s) over uniform ds and then closing
    the loop exactly (subtracting the linear drift in x, y, psi), so the
    table is consistent: x' = cos psi, y' = sin psi, psi' = kappa.
    """
    a, R = straight, radius
    L = 2 * a + 2 * np.pi * R
    s = np.linspace(0.0, L, n_samples, endpoint=False)
    ds = L / n_samples

    def base_kappa(si):
        si = np.mod(si, L)
        in_turn1 = (si >= a) & (si < a + np.pi * R)
        in_turn2 = si >= 2 * a + np.pi * R
        turn = (in_turn1 | in_turn2).astype(float) / R
        # chicane: one full sine period per straight, zero at the ends
        t1 = np.clip(si / a, 0, 1)
        t2 = np.clip((si - a - np.pi * R) / a, 0, 1)
        chic = (np.sin(2 * np.pi * t1) * ((si < a).astype(float))
                + np.sin(2 * np.pi * t2)
                * (((si >= a + np.pi * R) & (si < 2 * a + np.pi * R))
                   .astype(float)))
        return turn + chicane_amp * chic

    kappa = base_kappa(s)
    # integrate heading/position, then close the loop exactly
    psi = np.concatenate([[0.0], np.cumsum(kappa)[:-1]]) * ds
    psi_end = psi[-1] + kappa[-1] * ds
    # heading must advance exactly 2*pi per lap: spread the correction
    psi = psi + (2 * np.pi - psi_end) * s / L
    kappa = np.gradient(psi, ds)          # consistent kappa after closure
    x = np.concatenate([[0.0], np.cumsum(np.cos(psi))[:-1]]) * ds
    y = np.concatenate([[0.0], np.cumsum(np.sin(psi))[:-1]]) * ds
    # remove residual endpoint drift so the loop closes in position too
    x_end = x[-1] + np.cos(psi[-1]) * ds
    y_end = y[-1] + np.sin(psi[-1]) * ds
    x = x - x_end * s / L
    y = y - y_end * s / L

    return Track(s0=s, xref=x, yref=y, psiref=psi, kapparef=kappa,
                 length=float(L))


# ---------------------------------------------------------------------------
# periodic Catmull-Rom interpolation on the uniform table (elementwise over
# any batch shape, usable inside the lane dynamics and under torch.func.jvp)

def _interp_periodic(table, s, length, wrap_per_lap=0.0):
    """Catmull-Rom interpolation of a uniform periodic table at arc s.

    `wrap_per_lap` is added per completed lap (2*pi for psiref, 0 for
    x/y/kappa) so unwrapped quantities stay continuous across the seam.
    """
    s = torch.as_tensor(s)
    tab = torch.as_tensor(table, dtype=s.dtype, device=s.device)
    M = tab.shape[0]
    laps = torch.floor(s / length)
    sm = s - laps * length
    t = sm / length * M
    # truncation toward zero, as an int32 cast; the index has no tangent
    i1 = torch.clamp(t.detach().to(torch.int64), 0, M - 1)
    frac = t - i1.to(s.dtype)
    i0 = torch.remainder(i1 - 1, M)
    i2 = torch.remainder(i1 + 1, M)
    i3 = torch.remainder(i1 + 2, M)
    # seam correction for unwrapped tables (psi jumps by wrap_per_lap)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    wrap = torch.full((), wrap_per_lap, dtype=s.dtype, device=s.device)
    p0 = tab[i0] - torch.where(i1 == 0, wrap, zero)
    p1 = tab[i1]
    p2 = tab[i2] + torch.where(i2 == 0, wrap, zero)
    p3 = tab[i3] + torch.where(i3 <= 1, wrap, zero)
    f2 = frac * frac
    f3 = f2 * frac
    out = 0.5 * ((2 * p1) + (-p0 + p2) * frac
                 + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f2
                 + (-p0 + 3 * p1 - 3 * p2 + p3) * f3)
    return out + laps * wrap_per_lap


def make_kappa_fn(track: Track):
    """Curvature interpolant kappa(s) for use inside model dynamics (the
    reference's CasADi ``kapparef_s`` bspline, bycicle_model.py:55)."""

    def kappa_fn(s):
        return _interp_periodic(track.kapparef, s, track.length)

    return kappa_fn


# ---------------------------------------------------------------------------
# Frenet <-> Cartesian (reference time2spatial.py:40-99)

def transform_proj2orig(track: Track, s, n, alpha=0.0, v=0.0):
    """(s, n, alpha, v) -> (x, y, psi, v): offset the centerline point at
    arc s by n along its left normal (reference transformProj2Orig
    conventions: x = x0 - n sin psi0, y = y0 + n cos psi0)."""
    s = torch.as_tensor(s)
    x0 = _interp_periodic(track.xref, s, track.length)
    y0 = _interp_periodic(track.yref, s, track.length)
    psi0 = _interp_periodic(track.psiref, s, track.length,
                            wrap_per_lap=2 * np.pi)
    x = x0 - n * torch.sin(psi0)
    y = y0 + n * torch.cos(psi0)
    return x, y, psi0 + alpha, v


def transform_orig2proj(track: Track, x, y, psi, v=0.0):
    """(x, y, psi, v) -> (s, n, alpha, v) for one point: project onto the
    centerline by the nearest sample followed by one local linearized
    refinement (the reference does two-point inverse interpolation over
    its table, time2spatial.py:73-99)."""
    x, y, psi = (torch.as_tensor(a, dtype=torch.float64)
                 for a in (x, y, psi))
    xr = torch.as_tensor(track.xref, dtype=x.dtype)
    yr = torch.as_tensor(track.yref, dtype=x.dtype)
    d2 = (x - xr) ** 2 + (y - yr) ** 2
    i = torch.argmin(d2)
    s_i = torch.as_tensor(track.s0, dtype=x.dtype)[i]
    psi_i = torch.as_tensor(track.psiref, dtype=x.dtype)[i]
    # refine: tangential offset of (x, y) from the nearest sample
    dt = ((x - xr[i]) * torch.cos(psi_i) + (y - yr[i]) * torch.sin(psi_i))
    s_star = s_i + dt
    x0 = _interp_periodic(track.xref, s_star, track.length)
    y0 = _interp_periodic(track.yref, s_star, track.length)
    psi0 = _interp_periodic(track.psiref, s_star, track.length,
                            wrap_per_lap=2 * np.pi)
    nval = -(x - x0) * torch.sin(psi0) + (y - y0) * torch.cos(psi0)
    alpha = torch.remainder(psi - psi0 + np.pi, 2 * np.pi) - np.pi
    return torch.remainder(s_star, track.length), nval, alpha, v
