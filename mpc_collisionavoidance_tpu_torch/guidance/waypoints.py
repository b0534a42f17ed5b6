"""Waypoint-manager mission state machine (counterpart of
`mpc_collisionavoidance_tpu/guidance/waypoints.py`).

Re-implements the behavior of the reference node's `waypoint_manager()`
(reference catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp:441-491) and the
mission (re)seed logic of its main loop (same file :615-632) as
branch-free tensor code:

- waypoints are a fixed-capacity (..., MAX_WP, 2) table plus a live count
  `n_wp` (the analog of the variable-length Float32MultiArray topic);
- the current segment index ``k`` (reference member ``k``, segments are
  (wp[k-1] -> wp[k])), the carried heading-error command memory
  ``past_psied`` (reference :593) and mission activity are an explicit
  `MissionState` carry;
- segment advance happens when the distance to the segment end drops below
  1 m (reference :449-452,467-469); on advance the carried heading error is
  re-projected into the new segment frame, past_psied += ak_old - ak_new,
  wrapped (reference :478-484);
- deviation from the reference: advancing past the FINAL waypoint flips the
  mission inactive instead of reading one segment past the table (the C++
  indexes `last_waypoints[2k+1]` beyond the vector on the last advance —
  undefined behavior not reproduced).  Inactive missions command
  u_d = 0 (reference :487-490).

Batch-polymorphic: every field may carry leading batch axes (one vehicle
has none, a fleet has (B,)), so one function serves both where the JAX
package uses `vmap`.  `k` is int32 and `active` bool; the device and
dtype are the waypoint table's.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.utils.angles import wrap_once

CRUISE_SPEED = 0.7       # d_speed while active (reference :452)
WP_CAPTURE_RADIUS = 1.0  # segment-advance distance (reference :455)


class MissionState(NamedTuple):
    k: torch.Tensor           # (...) int32 segment index, wp[k-1] -> wp[k]
    past_psied: torch.Tensor  # (...) carried psi_e_d command memory (:593)
    active: torch.Tensor      # (...) bool; False once the final wp is reached


class SegmentFrame(NamedTuple):
    """Path frame handed to the controller (reference control() args :493)."""
    x1: torch.Tensor      # segment start
    y1: torch.Tensor
    ak: torch.Tensor      # segment angle atan2(y2-y1, x2-x1) (reference :451)
    ye: torch.Tensor      # cross-track error (reference :457-458)
    target: torch.Tensor  # (..., 2) segment end waypoint (published, :453)
    u_d: torch.Tensor     # commanded surge speed (0.7 active / 0.0 done)
    advanced: torch.Tensor  # bool: segment switch happened this tick


def _waypoint(wp, k):
    """wp[..., k, :] for a (...) index tensor (a table shared by a batch
    broadcasts), k clamped into the table (jnp's gather clips an index
    past the table; torch's would raise)."""
    batch = torch.broadcast_shapes(k.shape, wp.shape[:-2])
    idx = k.long().clamp(0, wp.shape[-2] - 1).expand(batch)
    return torch.take_along_dim(wp.expand(batch + wp.shape[-2:]),
                                idx[..., None, None].expand(batch + (1, 2)),
                                dim=-2).squeeze(-2)


def _segment(wp, k):
    """Segment (wp[k-1] -> wp[k]) start, end and angle."""
    p1 = _waypoint(wp, k - 1)
    p2 = _waypoint(wp, k)
    ak = torch.atan2(p2[..., 1] - p1[..., 1], p2[..., 0] - p1[..., 0])
    return p1, p2, ak


def mission_init(waypoints, n_wp, psi) -> MissionState:
    """Seed a mission the way the node reacts to a NEW waypoint list
    (reference :616-632): k = 1 and past_psied = wrap(psi - ak_first).
    `waypoints` (..., MAX_WP, 2) is a tensor whose device and dtype the
    state takes (the JAX function's `dtype` argument is dropped)."""
    wp = waypoints
    ak0 = torch.atan2(wp[..., 1, 1] - wp[..., 0, 1],
                      wp[..., 1, 0] - wp[..., 0, 0])
    n_wp = torch.as_tensor(n_wp, dtype=torch.int32, device=wp.device)
    psi = torch.as_tensor(psi, dtype=wp.dtype, device=wp.device)
    past_psied = wrap_once(psi - ak0)
    return MissionState(
        k=torch.ones(past_psied.shape, dtype=torch.int32, device=wp.device),
        past_psied=past_psied,
        active=torch.broadcast_to(n_wp >= 2, past_psied.shape),
    )


def waypoint_manager(state: MissionState, waypoints, n_wp, nedx, nedy):
    """One mission-manager tick. Returns (new_state, SegmentFrame).

    All branches are `torch.where` selections: the solver downstream always
    runs; inactive missions just mask the commands (the branch-free
    replacement for the node's early return, :486-490).
    """
    wp = waypoints
    n_wp = torch.as_tensor(n_wp, dtype=torch.int32, device=wp.device)
    k = state.k

    p1, p2, ak = _segment(wp, k)
    dist = torch.hypot(p2[..., 0] - nedx, p2[..., 1] - nedy)

    # advance only while a further segment exists (see module docstring)
    can_advance = (k + 1) < n_wp
    captured = dist <= WP_CAPTURE_RADIUS
    advance = captured & can_advance & state.active
    finish = captured & ~can_advance & state.active

    k_new = torch.where(advance, k + 1, k)
    p1n, p2n, ak_new = _segment(wp, k_new)
    # heading-error re-projection across the segment switch (reference
    # :478-484)
    past_psied = torch.where(
        advance, wrap_once(state.past_psied - ak_new + ak), state.past_psied)

    active = state.active & ~finish
    ye = (-(nedx - p1n[..., 0]) * torch.sin(ak_new)
          + (nedy - p1n[..., 1]) * torch.cos(ak_new))

    frame = SegmentFrame(
        x1=p1n[..., 0], y1=p1n[..., 1], ak=ak_new, ye=ye,
        target=p2n,
        u_d=active.to(wp.dtype) * CRUISE_SPEED,
        advanced=advance,
    )
    return MissionState(k=k_new, past_psied=past_psied, active=active), frame
