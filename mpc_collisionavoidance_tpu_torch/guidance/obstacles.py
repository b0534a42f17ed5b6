"""Obstacle perception intake: fixed-shape top-8 selection (counterpart of
`mpc_collisionavoidance_tpu/guidance/obstacles.py`).

Re-implements two reference components as tensor code:

- the fake-LiDAR visibility model of the simulation package
  (reference catkin_ws/src/simulation/scripts/obstacle_sim_node.py:55-81):
  cull the world obstacle field to a 100 m visibility radius around the
  vehicle and express survivors in the body frame;
- the flagship node's `obstaclesCallback` intake (reference
  catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp:252-346): inflate each
  radius by the boat radius, keep the 8 closest by surface distance
  sqrt(x^2+y^2) - r_inflated (std::sort in `sortVec` :422-438), transform
  back to NED (`body2NED` :348-363), flag collisions (distance < inflated
  radius -> ROS_WARN :321-326), and pad unused solver slots with the
  far-away sentinel (`initializeObstacles` :365-376).

The world field is a fixed-capacity (..., M, 3) table (X, Y, R) plus a
validity mask.  The selection is a stable ascending sort of the surface
distance, first `n_slots` taken: among equal keys the lower index comes
first, which is the order `jax.lax.top_k` gives.  Equal keys are real
(every invisible row has key FAR; symmetric buoy fields tie), and
`torch.topk` promises no order among them, so it would permute the QP's
rows.  Batch-polymorphic: the vehicle pose may carry leading batch axes
(..., ), and the field is shared, (M, 3), or per vehicle, (..., M, 3).
"""

from typing import NamedTuple

import torch

BOAT_RADIUS = 0.5       # reference nmpc_guidance_ca1.cpp:139
N_SLOTS = 8             # obs_num_, :140
SENTINEL_POS = 1000.0   # init_obs_pos_, :141 (sim/scenarios.py's is 100.0)
VISIBLE_RADIUS = 100.0  # obstacle_sim_node.py:43
FAR = 1e9               # masked-lane distance key


class ObstacleSlots(NamedTuple):
    """What the solver consumes each tick (reference control() :539-565)."""
    p_obs: torch.Tensor      # (..., 2*N_SLOTS) NED centers, sentinel-padded
    r_obs: torch.Tensor      # (..., N_SLOTS) inflated radii (runtime `lh`)
    collision: torch.Tensor  # (..., N_SLOTS) bool: inside inflated radius
    n_visible: torch.Tensor  # (...) int32 visible count before truncation


def lidar_scan(field, field_valid, nedx, nedy, psi):
    """World field -> body-frame detections with visibility culling.

    field: (M, 3) or (..., M, 3) NED (X, Y, R); field_valid: (M,) or
    (..., M) bool; the pose (...).  Returns (body_xy (..., M, 2),
    radius (..., M), visible (..., M) bool).  Mirrors
    obstacle_sim_node.simulate + ned_to_body (reference
    obstacle_sim_node.py:55-81,100-115).
    """
    nedx, nedy, psi = nedx[..., None], nedy[..., None], psi[..., None]
    dx = field[..., 0] - nedx
    dy = field[..., 1] - nedy
    visible = (torch.hypot(dx, dy) < VISIBLE_RADIUS) & field_valid
    c, s = torch.cos(psi), torch.sin(psi)
    bx = c * dx + s * dy      # R(psi)^T [dx, dy]
    by = -s * dx + c * dy
    return (torch.stack([bx, by], dim=-1),
            torch.broadcast_to(field[..., 2], visible.shape), visible)


def intake(body_xy, radius, visible, nedx, nedy, psi,
           boat_radius: float = BOAT_RADIUS,
           n_slots: int = N_SLOTS) -> ObstacleSlots:
    """Body-frame detections -> fixed solver slots (closest-first, padded).

    body_xy: (..., M, 2), radius: (..., M), visible: (..., M) bool.
    """
    r_infl = radius + boat_radius
    center_dist = torch.hypot(body_xy[..., 0], body_xy[..., 1])
    # surface distance used as the sort key (reference :267-269)
    key = torch.where(visible, center_dist - r_infl, FAR)

    # the n_slots smallest keys, ties to the lower index (see docstring)
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :n_slots]

    def take(a):
        return torch.take_along_dim(a, idx, dim=-1)

    sel_valid = take(visible)
    sx, sy = take(body_xy[..., 0]), take(body_xy[..., 1])
    sel_r = torch.where(sel_valid, take(r_infl), 0.0)

    # body -> NED (reference body2NED :348-363)
    nedx, nedy, psi = nedx[..., None], nedy[..., None], psi[..., None]
    c, s = torch.cos(psi), torch.sin(psi)
    ox = c * sx - s * sy + nedx
    oy = s * sx + c * sy + nedy
    ox = torch.where(sel_valid, ox, SENTINEL_POS)
    oy = torch.where(sel_valid, oy, SENTINEL_POS)

    collision = sel_valid & (take(center_dist) < take(r_infl))
    p_obs = torch.stack([ox, oy], dim=-1).flatten(-2)
    return ObstacleSlots(
        p_obs=p_obs,
        r_obs=sel_r,
        collision=collision,
        n_visible=visible.sum(dim=-1, dtype=torch.int32),
    )


def perceive(field, field_valid, nedx, nedy, psi,
             boat_radius: float = BOAT_RADIUS,
             n_slots: int = N_SLOTS) -> ObstacleSlots:
    """Full perception pipeline: world field -> solver slots."""
    body_xy, radius, visible = lidar_scan(field, field_valid, nedx, nedy, psi)
    return intake(body_xy, radius, visible, nedx, nedy, psi,
                  boat_radius=boat_radius, n_slots=n_slots)
