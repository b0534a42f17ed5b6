"""Path-frame (Frenet) transforms for polyline missions (counterpart of
`mpc_collisionavoidance_tpu/utils/frenet.py`).

The reference carries `time2spatial.py` in every variant directory
(transformProj2Orig / transformOrig2Proj, reference
scripts/usv_guidance_ca1/time2spatial.py:40-58) — race-track leftovers
that load a gitignored spline and are unused by the USV variants, whose
actual path frame is the straight waypoint segment (x1, y1, ak) with
cross-track error ye (reference src/nmpc_guidance_ca1.cpp:457-458).
These helpers provide that information content for polyline paths, as
total functions on tensors that run under `torch.vmap`:

- `seg_to_xy` / `xy_to_seg`: single-segment (s, ye) <-> NED, the exact
  frame the guidance OCPs are written in;
- `polyline_project`: project a point onto an entire waypoint polyline ->
  (segment index, arc length s, cross-track ye), fixed-shape over a padded
  waypoint table.
"""

import torch


def _angle(ak):
    """`ak` as a tensor; a Python number as float64 (a 0-d tensor takes
    the dtype of the tensors it meets)."""
    if isinstance(ak, torch.Tensor):
        return ak
    return torch.tensor(ak, dtype=torch.float64)


def seg_to_xy(x1, y1, ak, s, ye):
    """Segment frame -> NED: start (x1, y1), heading ak, arc s, offset ye.

    Matches the reference's ye sign convention
    ye = -(x - x1) sin(ak) + (y - y1) cos(ak)."""
    ak = _angle(ak)
    x = x1 + s * torch.cos(ak) - ye * torch.sin(ak)
    y = y1 + s * torch.sin(ak) + ye * torch.cos(ak)
    return x, y


def xy_to_seg(x1, y1, ak, x, y):
    """NED -> segment frame (s, ye)."""
    ak = _angle(ak)
    dx, dy = x - x1, y - y1
    s = dx * torch.cos(ak) + dy * torch.sin(ak)
    ye = -dx * torch.sin(ak) + dy * torch.cos(ak)
    return s, ye


def polyline_project(waypoints, n_wp, x, y):
    """Project (x, y) onto the polyline waypoints[:n_wp].

    waypoints: (M, 2) padded table. Returns (k, s_total, ye):
    k = segment index of the closest point (the first of equal distances,
    as `jnp.argmin`), s_total = arc length from the first waypoint to the
    projection, ye = signed cross-track error in that segment's frame.
    Fixed-shape: invalid segments are masked out.  Every index is a
    gather, so a batched `k` under `torch.vmap` stays batched.
    """
    wp = torch.as_tensor(waypoints)
    M = wp.shape[0]
    p1 = wp[:-1]                      # (M-1, 2)
    p2 = wp[1:]
    seg = p2 - p1
    seg_len = torch.hypot(seg[:, 0], seg[:, 1])
    ak = torch.atan2(seg[:, 1], seg[:, 0])
    n_wp = torch.as_tensor(n_wp, device=wp.device)
    valid = (torch.arange(M - 1, device=wp.device) < (n_wp - 1)) \
        & (seg_len > 0)

    dx = x - p1[:, 0]
    dy = y - p1[:, 1]
    s = dx * torch.cos(ak) + dy * torch.sin(ak)
    s_clamped = torch.minimum(torch.clamp(s, min=0.0), seg_len)
    ye = -dx * torch.sin(ak) + dy * torch.cos(ak)
    px = p1[:, 0] + s_clamped * torch.cos(ak)
    py = p1[:, 1] + s_clamped * torch.sin(ak)
    dist = torch.hypot(x - px, y - py)
    dist = torch.where(valid, dist, torch.inf)

    k = torch.argmin(dist, dim=-1, keepdim=True)
    cum = torch.cat([seg_len.new_zeros((1,)),
                     torch.cumsum(torch.where(valid, seg_len, 0.0), 0)])

    def at(a):
        return torch.gather(a, -1, k)[..., 0]

    return k[..., 0], at(cum[:-1]) + at(s_clamped), at(ye)
