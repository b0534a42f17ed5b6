"""The flagship node's guidance around the solve, in plain float64 torch:
the waypoint manager, the LiDAR intake, the packing of the OCP's initial
state, the command memory, and the plant that the fleet integrates.

Written from the reference node (catkin_ws/src/nmpc_ca/src/
nmpc_guidance_ca1.cpp: `waypoint_manager` :441-491, `obstaclesCallback`
:252-346, `control` :495-512 and :588-593) and the simulation's LiDAR
(obstacle_sim_node.py:55-81), with the repository's documented choices
(commit 36d742a): past the final waypoint the mission turns inactive and
commands u_d = 0; the 8 nearest buoys by surface distance (the radius
inflated by the boat's 0.5 m), ties to the lower index, empty slots at
(1000, 1000) with radius 0; the plant integrates the guidance kinematics
with 4 RK4 substeps of the 0.05 s tick and takes the commanded speed as
its surge (sim/fleet.py's perfect speed loop).
"""

import math

import torch

from port_bench.reference.precision import tf32
from port_bench.reference.qp import rk4
from port_bench.vendor.usv_models import flagship_f, wrap_once

CRUISE, CAPTURE, BOAT_R, SLOTS, SENTINEL, VISIBLE = 0.7, 1.0, 0.5, 8, \
    1000.0, 100.0
DT, PLANT_STEPS = 0.05, 4


def _segment(wp, k):
    """Start, end and angle of the segment (wp[k-1] -> wp[k])."""
    n = wp.shape[1]
    i1 = (k - 1).clamp(0, n - 1)
    i2 = k.clamp(0, n - 1)
    ar = torch.arange(wp.shape[0])
    p1, p2 = wp[ar, i1], wp[ar, i2]
    return p1, p2, torch.atan2(p2[:, 1] - p1[:, 1], p2[:, 0] - p1[:, 0])


def tick_inputs(g):
    """What one guidance tick hands the solver, from the tick's inputs
    `g`: float64 tensors (K,) u, v, nedx, nedy, psi, k, past_psied,
    active (0/1), n_wp, and waypoints (K, W, 2), field (K, M, 3), valid
    (K, M).  Returns x0 (K, 8), p_obs (K, 16), r_obs (K, 8), the new k,
    active and past_psied before the solve, u_d, and the margin between
    the 8th and 9th nearest keys (where it is within rounding, the two
    buoys may trade places)."""
    wp, k, active = g["waypoints"], g["k"].long(), g["active"] > 0
    p1, p2, ak = _segment(wp, k)
    dist = torch.hypot(p2[:, 0] - g["nedx"], p2[:, 1] - g["nedy"])
    captured = dist <= CAPTURE
    further = (k + 1) < g["n_wp"].long()
    advance = captured & further & active
    finish = captured & ~further & active
    k_new = torch.where(advance, k + 1, k)
    p1n, _, ak_new = _segment(wp, k_new)
    past = torch.where(advance,
                       wrap_once(g["past_psied"] - ak_new + ak),
                       g["past_psied"])
    active_new = active & ~finish
    ye = (-(g["nedx"] - p1n[:, 0]) * torch.sin(ak_new)
          + (g["nedy"] - p1n[:, 1]) * torch.cos(ak_new))
    # ---- LiDAR intake: the 8 nearest by surface distance ----
    f = g["field"]
    dx = f[..., 0] - g["nedx"][:, None]
    dy = f[..., 1] - g["nedy"][:, None]
    visible = (torch.hypot(dx, dy) < VISIBLE) & (g["valid"] > 0)
    r_infl = f[..., 2] + BOAT_R
    key = torch.where(visible, torch.hypot(dx, dy) - r_infl, math.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    sel = order[:, :SLOTS]
    take = lambda a: torch.gather(a, 1, sel)                  # noqa: E731
    ok = take(visible.double()) > 0
    ox = torch.where(ok, take(f[..., 0]), SENTINEL)
    oy = torch.where(ok, take(f[..., 1]), SENTINEL)
    r_obs = torch.where(ok, take(r_infl), 0.0)
    p_obs = torch.stack([ox, oy], -1).reshape(-1, 2 * SLOTS)
    ks = torch.gather(key, 1, order[:, :SLOTS + 1])
    margin = (ks[:, SLOTS] - ks[:, SLOTS - 1]).nan_to_num(math.inf)
    # ---- the OCP's initial state ----
    u = torch.where(g["u"] == 0.0, 0.001, g["u"])
    chie = wrap_once(g["psi"] + torch.atan2(g["v"], u) - ak_new)
    x0 = torch.stack([u, g["v"], ye, chie, past, g["nedx"], g["nedy"],
                      g["psi"]], -1)
    return dict(x0=x0, p_obs=p_obs, r_obs=r_obs, k=k_new.double(),
                active=active_new.double(), past=past,
                u_d=active_new.double() * CRUISE, margin=margin, ak=ak_new)


def plant(x0, u0):
    """The fleet's plant over one tick: (K, 8) state, (K,) command."""
    p = torch.zeros((x0.shape[0], 16), dtype=x0.dtype)
    return rk4(flagship_f, x0, u0[:, None], p, DT, PLANT_STEPS)


def _angle(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def readings(g, prog, control=False):
    """The largest gaps between the program's guidance and plant and this
    reference's (or, with `control`, this reference rounded to TF32):
    `guidance` (x0, the obstacle slots matched as a set, the command
    memory; angles wrapped), `plant` (the next measurements), and
    `mission` (segment index or activity differing: a count).
    `prog`: the program's x0, p_obs, r_obs, k, active, past_psied after
    the tick, u0, x1, and the next measurements u, v, nedx, nedy, psi."""
    ref = tick_inputs(g)
    x1 = prog["x1"]
    past_after = torch.where(ref["active"] > 0, x1[:, 4], ref["past"])
    nxt = plant(prog["x0"], prog["u0"])
    ref_meas = torch.stack([ref["u_d"], nxt[:, 1], nxt[:, 5], nxt[:, 6],
                            nxt[:, 7]], -1)
    if control:
        ref = {k: tf32(v) if k not in ("k", "active", "margin") else v
               for k, v in ref.items()}
        past_after, ref_meas = tf32(past_after), tf32(ref_meas)
    xd = (prog["x0"] - ref["x0"]).abs()
    for i in (3, 4, 7):                      # the angles
        xd[:, i] = _angle(prog["x0"][:, i] - ref["x0"][:, i]).abs()
    # the slots as a set: each of the program's slots against the nearest
    # of the reference's (a tie may order them otherwise)
    pp = prog["p_obs"].reshape(-1, SLOTS, 2)
    rp = ref["p_obs"].reshape(-1, SLOTS, 2)
    d = torch.cdist(pp, rp)
    j = d.argmin(-1)
    slot = torch.maximum(d.amin(-1), (torch.gather(ref["r_obs"], 1, j)
                                      - prog["r_obs"]).abs())
    slot = torch.where((ref["margin"] > 1e-4)[:, None], slot, 0.0)
    guidance = torch.stack([
        xd.amax(1), slot.amax(1),
        _angle(prog["past_psied"] - past_after).abs()], 1).amax(1)
    meas = torch.stack([prog[k] for k in ("u", "v", "nedx", "nedy", "psi")],
                       -1)
    plant_gap = (meas - ref_meas).abs().amax(1)
    mission = ((prog["k"] != ref["k"]) | (prog["active"] != ref["active"]))
    return dict(guidance=float(guidance.max()),
                plant=float(plant_gap.max()),
                mission=int(mission.sum()))
