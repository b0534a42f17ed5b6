"""Scenario library (copy of the flagship, hydrodynamic-family and
kinematic-guidance parts of `mpc_collisionavoidance_tpu/sim/scenarios.py`,
pure numpy).

`guidance_ca1_default` reproduces the flagship closed-loop experiment of
reference scripts/usv_guidance_ca1/main.py:73-113: a straight 30 m path
x = 4 from (4,-5) to (4,25), four r = 1.5 obstacles sitting ON the path at
(4,4), (4,7), (4,12), (4,20), vehicle starting at the origin with u = 0.7,
4 m of initial cross-track error.  Sentinel obstacles live at (100, 100)
with radius 0 (reference acados_settings.py:185, main.py:76-77).
`pf_ca_default` is the 14-state hull's experiment (reference
scripts/usv_pf_ca/main.py:73-133); `pf_default`, `low_level_default`,
`acados_speed_default` and `position_control_default` are those of the
obstacle-free models of the same family, each with its own references.
`guidance_ca_default` is the hard-row guidance model's buoy run (reference
scripts/usv_guidance_ca/main.py), `guidance_default` and
`guidance2_default`..`guidance5_default` the obstacle-free guidance
models' segment-following runs.

`race_cars_default` and `race_cars_dev_default` are the port's own: the
JAX package has no race scenario, so they are built from its race recipe
(the model's x0 rolling at v = 0.5, tests/test_lane_engine.py:197-200, on
the synthetic curved track, cli.py:185-186, with the builder's
reference).  They carry their `track`, which the OCP is built with.
"""

import dataclasses

import numpy as np

from mpc_collisionavoidance_tpu_torch.utils import track as trk

SENTINEL_POS = 100.0  # "far away" obstacle placeholder (reference main.py:76)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    x0: np.ndarray          # initial OCP state
    params: np.ndarray      # flat obstacle table (ox1,oy1,...)
    lh: np.ndarray          # runtime lower bounds (obstacle radii)
    n_steps: int
    ak: float               # path segment angle
    waypoints: np.ndarray   # (n_wp, 2) for guidance-level sims
    yref: np.ndarray = None    # runtime stage reference (None = builder's)
    yref_e: np.ndarray = None
    track: trk.Track = None    # the race track (None: not a race)


def guidance_ca1_default(n_steps: int = 1000) -> Scenario:
    obsx = np.array([4.0, 4.0, 4.0, 4.0])
    obsy = np.array([4.0, 7.0, 12.0, 20.0])
    radius = np.array([1.5, 1.5, 1.5, 1.5, 0, 0, 0, 0])
    pobs = np.full(16, SENTINEL_POS)
    robs = np.zeros(8)
    for i in range(4):
        pobs[2 * i] = obsx[i]
        pobs[2 * i + 1] = obsy[i]
        robs[i] = radius[i]

    x1, y1, x2, y2 = 4.0, -5.0, 4.0, 25.0
    ak = np.arctan2(y2 - y1, x2 - x1)
    nedx = nedy = 0.0
    psi, u, v = 0.0, 0.7, 0.0
    ye = -(nedx - x1) * np.sin(ak) + (nedy - y1) * np.cos(ak)
    psie = psi - ak
    x0 = np.array([u, v, ye, psie, psie, nedx, nedy, psi])
    return Scenario(
        name="guidance_ca1_default",
        x0=x0, params=pobs, lh=robs, n_steps=n_steps, ak=float(ak),
        waypoints=np.array([[x1, y1], [x2, y2]]),
    )


def guidance_ca_default(n_steps: int = 1000) -> Scenario:
    """reference scripts/usv_guidance_ca/main.py:73-122: obstacles slightly
    off-path, radius 0.5 with the runtime lh pushed as radius + 0.2
    (main.py:122) — these rows are HARD (no slack band)."""
    obsx = np.array([3.0, 4.0, 3.7, 4.4])
    obsy = np.array([3.0, 8.0, 16.0, 20.0])
    radius = np.full(8, 0.0)
    radius[:4] = 0.5 + 0.2
    pobs = np.full(16, SENTINEL_POS)
    robs = np.zeros(8)
    for i in range(4):
        pobs[2 * i] = obsx[i]
        pobs[2 * i + 1] = obsy[i]
        robs[i] = radius[i]
    x1, y1, x2, y2 = 4.0, -5.0, 4.0, 25.0
    ak = np.arctan2(y2 - y1, x2 - x1)
    ye = -(0.0 - x1) * np.sin(ak) + (0.0 - y1) * np.cos(ak)
    psie = 0.0 - ak
    x0 = np.array([0.7, 0.0, ye, psie, psie, 0.0, 0.0, 0.0, 0.0])
    return Scenario("guidance_ca_default", x0, pobs, robs, n_steps, float(ak),
                    np.array([[x1, y1], [x2, y2]]))


def pf_ca_default(n_steps: int = 4000) -> Scenario:
    """reference scripts/usv_pf_ca/main.py:73-116: 4 obstacles of radius 0.5
    near the x = 4 path, 14-state hydrodynamic model (T = 40 s, N/Tf = 100)."""
    obsx = np.array([3.0, 4.0, 3.7, 4.2])
    obsy = np.array([2.0, 8.0, 16.0, 20.0])
    pobs = np.concatenate([np.stack([obsx, obsy], axis=1).ravel()])
    robs = np.full(4, 0.5)
    x1, y1, x2, y2 = 4.0, -5.0, 4.0, 25.0
    ak = np.arctan2(y2 - y1, x2 - x1)
    nedx = nedy = 0.0
    ye = -(nedx - x1) * np.sin(ak) + (nedy - y1) * np.cos(ak)
    psi = 0.0
    x0 = np.array([psi, np.sin(psi), np.cos(psi), 0.001, 0.0, 0.0, ye,
                   x1, y1, ak, nedx, nedy, 0.0, 0.0])
    # runtime references the reference sim pushes every tick (reference
    # scripts/usv_pf_ca/main.py:113-133): head along the segment at 0.7 m/s
    yref = np.zeros(16)
    yref[1], yref[2], yref[3] = np.sin(ak), np.cos(ak), 0.7
    return Scenario("pf_ca_default", x0, pobs, robs, n_steps, float(ak),
                    np.array([[x1, y1], [x2, y2]]),
                    yref=yref, yref_e=yref[:14])


def acados_speed_default(n_steps: int = 400) -> Scenario:
    """usv_acados velocity/thrust experiment: track u_ref = 1.3 m/s from
    rest (reference scripts/usv_acados/main.py:73,81: yref = (uref, 0...));
    the in-repo C++ node uses u_des = 1.0 (src/acados_mpc.cpp:127)."""
    uref = 1.3
    yref = np.zeros(7)
    yref[0] = uref
    x0 = np.array([0.001, 0.0, 0.0, 0.0, 0.0])
    return Scenario("acados_speed_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, 0.0, np.zeros((0, 2)),
                    yref=yref, yref_e=yref[:5])


def low_level_default(n_steps: int = 1000) -> Scenario:
    """usv_low_level inner-loop experiment (reference
    scripts/usv_low_level/main.py:78-102): step to psi_ref = 1.0 rad and
    u_ref = 0.8 m/s from rest; yref = (0, sin psi_ref, cos psi_ref,
    u_ref, 0...)."""
    psi_ref, u_ref = 1.0, 0.8
    x0 = np.array([0.0, 0.0, 1.0, 0.001, 0.0, 0.0, 0.0, 0.0])
    yref = np.zeros(10)
    yref[1], yref[2], yref[3] = np.sin(psi_ref), np.cos(psi_ref), u_ref
    return Scenario("low_level_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, 0.0, np.zeros((0, 2)),
                    yref=yref, yref_e=yref[:8])


def position_control_default(n_steps: int = 200) -> Scenario:
    """usv_position_control experiment (reference
    scripts/usv_position_control/main.py:73-85): drive to (x, y) = (5, 1)
    with uref = 1.0 in the cost; starts at the model's 0.001 defaults."""
    x_ref, y_ref, uref = 5.0, 1.0, 1.0
    x0 = np.full(8, 0.001)
    yref = np.zeros(10)
    yref[0], yref[1], yref[3] = x_ref, y_ref, uref
    return Scenario("position_control_default", x0, np.zeros(0),
                    np.zeros(0), n_steps, 0.0, np.zeros((0, 2)),
                    yref=yref, yref_e=yref[:8])


def _segment_frame(x1, y1, x2, y2, nedx=0.0, nedy=0.0):
    ak = float(np.arctan2(y2 - y1, x2 - x1))
    ye = float(-(nedx - x1) * np.sin(ak) + (nedy - y1) * np.cos(ak))
    return ak, ye


def guidance_default(n_steps: int = 2000) -> Scenario:
    """usv_guidance kinematic guidance experiment (reference
    scripts/usv_guidance/main.py:87-120): u = 0.5, segment
    (3,-5) -> (10,5), yref heads along the segment (sin ak, cos ak)."""
    ak, ye = _segment_frame(3.0, -5.0, 10.0, 5.0)
    x0 = np.array([0, 0, 0, 0, 1.0, 0.5, 0, ye, ak, 0.0])
    yref = np.zeros(11)
    yref[3], yref[4] = np.sin(ak), np.cos(ak)
    return Scenario("guidance_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, ak, np.array([[3.0, -5.0], [10.0, 5.0]]),
                    yref=yref, yref_e=yref[:10])


def guidance2_default(n_steps: int = 2000) -> Scenario:
    """usv_guidance2 (reference scripts/usv_guidance2/main.py:86-126):
    adds yaw-rate states r, rd; same segment and references."""
    ak, ye = _segment_frame(3.0, -5.0, 10.0, 5.0)
    x0 = np.array([0, 0, 0, 0, 1.0, 0.5, 0, 0, ye, ak, 0.0, 0.0])
    yref = np.zeros(13)
    yref[3], yref[4] = np.sin(ak), np.cos(ak)
    return Scenario("guidance2_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, ak, np.array([[3.0, -5.0], [10.0, 5.0]]),
                    yref=yref, yref_e=yref[:12])


def guidance3_default(n_steps: int = 2000) -> Scenario:
    """usv_guidance3 course-angle variant (reference
    scripts/usv_guidance3/main.py:89-132): segment (4,-5) -> (4,25),
    u = 0.5, u_ref = 0.7 in the reference vector."""
    ak, ye = _segment_frame(4.0, -5.0, 4.0, 25.0)
    x0 = np.array([0, 0, 0, 0, 1.0, 0.5, 0, 0, ye, ak, 0.0])
    yref = np.zeros(12)
    yref[3], yref[4], yref[5] = np.sin(ak), np.cos(ak), 0.7
    return Scenario("guidance3_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, ak, np.array([[4.0, -5.0], [4.0, 25.0]]),
                    yref=yref, yref_e=yref[:11])


def guidance4_default(n_steps: int = 3000) -> Scenario:
    """usv_guidance4 minimal error model (reference
    scripts/usv_guidance4/main.py:89-103): u = 0.7, segment
    (4,-5) -> (4,25), all-zero references (drive ye, chie -> 0)."""
    ak, ye = _segment_frame(4.0, -5.0, 4.0, 25.0)
    psie = 0.0 - ak
    x0 = np.array([0.7, 0.0, ye, psie])
    return Scenario("guidance4_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, ak, np.array([[4.0, -5.0], [4.0, 25.0]]))


def guidance5_default(n_steps: int = 3000) -> Scenario:
    """usv_guidance5 (reference scripts/usv_guidance5/main.py:89-103):
    guidance4 plus the rate-limited heading-reference state."""
    ak, ye = _segment_frame(4.0, -5.0, 4.0, 25.0)
    psie = 0.0 - ak
    x0 = np.array([0.7, 0.0, ye, psie, psie])
    return Scenario("guidance5_default", x0, np.zeros(0), np.zeros(0),
                    n_steps, ak, np.array([[4.0, -5.0], [4.0, 25.0]]))


def pf_default(n_steps: int = 4000) -> Scenario:
    """usv_pf path following without obstacles (reference
    scripts/usv_pf/main.py:95-130): same frame/references as pf_ca."""
    x1, y1, x2, y2 = 4.0, -5.0, 4.0, 25.0
    ak = np.arctan2(y2 - y1, x2 - x1)
    ye = -(0.0 - x1) * np.sin(ak) + (0.0 - y1) * np.cos(ak)
    x0 = np.array([0.0, 0.0, 1.0, 0.001, 0.0, 0.0, ye,
                   x1, y1, ak, 0.0, 0.0, 0.0, 0.0])
    yref = np.zeros(16)
    yref[1], yref[2], yref[3] = np.sin(ak), np.cos(ak), 0.7
    return Scenario("pf_default", x0, np.zeros(0), np.zeros(0), n_steps,
                    float(ak), np.array([[x1, y1], [x2, y2]]),
                    yref=yref, yref_e=yref[:14])


def race_cars_default(n_steps: int = 500) -> Scenario:
    """race_cars on the synthetic curved track: the model's x0 (s = -2)
    rolling at v = 0.5 m/s, the builder's reference; the model's own
    constraint bounds as lh.  500 steps are 10 s at the builder's
    shooting interval Tf/N = 20 ms."""
    x0 = np.array([-2.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    return Scenario("race_cars_default", x0, np.zeros(0),
                    np.array([-4.0, -4.0, -0.12, -1.0, -0.40]), n_steps,
                    0.0, np.zeros((0, 2)),
                    track=trk.make_synthetic_track())


def race_cars_dev_default(n_steps: int = 500) -> Scenario:
    """race_cars_dev on the same track from the same start."""
    return dataclasses.replace(race_cars_default(n_steps),
                               name="race_cars_dev_default")


# Each ported model's default scenario, and the state coordinate that a
# batch of it perturbs by 0.1 N(0, 1): the cross-track error ye where the
# model has one (as bench.py:107-127), else the coordinate its cost tracks
# (surge u for usv_low_level and usv_acados, north x for
# usv_position_control, the lateral offset n for the race car).  guidance_ca_default, guidance4_default and
# guidance5_default carry no yref: those models track the builder's zero
# reference.
DEFAULTS = {
    "usv_guidance_ca1": (guidance_ca1_default, 2),
    "usv_pf_ca": (pf_ca_default, 6),
    "usv_pf": (pf_default, 6),
    "usv_low_level": (low_level_default, 3),
    "usv_acados": (acados_speed_default, 0),
    "usv_position_control": (position_control_default, 0),
    "usv_guidance_ca": (guidance_ca_default, 2),
    "usv_guidance": (guidance_default, 7),
    "usv_guidance2": (guidance2_default, 8),
    "usv_guidance3": (guidance3_default, 8),
    "usv_guidance4": (guidance4_default, 2),
    "usv_guidance5": (guidance5_default, 2),
    "race_cars": (race_cars_default, 1),
    "race_cars_dev": (race_cars_dev_default, 1),
}
