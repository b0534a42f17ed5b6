"""Live safety visualization — the reference's rviz marker stream
(counterpart of `mpc_collisionavoidance_tpu/utils/viz.py`).

The reference flagship node publishes per-tick rviz markers of every
perceived obstacle (inflated circle) and its safety band, plus the
vehicle (reference src/nmpc_ca/src/nmpc_guidance_ca1.cpp:378-414
``circleDraw``; the simulator adds obstacle spheres,
obstacle_sim_node.py:128-158).  The equivalent here, three layers:

1. `MarkerFrame` — one tick's worth of safety geometry: vehicle pose +
   boat circle, the top-8 perceived obstacle slots (inflated radius =
   what the solver constrains on) and their +0.2 m safety bands
   (reference safety_radius_, :142), target waypoint, telemetry.
2. A STREAM format: `write_jsonl` / `read_jsonl` serialize frames one
   JSON object per line — the MarkerArray-topic role, consumable live
   over a pipe/file/socket by any dashboard.
3. Renderers: `render_animation` (matplotlib FuncAnimation -> GIF, for
   headless runs) and `LiveViewer` (interactive window updating per
   tick at the control rate, for attached displays).

Frames are rebuilt from mission/fleet logs by re-running the PURE
perception pipeline (`guidance.obstacles.perceive`) at every logged
pose — perception is deterministic, so the stream shows exactly the
circles the solver saw, as the reference's markers do.  The stream's line
format is the JAX package's, so each package reads the other's stream.
"""

import dataclasses
import json
from typing import IO, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.guidance import obstacles as obs
from mpc_collisionavoidance_tpu_torch.utils.plotting import as_numpy as _np

#: extra band drawn OUTSIDE the constrained circle (reference
#: safety_radius_ = 0.2, src/nmpc_guidance_ca1.cpp:142,295-304)
SAFETY_BAND = 0.2


@dataclasses.dataclass
class MarkerFrame:
    """One control tick's safety geometry (all NED-frame floats)."""

    t: int
    x: float
    y: float
    psi: float
    boat_radius: float
    # perceived obstacle slots, sentinel slots dropped: (k, 3) = x, y,
    # inflated radius (obstacle + boat radius — the constrained circle)
    obstacles: np.ndarray
    target: Optional[Sequence[float]] = None
    ye: Optional[float] = None
    collision: bool = False
    active: bool = True

    @property
    def safety_radii(self) -> np.ndarray:
        """Outer band radii (constrained circle + SAFETY_BAND)."""
        return self.obstacles[:, 2] + SAFETY_BAND if len(self.obstacles) \
            else np.zeros((0,))

    def to_dict(self) -> dict:
        d = {
            "t": int(self.t), "x": float(self.x), "y": float(self.y),
            "psi": float(self.psi), "boat_radius": float(self.boat_radius),
            "obstacles": np.asarray(self.obstacles).round(4).tolist(),
            "collision": bool(self.collision), "active": bool(self.active),
        }
        if self.target is not None:
            d["target"] = [float(v) for v in self.target]
        if self.ye is not None:
            d["ye"] = float(self.ye)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MarkerFrame":
        return cls(t=d["t"], x=d["x"], y=d["y"], psi=d["psi"],
                   boat_radius=d["boat_radius"],
                   obstacles=np.asarray(d["obstacles"], float).reshape(-1, 3),
                   target=d.get("target"), ye=d.get("ye"),
                   collision=d.get("collision", False),
                   active=d.get("active", True))


def _slots_to_xyr(p_obs, r_obs) -> np.ndarray:
    """(2k,) sentinel-padded centers + (k,) radii -> (m, 3) real circles."""
    p = np.asarray(p_obs, float).reshape(-1, 2)
    r = np.asarray(r_obs, float).reshape(-1)
    real = p[:, 0] < obs.SENTINEL_POS / 2
    return np.concatenate([p[real], r[real, None]], axis=1)


def frames_from_track(pos, psi, field, field_valid,
                      targets=None, yes=None, active=None,
                      boat_radius: float = obs.BOAT_RADIUS,
                      stride: int = 1) -> List[MarkerFrame]:
    """Rebuild the marker stream for a logged (T, 2) track.

    `pos`/`psi` come from a MissionLog / FleetLog vehicle; perception is
    re-run at every pose (float32, all poses in one batched call, on the
    device of `pos` when it is a tensor, else the CPU), so each frame
    carries exactly the inflated circles the solver constrained on at
    that tick."""
    device = pos.device if isinstance(pos, torch.Tensor) else "cpu"
    pos, psi = _np(pos).astype(float), _np(psi).astype(float)
    T = pos.shape[0]
    idx = np.arange(0, T, stride)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    slots = obs.perceive(f32(_np(field)),
                         torch.as_tensor(_np(field_valid), dtype=torch.bool,
                                         device=device),
                         f32(pos[idx, 0]), f32(pos[idx, 1]), f32(psi[idx]),
                         boat_radius=boat_radius)
    p_obs = _np(slots.p_obs)
    r_obs = _np(slots.r_obs)
    coll = _np(slots.collision).any(axis=-1)
    targets, yes, active = (None if a is None else _np(a)
                            for a in (targets, yes, active))

    frames = []
    for k, t in enumerate(idx):
        frames.append(MarkerFrame(
            t=int(t), x=float(pos[t, 0]), y=float(pos[t, 1]),
            psi=float(psi[t]), boat_radius=boat_radius,
            obstacles=_slots_to_xyr(p_obs[k], r_obs[k]),
            target=(None if targets is None
                    else [float(v) for v in targets[t]]),
            ye=None if yes is None else float(yes[t]),
            collision=bool(coll[k]),
            active=True if active is None else bool(active[t]),
        ))
    return frames


def frames_from_mission(log, field, field_valid, **kw) -> List[MarkerFrame]:
    """Marker stream from a `sim.mission.run_mission` log."""
    return frames_from_track(
        log.pos, log.psi, field, field_valid,
        targets=log.cmds.target, yes=log.cmds.ye, active=log.cmds.active,
        **kw)


# ---------------------------------------------------------------------------
# stream format (the MarkerArray-topic role)

def write_jsonl(frames: Iterable[MarkerFrame],
                sink: Union[str, IO[str]]) -> int:
    """One JSON object per line; returns the frame count.  `sink` may be
    a path or any writable text stream (file, pipe, socket makefile) —
    writing line-by-line makes the stream consumable LIVE."""
    own = isinstance(sink, str)
    fp = open(sink, "w") if own else sink
    n = 0
    try:
        for fr in frames:
            fp.write(json.dumps(fr.to_dict()) + "\n")
            fp.flush()
            n += 1
    finally:
        if own:
            fp.close()
    return n


def read_jsonl(source: Union[str, IO[str]]) -> List[MarkerFrame]:
    own = isinstance(source, str)
    fp = open(source) if own else source
    try:
        return [MarkerFrame.from_dict(json.loads(line))
                for line in fp if line.strip()]
    finally:
        if own:
            fp.close()


# ---------------------------------------------------------------------------
# renderers

def _draw_frame(ax, fr: MarkerFrame, trail):
    import matplotlib.patches as mpatches

    ax.clear()
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.set_xlabel("E [m]")
    ax.set_ylabel("N [m]")
    status = "COLLISION" if fr.collision else (
        "active" if fr.active else "done")
    ax.set_title(f"tick {fr.t}  ({status})")
    if trail is not None and len(trail):
        tr = np.asarray(trail)
        ax.plot(tr[:, 1], tr[:, 0], "-", lw=1.0, color="tab:blue",
                alpha=0.6)
    for (ox, oy, r), rs in zip(fr.obstacles, fr.safety_radii):
        # constrained circle (inflated radius — what `lh` enforces)
        ax.add_patch(mpatches.Circle((oy, ox), r, fill=False,
                                     color="tab:red", lw=1.5))
        # soft safety band (+0.2 m, reference safety_radius_)
        ax.add_patch(mpatches.Circle((oy, ox), rs, fill=False,
                                     color="tab:orange", ls="--", lw=1.0))
    ax.add_patch(mpatches.Circle((fr.y, fr.x), fr.boat_radius,
                                 color="tab:blue", alpha=0.5))
    hl = max(fr.boat_radius * 1.6, 0.8)
    ax.arrow(fr.y, fr.x, hl * np.sin(fr.psi), hl * np.cos(fr.psi),
             head_width=0.25, color="tab:blue")
    if fr.target is not None:
        ax.plot(fr.target[1], fr.target[0], "g*", ms=12)


def render_animation(frames: Sequence[MarkerFrame], save_path: str,
                     fps: int = 20, dpi: int = 80) -> str:
    """Render the stream to an animated GIF (PillowWriter — works
    headless).  Returns `save_path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 7))
    trail = []

    def update(i):
        fr = frames[i]
        trail.append((fr.x, fr.y))
        _draw_frame(ax, fr, trail)
        return []

    anim = manim.FuncAnimation(fig, update, frames=len(frames),
                               blit=False)
    anim.save(save_path, writer=manim.PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return save_path


class LiveViewer:
    """Interactive per-tick viewer (matplotlib ion) — call `update(fr)`
    from the control loop at the tick rate; the reference's rviz window
    role.  On headless backends construct with `headless_sink` to stream
    JSONL instead of drawing."""

    def __init__(self, headless_sink: Optional[Union[str, IO[str]]] = None):
        self._sink = None
        self._own_sink = False
        if headless_sink is not None:
            self._own_sink = isinstance(headless_sink, str)
            self._sink = (open(headless_sink, "w") if self._own_sink
                          else headless_sink)
            self._fig = None
        else:
            import matplotlib.pyplot as plt
            plt.ion()
            self._fig, self._ax = plt.subplots(figsize=(6, 7))
        self._trail = []

    def update(self, fr: MarkerFrame):
        self._trail.append((fr.x, fr.y))
        if self._sink is not None:
            self._sink.write(json.dumps(fr.to_dict()) + "\n")
            self._sink.flush()
            return
        import matplotlib.pyplot as plt
        _draw_frame(self._ax, fr, self._trail)
        self._fig.canvas.draw_idle()
        plt.pause(0.001)

    def close(self):
        if self._sink is not None and self._own_sink:
            self._sink.close()
        if self._fig is not None:
            import matplotlib.pyplot as plt
            plt.close(self._fig)
