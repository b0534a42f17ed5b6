"""The port's marker stream (`utils/viz.py`) and dashboards
(`utils/plotting.py`) against the JAX package's, on the CPU.  The logged
track is the JAX suite's (tests/test_viz.py:26-37): JAX's challenge-0
mission at Tf=2, N=20 for 80 ticks, carried over as numpy."""

import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import GuidanceController as JCtrl
from mpc_collisionavoidance_tpu.guidance import Measurements as JMeas
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import mission as jmission
from mpc_collisionavoidance_tpu.utils import viz as jviz
from mpc_collisionavoidance_tpu_torch.guidance.controller import Commands
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.sim.mission import MissionLog
from mpc_collisionavoidance_tpu_torch.utils import plotting, viz


@pytest.fixture(scope="module")
def mission_log():
    """JAX's 80-tick challenge-0 mission log, as numpy."""
    ctrl = JCtrl(jbuilders.usv_guidance_ca1(Tf=2.0, N=20), ipm_iters=8)
    field, valid = scenarios.challenge0_field()
    wps = np.array([[4.0, -5.0], [4.0, 25.0]])
    log = jax.jit(lambda m: jmission.run_mission(
        ctrl, m, wps, 2, field, valid, n_steps=80))(
        JMeas(u=0.7, v=0.0, nedx=4.0, nedy=-5.0,
              psi=np.float32(np.pi / 2)))
    return jax.tree.map(np.array, log), field, valid


def _assert_frames(got, want, atol=1e-5):
    """Frames equal: pose and telemetry, circles within `atol`, the same
    collision and active flags."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.t, a.collision, a.active) == (b.t, b.collision, b.active)
        assert a.obstacles.shape == b.obstacles.shape
        np.testing.assert_allclose(a.obstacles, b.obstacles, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(
            [a.x, a.y, a.psi, a.boat_radius],
            [b.x, b.y, b.psi, b.boat_radius], rtol=0, atol=1e-12)
        assert (a.target is None) == (b.target is None)
        if a.target is not None:
            np.testing.assert_allclose(a.target, b.target, atol=1e-12)
            np.testing.assert_allclose(a.ye, b.ye, atol=1e-12)
        np.testing.assert_allclose(a.safety_radii, b.safety_radii,
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("stride", [1, 7])
def test_frames_match_jax(mission_log, stride):
    """Perception re-run at every logged pose (float32, batched): circles
    within 1e-5 of JAX's frames, identical collision flags; the port's
    MissionLog of the same arrays gives the same frames."""
    log, field, valid = mission_log
    want = jviz.frames_from_mission(log, field, valid, stride=stride)
    got = viz.frames_from_track(
        log.pos, log.psi, field, valid, targets=log.cmds.target,
        yes=log.cmds.ye, active=log.cmds.active, stride=stride)
    _assert_frames(got, want)
    assert sum(len(f.obstacles) for f in got) > 0, "no obstacle seen"
    tlog = MissionLog(pos=torch.as_tensor(log.pos),
                      psi=torch.as_tensor(log.psi),
                      cmds=Commands(*(torch.as_tensor(np.asarray(f))
                                      for f in log.cmds)),
                      final_state=None)
    _assert_frames(viz.frames_from_mission(tlog, field, valid,
                                           stride=stride), got, atol=0)


def test_streams_cross_read(mission_log, tmp_path):
    """Each package's read_jsonl reads the other's stream: the same
    frames, line for line."""
    log, field, valid = mission_log
    frames = viz.frames_from_mission(
        MissionLog(pos=torch.as_tensor(log.pos), psi=torch.as_tensor(log.psi),
                   cmds=Commands(*(torch.as_tensor(np.asarray(f))
                                   for f in log.cmds)), final_state=None),
        field, valid, stride=10)
    jframes = jviz.frames_from_mission(log, field, valid, stride=10)
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert viz.write_jsonl(frames, str(ours)) == len(frames)
    assert jviz.write_jsonl(jframes, str(theirs)) == len(jframes)
    _assert_frames(viz.read_jsonl(str(theirs)), jviz.read_jsonl(str(ours)),
                   atol=1e-4)
    _assert_frames(jviz.read_jsonl(str(ours)), frames, atol=1e-4)
    buf = io.StringIO()
    viz.write_jsonl(frames, buf)
    assert buf.getvalue() == ours.read_text()
    assert [json.loads(line) for line in ours.read_text().splitlines()] == \
        [f.to_dict() for f in viz.read_jsonl(str(ours))]


def test_render_animation_and_live_viewer_headless(mission_log, tmp_path):
    log, field, valid = mission_log
    frames = viz.frames_from_track(log.pos, log.psi, field, valid,
                                   stride=20)
    out = viz.render_animation(frames, str(tmp_path / "mission.gif"),
                               fps=5, dpi=50)
    data = Path(out).read_bytes()
    assert data[:6] in (b"GIF87a", b"GIF89a") and len(data) > 1000
    v = viz.LiveViewer(headless_sink=str(tmp_path / "live.jsonl"))
    for fr in frames:
        v.update(fr)
    v.close()
    assert len(viz.read_jsonl(str(tmp_path / "live.jsonl"))) == len(frames)


def test_dashboards_write_their_files(tmp_path):
    """The four dashboards, headless, under JAX's file names."""
    from mpc_collisionavoidance_tpu_torch.sim.cascade import CascadeLog
    from mpc_collisionavoidance_tpu_torch.utils import track as trk
    rng = np.random.default_rng(0)
    plotting.plot_flagship(rng.standard_normal((50, 8)),
                           torch.as_tensor(rng.standard_normal((50, 1))),
                           0.05, np.array([[4.0, 4.0], [4.0, 7.0]]),
                           np.array([1.5, 1.5]),
                           save_path=str(tmp_path / "flag"))
    z = torch.zeros(40)
    plotting.plot_cascade(
        CascadeLog(pos=torch.stack([z, z], 1), psi=z, u=z, psi_d=z, u_d=z,
                   thrust=torch.stack([z, z], 1), ye=z, active=z > 0,
                   collision=z > 0), 0.05, save_path=str(tmp_path / "casc"))
    figs = plotting.plot_pf_family(rng.standard_normal((50, 14)),
                                   rng.standard_normal((50, 2)), 0.01,
                                   obstacles=[[3.0, 2.0]], radii=[0.5],
                                   save_path=str(tmp_path / "pf"))
    assert len(figs) == 3
    t = trk.make_synthetic_track(n_samples=128)
    simX = np.zeros((40, 6))
    simX[:, 0] = np.linspace(0, t.length, 40)
    simX[:, 1] = 0.05 * np.sin(np.linspace(0, 6, 40))
    plotting.plot_race_track(t, simX, save_path=str(tmp_path / "race"))
    for name in ("flag_timeseries", "flag_xy", "casc_timeseries", "casc_xy",
                 "pf_timeseries", "pf_xy", "pf_errors", "race_track"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name
