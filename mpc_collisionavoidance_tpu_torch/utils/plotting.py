"""Scenario dashboards, the analog of the reference's per-variant plotFcn.py
(counterpart of `mpc_collisionavoidance_tpu/utils/plotting.py`).

The reference renders a 5-row time-series dashboard (input, body
velocities, heading error, command memory, cross-track error) plus an XY
trajectory with obstacle circles after each offline run (reference
scripts/usv_guidance_ca1/plotFcn.py:100-159).  These helpers produce the
same views, with the same file names, from the port's sim logs (numpy
arrays or tensors on any device), plus a cascade dashboard covering the
two-solver pipeline.  Matplotlib is imported lazily with the Agg backend
so runs on headless hosts can always save figures.
"""

import numpy as np
import torch


def as_numpy(a):
    """A log field (numpy array or tensor on any device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_flagship(simX, simU, dt, obstacles=None, radii=None,
                  save_path=None):
    """5-row dashboard + XY track for a usv_guidance_ca1 run.

    simX: (T, 8) state log in ca1 layout, simU: (T, 1) psi_e_d rate input,
    obstacles: (n, 2) NED centers, radii: (n,).  Returns the two figures.
    """
    plt = _plt()
    simX = as_numpy(simX)
    simU = as_numpy(simU)
    t = np.arange(len(simX)) * dt

    fig1, axes = plt.subplots(5, 1, figsize=(8, 11), sharex=True)
    axes[0].step(t, simU[:, 0], color="r")
    axes[0].set_ylabel("rad/s")
    axes[0].legend(["psieddot"])
    axes[0].set_title("closed-loop simulation")
    axes[1].plot(t, simX[:, 0:2])
    axes[1].set_ylabel("m/s")
    axes[1].legend(["u", "v"])
    axes[2].step(t, simX[:, 3], color="r")
    axes[2].set_ylabel("rad")
    axes[2].legend(["chie"])
    axes[3].step(t, simX[:, 4], color="r")
    axes[3].set_ylabel("rad")
    axes[3].legend(["psied"])
    axes[4].step(t, simX[:, 2], color="r")
    axes[4].set_ylabel("m")
    axes[4].set_xlabel("t [s]")
    axes[4].legend(["ye"])
    for ax in axes:
        ax.grid(True)

    fig2 = _xy_figure(plt, simX[:, 6], simX[:, 5], obstacles, radii)
    if save_path:
        fig1.savefig(f"{save_path}_timeseries.png", dpi=110,
                     bbox_inches="tight")
        fig2.savefig(f"{save_path}_xy.png", dpi=110, bbox_inches="tight")
    return fig1, fig2


def plot_cascade(log, dt, obstacles=None, radii=None, save_path=None):
    """Dashboard for a `sim.cascade.run_cascade` log: commands vs response
    at both cascade levels + XY track."""
    plt = _plt()
    t = np.arange(len(as_numpy(log.psi))) * dt

    fig1, axes = plt.subplots(4, 1, figsize=(8, 9), sharex=True)
    axes[0].plot(t, as_numpy(log.psi), label="psi")
    axes[0].plot(t, as_numpy(log.psi_d), "--", label="psi_d")
    axes[0].set_ylabel("rad")
    axes[0].set_title("cascaded guidance + low-level NMPC")
    axes[1].plot(t, as_numpy(log.u), label="u")
    axes[1].plot(t, as_numpy(log.u_d), "--", label="u_d")
    axes[1].set_ylabel("m/s")
    axes[2].plot(t, as_numpy(log.thrust)[:, 0], label="Tport")
    axes[2].plot(t, as_numpy(log.thrust)[:, 1], label="Tstbd")
    axes[2].set_ylabel("N")
    axes[3].plot(t, as_numpy(log.ye), label="ye")
    axes[3].set_ylabel("m")
    axes[3].set_xlabel("t [s]")
    for ax in axes:
        ax.grid(True)
        ax.legend(loc="upper right")

    pos = as_numpy(log.pos)
    fig2 = _xy_figure(plt, pos[:, 1], pos[:, 0], obstacles, radii)
    if save_path:
        fig1.savefig(f"{save_path}_timeseries.png", dpi=110,
                     bbox_inches="tight")
        fig2.savefig(f"{save_path}_xy.png", dpi=110, bbox_inches="tight")
    return fig1, fig2


def plot_pf_family(simX, simU, dt, obstacles=None, radii=None,
                   save_path=None):
    """5-row dashboard + XY track + error views for the 14-state pf family
    (usv_pf / usv_pf_ca state layout), mirroring the reference's
    scripts/usv_pf_ca/plotFcn.py:100-166: thrust-rate inputs, heading
    embedding (sin psi, cos psi), body velocities (u, v, r), thruster
    states (Tport, Tstbd), heading psi; XY uses NED states 10:12.

    simX: (T, 14), simU: (T, 2).  Returns (timeseries fig, xy fig).
    """
    plt = _plt()
    simX = as_numpy(simX)
    simU = as_numpy(simU)
    t = np.arange(len(simX)) * dt

    fig1, axes = plt.subplots(5, 1, figsize=(8, 11), sharex=True)
    axes[0].step(t, simU[:, 0], color="r", label="dTport")
    axes[0].step(t, simU[:, 1], color="g", label="dTstbd")
    axes[0].set_ylabel("N/s")
    axes[0].set_title("pf closed-loop simulation")
    axes[1].plot(t, simX[:, 1:3])
    axes[1].set_ylabel("-")
    axes[1].legend(["sin psi", "cos psi"])
    axes[2].plot(t, simX[:, 3:6])
    axes[2].set_ylabel("m/s, rad/s")
    axes[2].legend(["u", "v", "r"])
    axes[3].plot(t, simX[:, 12:14])
    axes[3].set_ylabel("N")
    axes[3].legend(["Tport", "Tstbd"])
    axes[4].plot(t, simX[:, 0], color="r")
    axes[4].set_ylabel("rad")
    axes[4].set_xlabel("t [s]")
    axes[4].legend(["psi"])
    axes[0].legend(loc="upper right")
    for ax in axes:
        ax.grid(True)

    fig2 = _xy_figure(plt, simX[:, 11], simX[:, 10], obstacles, radii)
    # error view (plotFcn.py:156-166): cross-track + surge tracking
    fig3, (axe, axu) = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    axe.plot(t, simX[:, 6], color="r")
    axe.set_ylabel("ye [m]")
    axe.grid(True)
    axu.plot(t, simX[:, 3], color="b")
    axu.set_ylabel("u [m/s]")
    axu.set_xlabel("t [s]")
    axu.grid(True)
    if save_path:
        fig1.savefig(f"{save_path}_timeseries.png", dpi=110,
                     bbox_inches="tight")
        fig2.savefig(f"{save_path}_xy.png", dpi=110, bbox_inches="tight")
        fig3.savefig(f"{save_path}_errors.png", dpi=110,
                     bbox_inches="tight")
    return fig1, fig2, fig3


def plot_race_track(track, simX, save_path=None):
    """Raced line in Cartesian coordinates over the track band — the
    reference's plotTrackProj (scripts/race_cars/plotFcn.py:42-98) using
    utils.track transforms: centerline, +-0.12 m width boundaries, and the
    (s, n) trajectory mapped back to XY."""
    from mpc_collisionavoidance_tpu_torch.utils import track as trk

    plt = _plt()
    simX = as_numpy(simX)
    s0 = torch.as_tensor(as_numpy(track.s0), dtype=torch.float64)
    xs, ys, _, _ = trk.transform_proj2orig(
        track, torch.as_tensor(simX[:, 0], dtype=torch.float64),
        torch.as_tensor(simX[:, 1], dtype=torch.float64))
    bx_l, by_l, _, _ = trk.transform_proj2orig(track, s0, 0.12)
    bx_r, by_r, _, _ = trk.transform_proj2orig(track, s0, -0.12)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.gca()
    ax.plot(track.xref, track.yref, "--", color="k", label="centerline")
    ax.plot(as_numpy(bx_l), as_numpy(by_l), color="k", linewidth=1)
    ax.plot(as_numpy(bx_r), as_numpy(by_r), color="k", linewidth=1)
    ax.plot(as_numpy(xs), as_numpy(ys), "-b", label="raced line")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.grid(True)
    ax.legend()
    if save_path:
        fig.savefig(f"{save_path}_track.png", dpi=110, bbox_inches="tight")
    return fig


def _xy_figure(plt, east, north, obstacles, radii):
    """XY track in the reference's plot convention: y (east) on the
    horizontal axis, x (north) on the vertical (plotFcn.py:135-143)."""
    fig = plt.figure(figsize=(6, 8))
    ax = fig.gca()
    ax.plot(east, north, label="trajectory")
    if obstacles is not None:
        obstacles = as_numpy(obstacles)
        radii = as_numpy(radii)
        for (ox, oy), r in zip(obstacles, radii):
            ax.add_patch(plt.Circle((oy, ox), r, alpha=0.5))
    ax.set_xlabel("east y [m]")
    ax.set_ylabel("north x [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.grid(True)
    ax.legend()
    return fig
