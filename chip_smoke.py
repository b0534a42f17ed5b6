"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`mpc_collisionavoidance_tpu_torch`) through
their hand-written CUDA kernels, each tick (and preparation, feedback) as
one captured CUDA graph (`solver/capture.py`), and exits non-zero if
anything fails:
the production RTI tick of the flagship OCP `usv_guidance_ca1` (nx=8,
nu=1, N=100, 8 soft obstacle rows), of the 14-state hull `usv_pf_ca`
(nx=14, nu=2, N=100, 5 state-box rows, 4 hard obstacle rows) and of the
hull family's models with neither parameters nor rows (`usv_pf` nx=14,
`usv_low_level` nx=8 at N=100, `usv_acados` nx=5 and
`usv_position_control` nx=8 at N=20; nu=2, 5 state-box rows) and of
the kinematic guidance family (`usv_guidance_ca` nx=9 with 8 hard obstacle
rows, `usv_guidance` nx=10, `usv_guidance2` nx=12, `usv_guidance3` nx=11,
`usv_guidance4` nx=4, `usv_guidance5` nx=5; nu=1, N=100) and of the
race car (`race_cars` nx=6, nu=2, N=50, 3 RK4 substeps, 3 hard and 2
soft rows, on the synthetic curved track and the straight one, and
`race_cars_dev` on the curved track: 6 soft rows, one of them the
softened state box), and the fused tick (`riccati="fused"`) of all
thirteen models.  Phases:

1. environment: torch, device, `nvidia-smi` name and power limit, nvcc,
   the CUDA runtime and driver versions (conditional graph nodes, which
   the captured ticks' escalation needs, want 12.4 or later of both), and
   the kernels' build (nvcc at first use, into build/torch_kernels/);
   ptxas must report 0 bytes spill stores and loads for the twenty-two
   K1, the twenty-eight K2 and the twenty-six K3 instances (`NO_SPILL`);
2. K1 (Riccati sweep) vs its plain PyTorch version on the card: random
   SPD LQRs at each instance's main-path horizons (`K1_SHAPES`: (8, 1),
   (14, 2) at N=100, (8, 2) at N=100 and 20, (5, 2) at N=20, the guidance
   family's (9, 1), (10, 1), (12, 1), (11, 1), (4, 1), (5, 1) at N=100,
   the race car's (6, 2) at N=50),
   L in {1, 130, 512}, float32 (rtol 2e-4, atol 2e-5) and float64 (atol
   1e-10);
   one lane's A set to NaN leaves every other lane's dx/du bitwise
   unchanged; each instance's time at L in {1, 128, 512} float32 and 512
   float64 (CUDA events over 50 back-to-back launches of the C entry)
   beside its bound;
3. K2 (fused linearization) vs its plain version on the card, for every
   model form at its builder's N (the race car's straight-track form and
   its curved-track form, which reads the curvature table, with 3
   substeps), L in {1, 37, 512} (37: teams and lanes ragged across
   blocks), float32 (xn/hbar rtol
   2e-5 atol 2e-6, J/C rtol 2e-4 atol 2e-5) and float64 (atol 1e-10; the
   hydrodynamic models' J, whose stiff sway-drag entries are large, also
   rtol 1e-12); each form's time at L in {1, 128, 512} float32 and 512
   float64 (CUDA events over 50 back-to-back launches of the C entry)
   beside its bound;
4. K3 (fused whole IPM, 12 iterations) vs its plain version
   `fused_ipm_lanes_plain` on the card, on QPs from the solver's own
   `_build_qp` at each OCP's default scenario (perturbed) and its
   builder's N: every structure (`K3_STRUCTURES`; usv_position_control's
   QP too) at L in {1, 130, 512}; float64 dx/du atol 1e-9, gap rtol 1e-9,
   identical status; float32 du atol 5e-3 (the float32 gap-floor ball)
   and status-0 shares within 0.02; one NaN lane -> status 2 in both, the
   other lanes' status unchanged; each structure's time at L in {1, 128,
   512} float32 (CUDA events over back-to-back launches of the C entry)
   beside its bound;
5. the flagship production tick at B=512: float64 on the card vs the plain
   path on the CPU from the same inputs (u0/x1 atol 5e-6, identical
   status), then float32 on the card, with the kernels' launch counts for
   that tick (K1 >= 4, K2 = 1, K3 = 0);
6. a 30-tick warm-started float32 closed loop at B=512 (converged_frac of
   the last tick, gap < 1e-5, must exceed 0.9) and its median tick time;
7. B=1 latency: p50/p99 over 50 ticks against the 50 ms budget at 20 Hz;
8. the 1000-tick float32 flagship mission at B=512
   (mission_converged_frac > 0.9);
9. the hull production tick: float64 card vs CPU plain at B=130 on both
   sides (the CPU tick of the 14-state hull at B=512 takes too long), then
   float32 at B=512 with launch counts (K1 >= 4, K2 = 1, K3 = 0), a 30-tick
   closed loop (converged_frac > 0.9) and B=1 p50/p99 against the 10 ms
   budget at 100 Hz (printed, not gated);
10. the fused tick of both OCPs at B=512, float32: launch counts (K3 = 1,
    K2 = 1, K1 = 0), a 30-tick closed loop (converged_frac > 0.9 on the
    flagship; the hull's printed) and B=1 p50/p99;
11. the real-time server (`rt/server.py`, float32, 128 lanes, 2 ms
    window) over a Unix socket, every reply checked (seq echoed, status 0
    or 1, finite), the launches of every served tick counted on the solve
    thread and gated:
    - the flagship at N=100, Tf=5, production schedule (bench.py:413-419):
      the first served tick against `LaneRTISolver.step_fn` on the same
      rows on the card (atol 1e-6, same status); B=1 over 200 ticks and
      an 8-vehicle fleet over 100 lockstep ticks (client-timed p50/p99,
      the server's device time and its own overhead, printed, not gated);
      every tick K1 >= 4, K2 = 1, K3 = 0;
    - the flagship with `centering="mehrotra"`: at the production
      schedule (K1 even, 8..56 per tick) and at 8 fixed iterations (K1 =
      16 per tick), 20 ticks each;
    - the flagship with `riccati="fused"`, 20 ticks: K3 = 1, K2 = 1, K1 = 0;
    - the hull (N=100, Tf=1) over v2 frames with the scenario's yref and
      `rti_split`, 50 ticks: the joining tick in full, then feedback ticks
      (K1 >= 4, K2 = 0) each followed by a preparation (K2 = 1, K1 = 0);
    - `python -m mpc_collisionavoidance_tpu_torch.rt.server --device cuda`
      (the flagship, production schedule) as its own process, driven by
      the unchanged C++ client's `rt_demo` (built with g++ into build/) for
      the reference's 1000 ticks: exit 0 and final |ye| < 0.5;
12. the hull family's models with no rows, each at its builder's N and
    tracking its scenario's references (x0 perturbed on the coordinate
    `scenarios.DEFAULTS` names): the float64 production tick on the card
    vs the CPU plain tick at B=32 (u0/x1 atol 5e-6, identical status);
    the float32 production tick (K1 >= 4, K2 = 1, K3 = 0) and fused tick
    (K3 = 1, K2 = 1, K1 = 0) at B=512; 30-tick closed loops of both
    (converged_frac gated > 0.9 where JAX's lane engine meets it, see
    `hull_family`); B=1 p50/p99 of both against the model's budget (10 ms
    usv_pf and usv_low_level, 50 ms usv_acados; usv_position_control has
    no node), printed; then usv_low_level served over v2 frames for 20
    ticks (every reply checked, K2 = 1 and K1 >= 4 per tick);
13. the kinematic guidance family, phase 12's recipe: each model at its
    builder's N=100 from its scenario (x0 perturbed on the coordinate
    `scenarios.DEFAULTS` names; usv_guidance_ca with its obstacle table
    and lh, usv_guidance..3 tracking their scenario's references): the
    float64 production tick on the card vs the CPU plain tick at B=32;
    the float32 production and fused ticks at B=512 with their launch
    counts; 30-tick closed loops of both, converged_frac gated > 0.9
    (JAX's lane engine meets it on every one of them,
    tests/test_torch_guidance_family.py); B=1 p50/p99 of both against
    the node's budget (50 ms usv_guidance_ca, 10 ms the others), printed;
    then usv_guidance_ca served over v2 frames for 20 ticks (16 obstacle
    parameters and lh per request, every reply checked, K2 = 1 and
    K1 >= 4 per tick);
14. the race car at its builder's N=50 and B=512, from the race scenario
    (x0 rolling at v = 0.5, n perturbed): race_cars and race_cars_dev on
    the synthetic curved track, the float64 production and fused ticks on
    the card vs the CPU plain ticks (u0/x1 atol 5e-6, identical status);
    for them and for race_cars on the straight track, the float32
    production and fused ticks with their launch counts, 30-tick closed
    loops (converged_frac gated > 0.9 on the production schedule for all
    three and on the fused schedule on the curved track, where a few
    lanes that the solver flags with status 2 may be non-finite, as in
    JAX's lane engine; the straight track's fused share printed beside
    JAX's, which misses the gate too,
    tests/test_torch_race_cars.py::test_jax_float32_closed_loop) and B=1
    p50/p99 printed beside the shooting interval Tf/N = 20 ms; then
    race_cars served over v2 frames for 20 ticks on the straight track, as
    the server builds it (lh per request, K2 = 1, K1 >= 4 per tick).
    Phases 12-14 time B=1 over 20 ticks (phase 7 and the flagship's over
    50).
15. captured ticks: for every run of phases 5, 9 and 12-14, the captured
    production and fused ticks against the eager ones (`capture=False`)
    from the same inputs at B=512, float32 and float64: u0, x1, gap and
    status bitwise equal and the same escalation iteration count, on the
    capturing call and on a replay from the same state that runs under
    `torch.cuda.set_sync_debug_mode("error")` and launches one graph; in
    float32 also the RTI split (prepare_fn + feedback_fn, one graph
    launch each, under the same mode) against the eager split; each
    graph's nodes, conditional (escalation) nodes, capture and
    instantiation times and pool memory printed.

Each main path is driven with every launch count set to 0 just before and
read just after, on ticks that replay their captured graphs (a tick that
captures runs an eager warm-up first, so the counted tick is not the
first): a replay adds the launches its wrappers counted at capture, and
the escalation steps' launches times the steps that ran on the device,
read after the tick (`capture.settle_launch_counts`).  The race car's
runs are named by the K2 form they take: `race_cars` on the straight
track, `race_cars_track` and
`race_cars_dev_track` on the curved one (`RACE`).  Times come from CUDA events (the server's from the
client's clock); the plain versions' times are those of their checked
calls at L=512 float32 (K2, K3: one call each) or the median of 5 (K1).
The line before the last is a JSON object with one entry per kernel
(per instance for K1, per model form for K2, per structure for K3), each
with its launches on the main paths (every one must be launched), its
time, the plain version's, and its bound: the larger of the bytes it
must move over the HBM rate and its FLOPs over the float peak (`bound`,
`riccati_work`, `linearize_work`, `ipm_work`); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
float32 matrix products run in full float32 (TF32 off, set below).
"""

import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
B = 512
HULL_CPU_B = 130
FLAGSHIP, HULL = "usv_guidance_ca1", "usv_pf_ca"
# the hull family's models with no obstacle rows (phase 12), with the
# real-time budget of each one's ROS node in ms (None: it has no node)
PF, LOW_LEVEL = "usv_pf", "usv_low_level"
ACADOS, POSITION = "usv_acados", "usv_position_control"
FAMILY_BUDGET_MS = {PF: 10.0, LOW_LEVEL: 10.0, ACADOS: 50.0, POSITION: None}
FAMILY = tuple(FAMILY_BUDGET_MS)
FAMILY_CPU_B = 32
# the kinematic guidance family (phase 13), with each node's real-time
# budget in ms: usv_guidance_ca's node runs at 20 Hz
# (src/nmpc_guidance_ca.cpp:347), usv_guidance's at 100 Hz
# (src/nmpc_guidance.cpp:335); usv_guidance2..5 are held to 10 ms on the
# assumption that their nodes share that template (SURVEY.md N11-N14)
GUIDANCE_CA = "usv_guidance_ca"
GUIDANCE_BUDGET_MS = {GUIDANCE_CA: 50.0, "usv_guidance": 10.0,
                      "usv_guidance2": 10.0, "usv_guidance3": 10.0,
                      "usv_guidance4": 10.0, "usv_guidance5": 10.0}
GUIDANCE = tuple(GUIDANCE_BUDGET_MS)
# the race car's runs (phase 14), each named by the K2 form it takes:
# (model, on the synthetic curved track?)
RACE = {"race_cars_track": ("race_cars", True),
        "race_cars_dev_track": ("race_cars_dev", True),
        "race_cars": ("race_cars", False)}
# the shooting interval Tf/N of the race builders, 1 s / 50, in ms: the
# race car has no ROS node and so no budget; its B=1 tick is printed
# beside this interval
RACE_INTERVAL_MS = 20.0
# B=1 latency ticks of phases 12-14
FAMILY_B1_TICKS = 20
REPO = pathlib.Path(__file__).resolve().parent
SERVER_LANES = 128                  # the server's default --max-batch


def _tick_ms(fn, reps):
    """Median CUDA-event time of `fn()` over `reps` runs, after one
    warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed(fn):
    """(fn(), its CUDA-event time in ms): one call, the kernels' checked
    plain-version call timed as it runs, so that no extra call is made."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _max_err(got, want):
    """The largest |got - want| over the pairs (0 for empty tensors: the
    hbar and C of a model with no rows)."""
    return max((float((g - w).abs().max()) for g, w in zip(got, want)
                if g.numel()), default=0.0)


def _check_close(what, got, want, rtol, atol):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}[{i}]: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}[{i}]: non-finite kernel output")
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            err = float((g - w).abs().max())
            raise AssertionError(f"{what}[{i}]: max |err| {err:.3e} over "
                                 f"rtol {rtol}, atol {atol}")


def _sync():
    import torch
    torch.cuda.synchronize()


def _reset_counts():
    from mpc_collisionavoidance_tpu_torch.kernels import (ipm, linearize,
                                                          riccati)
    _launch_counts()
    riccati.launches = linearize.launches = ipm.launches = 0


def _read_counts():
    _sync()
    return _launch_counts()


def _launch_counts():
    """The launch counters, with the escalation steps that captured ticks
    ran added (`settle_launch_counts` reads them from the device, which
    waits for the ticks)."""
    from mpc_collisionavoidance_tpu_torch.kernels import (ipm, linearize,
                                                          riccati)
    from mpc_collisionavoidance_tpu_torch.solver import capture
    capture.settle_launch_counts()
    return {"riccati_lanes": riccati.launches,
            "linearize_lanes": linearize.launches,
            "fused_ipm_lanes": ipm.launches}


def environment():
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    from mpc_collisionavoidance_tpu_torch.solver import capture
    runtime, driver = capture.cuda_versions()
    print(f"CUDA runtime of the kernel library {runtime}, driver {driver}, "
          f"torch's CUDA {torch.version.cuda}; torch's CUDAGraph binds "
          f"conditional nodes: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    if min(runtime, driver) < 12040:
        raise AssertionError("conditional graph nodes need CUDA 12.4 or "
                             "later of the runtime and the driver")
    # registers and spills of every kernel instance (ptxas -v)
    log = (lib.parent / "nvcc.log").read_text()
    regs = register_report(log)
    for name, (stores, loads) in spill_report(log).items():
        print(f"  {name}: {regs.get(name, '?')} registers, spill "
              f"{stores}/{loads} bytes")
    check_spills(log)
    return card


# kernels whose every instance must compile without spills, and how many
# instances each has (K1: 11 shapes, K2: 14 forms, K3: 13 structures, each
# in two types)
NO_SPILL = {"riccati_lanes_kernel": 22, "linearize_lanes_kernel": 28,
            "fused_ipm_kernel": 26}


def spill_report(log):
    """{entry function: (spill store bytes, spill load bytes)} from ptxas'
    -v report in an nvcc log."""
    report, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "bytes spill stores" in line:
            words = line.replace(",", " ").split()
            report[name] = (int(words[words.index("spill") - 2]),
                            int(words[words.index("loads") - 3]))
            name = None
    return report


def register_report(log):
    """{entry function: registers} from ptxas' -v report in an nvcc log."""
    report, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            report[name] = int(words[words.index("registers") - 1])
            name = None
    return report


def check_spills(log):
    """Raise unless every instance of the NO_SPILL kernels reports 0 bytes
    spill stores and loads."""
    report = spill_report(log)
    for kernel, count in NO_SPILL.items():
        got = {n: v for n, v in report.items() if kernel in n}
        bad = {n: v for n, v in got.items() if v != (0, 0)}
        print(f"ptxas: {len(got)} {kernel} instances, spill stores/loads "
              f"{sorted(set(got.values()))}")
        if len(got) != count or bad:
            raise AssertionError(f"{kernel}: {len(got)} instances (want "
                                 f"{count}), spilling: {bad}")


def _random_lqr(N, nx, nu, L, seed, dtype):
    """Random SPD LQR (the pattern of tests/test_riccati_pallas.py)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import LaneLQR
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape) * 0.3

    Qr = rng.standard_normal((N + 1, nx, nx, L)) * 0.2
    Q = (np.einsum("nikl,njkl->nijl", Qr, Qr)
         + 0.5 * np.eye(nx)[None, :, :, None])
    Rr = rng.standard_normal((N, nu, nu, L)) * 0.2
    R = (np.einsum("nikl,njkl->nijl", Rr, Rr)
         + 0.5 * np.eye(nu)[None, :, :, None])
    A = (0.9 * np.eye(nx)[None, :, :, None]
         + 0.05 * rng.standard_normal((N, nx, nx, L)))
    fields = (A, arr(N, nx, nu, L), arr(N, nx, L), Q, arr(N, nu, nx, L) * 0.1,
              R, arr(N + 1, nx, L), arr(N, nu, L), arr(nx, L))
    return LaneLQR(*(torch.as_tensor(f, dtype=dtype, device=DEVICE)
                     for f in fields))


# ---- the least time the card could take for a kernel's work ----
# H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s float32
# and 34 TFLOP/s float64 outside the tensor cores.

def bound(nbytes, flops, itemsize):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FLOPs over the peak of their type."""
    t_bytes = nbytes / 3.35e12
    t_ops = flops / (67e12 if itemsize == 4 else 34e12)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def riccati_stage_flops(nx, nu):
    """FLOPs of one lane's Riccati stage, backward and forward (an FMA is
    2), as csrc/riccati_team.cuh computes it."""
    return (4 * nx**3                        # P A, A'PA
            + 2 * nx * nx * nu * 3           # P B, B'PA, Hux'K
            + nu * nx                        # Hux = S + ...
            + 2 * nx * nx + nx               # P c + p
            + 2 * nu * nu * nx + nu * nu     # Huu
            + 2 * nu * nx + nu               # hu
            + 2 * nu * nu * (nx + 1)         # the solves for K and k
            + 4 * nx * nx                    # Q + ... + ..., sym
            + 2 * nx * nx + 2 * nu * nx + 2 * nx   # p
            + 2 * nu * nx + nu               # du = K dx + k
            + 2 * nx * nx + 2 * nx * nu + nx)  # dx' = A dx + B du + c


def riccati_work(N, nx, nu, L, itemsize):
    """(bytes, FLOPs) of one K1 launch: A, B, c, S, R, qu of every stage,
    Q and qx of every stage and the terminal one, dx0 read once; dx, du
    written once."""
    values = (N * (nx * nx + nx * nu + nx + nu * nx + nu * nu + nu)
              + (N + 1) * (nx * nx + nx) + nx + (N + 1) * nx + N * nu)
    return values * L * itemsize, N * L * riccati_stage_flops(nx, nu)


# FLOPs of one RK4 substep per (stage, lane) of K2's model forms, with h,
# counted by hand from csrc/models/*.cuh on duals of width 1 + |f_dep| (a
# dual product 1 + 3 W FLOPs, a sum 1 + W, a sin/cos/atan2/sqrt ~20 + 2 W;
# four evaluations of f, RK4's combinations): estimates, 3-4x below the
# byte bound at N=100, L=512.  hydro.cuh's thrust map and uvr_dot are
# ~80 + 90 W of each f; a model's own terms and RK4's 13 + 13 W per state
# come on top (usv_acados 710 per f at W = 7, usv_low_level 940 and
# usv_position_control 990 at W = 8, usv_pf the hull's without its rows).
# The guidance forms (models/guidance.cuh): the crab angle and the heading
# error ~70 + 16 W, the NED rates ~46 + 18 W, the cross-track rate
# ~44 + 12 W of each f (usv_guidance_ca 350 per f at W = 7 plus the
# flagship's rows, usv_guidance 390 at W = 6, usv_guidance2 440 and
# usv_guidance3 480 at W = 7, usv_guidance4 130 at W = 4, usv_guidance5
# 150 at W = 5).  The race car (models/race_cars.cuh): the drive force
# ~31 + 16 W, the angle, its sin and cos and the products ~70 + 23 W of
# each f (~335 at W = 6 on the straight track); the curved form adds the
# interpolant ~30 + 20 W and the division by 1 - kappa n and kappa sdota
# ~5 + 11 W (~700 at W = 8); RK4's combinations over 6 states; h ~190
# once per stage (3 substeps share it).
_LINEARIZE_FLOPS = {FLAGSHIP: 2.8e3, HULL: 7.6e3, PF: 7.4e3,
                    LOW_LEVEL: 4.7e3, POSITION: 4.9e3, ACADOS: 3.4e3,
                    GUIDANCE_CA: 2.7e3, "usv_guidance": 2.5e3,
                    "usv_guidance2": 3.0e3, "usv_guidance3": 3.1e3,
                    "usv_guidance4": 0.8e3, "usv_guidance5": 1.0e3,
                    "race_cars": 2.0e3, "race_cars_track": 3.6e3}


def linearize_work(name, m, N, L, steps, itemsize):
    """(bytes, FLOPs) of one K2 launch: xs, ubar, params and a curved
    form's curvature table read once; xn, J, hbar, C written once."""
    nx, nu, nh = m.nx, m.nu, m.nh
    table = 0 if getattr(m, "kapparef", None) is None else m.kapparef.size
    values = ((nx + nu) * N * L + m.np_ * L + table
              + (nx + nx * (nx + nu) + nh + nh * nx) * N * L)
    return values * itemsize, _LINEARIZE_FLOPS[name] * steps * N * L


def ipm_work(N, structure, L, iters, itemsize):
    """(bytes, FLOPs) of one K3 launch: the LaneQP's lane fields and
    static blocks read once, dx, du, gap, eq_res written once; per
    iteration and stage one Riccati stage, the rows' Gram (2 r nx^2),
    their products (8 r nx) and ~30 FLOPs per inequality (an estimate
    from csrc/ipm_lanes.cuh)."""
    nx, nu, nbu, nbx, nHh, nS = structure
    lane = (N * (nx * nx + nx * nu + nx + nu + 2 * nbu + 2 * nbx
                 + nHh * nx + 2 * nHh + nS * nx + 3 * nS)
            + (N + 1) * nx + nx)
    out = (N + 1) * nx + N * nu + 2
    static = 2 * nx * nx + nu * nx + nu * nu + 6 * nS
    rows = nHh + nS
    stage = (riccati_stage_flops(nx, nu) + 2 * rows * nx * nx
             + 8 * rows * nx + 30 * (rows + 2 * nbu + 2 * nbx))
    return ((lane + out) * L + static) * itemsize, iters * N * L * stage


def launch_ms(call, launches=50, reps=3):
    """Device time per call: CUDA events around `launches` back-to-back
    calls, the median of `reps` runs after a warm-up."""
    import torch
    call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def riccati_launcher(lib, d):
    """A call of `lib`'s K1 C entry on the LaneLQR `d` with its outputs and
    scratch allocated once (the kernel's time without the wrapper's checks
    and allocations, and not counted as a launch).  Returns (call,
    (dx, du))."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build
    N, nx, _, L = d.A.shape
    nu = d.B.shape[2]
    opts = dict(dtype=d.A.dtype, device=d.A.device)
    out = [torch.empty(shape, **opts) for shape in (
        (N + 1, nx, L), (N, nu, L), (N, nu, nx, L), (N, nu, L))]
    args = (int(d.A.dtype == torch.float64), nx, nu, N, L,
            *_build.launch_args(d.A.device, *d, *out))

    def call():
        _build.check(lib.nmpc_riccati_lanes(*args), "riccati_lanes")
    return call, out[:2]


def linearize_launcher(lib, name, m, xs, ubar, params, dt, steps):
    """A call of `lib`'s K2 C entry of form `name` (a model's name, or
    `race_cars_track` for the curved-track form, whose entry also takes
    the model's curvature table) on the lane inputs, with its outputs
    allocated once (the kernel's time without the wrapper's checks and
    allocations, and not counted as a launch).  Returns (call, (xn, J,
    hbar, C))."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build
    nx, N, L = xs.shape
    opts = dict(dtype=xs.dtype, device=xs.device)
    out = [torch.empty(shape, **opts) for shape in (
        (nx, N, L), (N, nx, nx + m.nu, L), (m.nh, N, L), (N, m.nh, nx, L))]
    *ptrs, stream = _build.launch_args(xs.device, xs, ubar, params, *out)
    if name.endswith("_track"):
        table = m.kappa_table(xs.device, xs.dtype)
        ptrs += [ctypes.c_void_p(table.data_ptr()), table.numel(),
                 float(m.track_length)]
    entry = getattr(lib, "nmpc_linearize_" + name)
    args = (int(xs.dtype == torch.float64), N, L, dt / steps, steps, *ptrs,
            stream)

    def call():
        _build.check(entry(*args), f"linearize_lanes[{name}]")
    return call, out


# K1's instances: the horizons the main paths give each (the first is
# timed) and the models that run it
K1_SHAPES = {(8, 1): ((100,), (FLAGSHIP,)),
             (14, 2): ((100,), (HULL, PF)),
             (8, 2): ((100, 20), (LOW_LEVEL, POSITION)),
             (5, 2): ((20,), (ACADOS,)),
             (9, 1): ((100,), (GUIDANCE_CA,)),
             (10, 1): ((100,), ("usv_guidance",)),
             (12, 1): ((100,), ("usv_guidance2",)),
             (11, 1): ((100,), ("usv_guidance3",)),
             (4, 1): ((100,), ("usv_guidance4",)),
             (5, 1): ((100,), ("usv_guidance5",)),
             (6, 2): ((50,), tuple(RACE))}
# (L, dtype name) at which K1 is timed
K1_TIMED = ((1, "float32"), (128, "float32"), (512, "float32"),
            (512, "float64"))


def _riccati_nan_lane(nx, nu, N, L=130, lane=7):
    """One lane's A set to NaN: that lane goes non-finite and every other
    lane's dx/du stays bitwise as it was (lane 7 shares its block with
    lanes 4-6)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import riccati
    d = _random_lqr(N, nx, nu, L, seed=7, dtype=torch.float32)
    ref = riccati.lqr_solve_lanes_cuda(*d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = riccati.lqr_solve_lanes_cuda(*d._replace(A=A))
    torch.cuda.synchronize()
    keep = torch.arange(L, device=DEVICE) != lane
    same = all(torch.equal(g[..., keep], r[..., keep])
               for g, r in zip(got, ref))
    poisoned = not all(bool(torch.isfinite(g[..., lane]).all())
                       for g in got)
    print(f"K1 ({nx}, {nu}) NaN in lane {lane}'s A at L={L}: lane "
          f"non-finite {poisoned}, the other lanes bitwise unchanged {same}")
    if not (same and poisoned):
        raise AssertionError(f"K1 ({nx}, {nu}): a NaN lane touched another "
                             "lane, or stayed finite")


def check_riccati():
    """K1 vs lqr_solve_lanes_plain on the card, the NaN-lane isolation, and
    the kernel's time beside its bound; returns {(nx, nu): dict(err, ms,
    plain_ms, bound_ms, bound_by)} (times at the instance's first
    horizon, L=512, float32)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build, riccati
    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
        lqr_solve_lanes_plain)
    lib = _build.library()
    result = {}
    for (nx, nu), (horizons, _) in K1_SHAPES.items():
        worst = 0.0
        N = horizons[0]
        for NL, L in itertools.product(horizons, (1, 130, 512)):
            for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                                      (torch.float64, 0.0, 1e-10)):
                d = _random_lqr(NL, nx, nu, L, seed=nx * 1000 + L,
                                dtype=dtype)
                got = riccati.lqr_solve_lanes_cuda(*d)
                want = lqr_solve_lanes_plain(d)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst = max(worst, err)
                print(f"K1 riccati nx={nx} nu={nu} N={NL} L={L} "
                      f"{str(dtype)[6:]}: max|err| {err:.3e}")
                _check_close(f"K1 ({nx},{nu}) N={NL} L={L} {dtype}", got,
                             want, rtol, atol)
        _riccati_nan_lane(nx, nu, N)
        for L, dname in K1_TIMED:
            dtype = getattr(torch, dname)
            d = _random_lqr(N, nx, nu, L, seed=1, dtype=dtype)
            ms = launch_ms(riccati_launcher(lib, d)[0])
            bound_ms, by = bound(*riccati_work(N, nx, nu, L,
                                               d.A.element_size()),
                                 d.A.element_size())
            print(f"K1 ({nx}, {nu}) N={N} L={L} {dname}: {ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by}), "
                  f"{100 * bound_ms / ms:.2f}% of the bound")
            if (L, dname) == (B, "float32"):
                result[(nx, nu)] = dict(err=worst, ms=ms, bound_ms=bound_ms,
                                        bound_by=by)
        d = _random_lqr(N, nx, nu, B, seed=1, dtype=torch.float32)
        result[(nx, nu)]["plain_ms"] = _tick_ms(
            lambda: lqr_solve_lanes_plain(d), 5)
        print(f"K1 ({nx}, {nu}) plain sweep at L={B} float32: "
              f"{result[(nx, nu)]['plain_ms']:.4f} ms")
    return result


# the state coordinates (u, v, Tport, Tstbd) of each hydrodynamic model
_HYDRO = {HULL: (3, 4, 12, 13), PF: (3, 4, 12, 13),
          LOW_LEVEL: (3, 4, 6, 7), ACADOS: (0, 1, 3, 4),
          POSITION: (3, 4, 6, 7)}
# the state coordinate of each guidance model's surge u
_SURGE = {GUIDANCE_CA: 0, "usv_guidance": 5, "usv_guidance2": 5,
          "usv_guidance3": 5, "usv_guidance4": 0, "usv_guidance5": 0}


def _linearize_inputs(name, m, N, L, rng, dt):
    """Random points of the model's state space: the flagship's as in
    tests/test_linearize_pallas.py; the hydrodynamic models' around their
    operating range (surge 0.2-2 m/s across the 1.25 m/s drag switch,
    thrusts -20..30, v = 0 exactly on lane 0, the kink of |v|), with sway
    within +-0.3 m/s at the hull's step of 0.01 s and scaled down with a
    longer step: the sway drag's stiffness, ~750 |v| per second, leaves
    RK4 stable only while |v| dt stays below ~1/750 (at usv_acados' and
    usv_position_control's 0.05 s a sway of 0.3 m/s blows the step up to
    values whose float32 round-off exceeds any tolerance).  The guidance
    family's as the flagship's, with a forward surge of 0.2-1.5 m/s (away
    from the crab angle's branch cut at u + 0.001 < 0, v = 0).  The race
    car's with arc lengths over [-1.5, 2.5] laps of the synthetic track
    (negative s, the seam, the second lap), |n| < 0.2, speeds 0.2-1.5
    m/s."""
    if name in RACE:
        from mpc_collisionavoidance_tpu_torch.utils import track
        xs = np.empty((6, N, L))
        xs[0] = rng.uniform(-1.5, 2.5, size=(N, L)) * \
            track.make_synthetic_track().length
        xs[1] = rng.uniform(-0.2, 0.2, size=(N, L))
        xs[2] = rng.normal(size=(N, L)) * 0.2
        xs[3] = rng.uniform(0.2, 1.5, size=(N, L))
        xs[4] = rng.normal(size=(N, L)) * 0.3
        xs[5] = rng.normal(size=(N, L)) * 0.2
        return xs, rng.normal(size=(2, N, L)), np.zeros((0, L))
    if name == FLAGSHIP or name in GUIDANCE:
        xs = rng.normal(size=(m.nx, N, L)) * 0.5
        if name in GUIDANCE:
            xs[_SURGE[name]] = rng.uniform(0.2, 1.5, size=(N, L))
        return (xs, rng.normal(size=(m.nu, N, L)) * 0.2,
                rng.uniform(2.0, 50.0, size=(m.np_, L)))
    iu, iv, ip, istbd = _HYDRO[name]
    xs = rng.normal(size=(m.nx, N, L)) * 0.5
    xs[iu] = rng.uniform(0.2, 2.0, size=(N, L))
    xs[iv] = rng.normal(size=(N, L)) * 0.1 * min(1.0, 0.01 / dt)
    xs[iv, :, 0] = 0.0
    xs[[ip, istbd]] = rng.uniform(-20.0, 30.0, size=(2, N, L))
    return (xs, rng.normal(size=(m.nu, N, L)) * 5.0,
            rng.uniform(-10.0, 20.0, size=(m.np_, L)))


# (L, dtype name) at which K2 is checked against its plain version, and
# at which it is timed
K2_CHECKED = (1, 37, B)
K2_TIMED = K1_TIMED


def check_linearize():
    """K2 vs linearize_lanes_plain on the card, per model form, and the
    kernel's time beside its bound; returns {form: (max float32 error, max
    float64 error, kernel ms, plain ms, bound ms, bound_by)} (times at the
    builder's N, L=512, float32)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build, linearize
    from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
        linearize_lanes_plain)
    tols32 = ((2e-5, 2e-6), (2e-4, 2e-5), (2e-5, 2e-6), (2e-4, 2e-5))
    lib = _build.library()
    result = {}
    forms = [*linearize.CUDA_MODELS,
             *(f"{name}_track" for name in linearize.TRACK_FORMS)]
    for name in forms:
        spec = _spec(name)
        m = spec.model
        N, steps = spec.N, spec.integrator_steps
        kw = dict(model=m, dt=spec.dt, integrator_steps=steps)
        worst = {torch.float32: 0.0, torch.float64: 0.0}
        for L in K2_CHECKED:
            rng = np.random.default_rng(100 + L)
            inputs = _linearize_inputs(name, m, N, L, rng, spec.dt)
            for dtype in (torch.float32, torch.float64):
                args = [torch.as_tensor(a, dtype=dtype, device=DEVICE)
                        for a in inputs]
                got = linearize.linearize_lanes_cuda(*args, **kw)
                want, want_ms = _timed(lambda: linearize_lanes_plain(
                    *args, **kw))
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"K2 linearize {name} N={N} L={L} {str(dtype)[6:]}: "
                      f"max|err| {err:.3e}")
                for out, g, w, (rtol, atol) in zip(("xn", "J", "hbar", "C"),
                                                   got, want, tols32):
                    if dtype == torch.float64:
                        # the hydrodynamic J's stiff sway-drag entries are
                        # large: relative too
                        rtol = 1e-12 if (name != FLAGSHIP
                                         and out == "J") else 0.0
                        atol = 1e-10
                    _check_close(f"K2 {name} {out} L={L} {dtype}", [g], [w],
                                 rtol, atol)
                if dtype == torch.float32 and L == B:
                    plain_ms = want_ms
        for L, dname in K2_TIMED:
            dtype = getattr(torch, dname)
            rng = np.random.default_rng(100 + L)
            args = [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in
                    _linearize_inputs(name, m, N, L, rng, spec.dt)]
            ms = launch_ms(linearize_launcher(lib, name, m, *args, spec.dt,
                                              steps)[0])
            item = args[0].element_size()
            bound_ms, by = bound(*linearize_work(name, m, N, L, steps, item),
                                 item)
            print(f"K2 {name} N={N} L={L} {dname}: {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}), {100 * bound_ms / ms:.2f}% "
                  "of the bound")
            if (L, dname) == (B, "float32"):
                result[name] = (worst[torch.float32], worst[torch.float64],
                                ms, plain_ms, bound_ms, by)
        print(f"K2 {name} plain linearization at L={B} float32: "
              f"{plain_ms:.4f} ms")
    return result


def _spec(name):
    """The builder's OCP of a model, or of a race run (`RACE`: on the
    synthetic curved track or the straight one)."""
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.utils import track
    model, curved = RACE.get(name, (name, False))
    return builders.build(model, **(
        {"track": track.make_synthetic_track()} if curved else {}))


def _setup(name, Bn, dtype, device, config, seed=SEED, capture=True):
    """Solver, warm start, lane inputs and references of the bench's
    workload (bench.py:107-127): the OCP's default scenario with one
    coordinate perturbed by 0.1 N(0, 1) (ye for the flagship, the hulls;
    `scenarios.DEFAULTS` names the others').  The flagship and the hull
    use the builder's references, as bench.py does; the hull family's
    models with no rows and the guidance family's track their scenario's
    where it has them (`refs`, the keyword arguments of step_fn and
    _build_qp); a race run (`RACE`) races its model's scenario on the
    curved or the straight track.  `capture=False`: the solver's ticks run
    op by op (phase 15's eager side)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
    spec = _spec(name)
    factory, coord = scenarios.DEFAULTS[RACE.get(name, (name,))[0]]
    sc = factory()
    m = spec.model
    solver = config.build(spec, device=device, dtype=dtype, capture=capture)
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (Bn, m.nx)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(Bn)

    def lanes(a):
        return to_lanes(torch.tensor(np.asarray(a), dtype=dtype)).to(device)

    refs = {}
    if (name in FAMILY or name in GUIDANCE) and sc.yref is not None:
        refs = {k: torch.tensor(getattr(sc, k), dtype=dtype, device=device)
                for k in ("yref", "yref_e")}
    state = solver.init_state(x0s)
    return (solver, state, lanes(x0s),
            lanes(np.broadcast_to(sc.params, (Bn, m.np_))),
            lanes(np.broadcast_to(sc.lh, (Bn, m.nh))), refs)


def _production():
    from mpc_collisionavoidance_tpu_torch.config import production_engine
    return production_engine()


def _fused():
    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    return SolverConfig(riccati="fused")


def _check_output(out, Bn, what, nx, nu):
    import torch
    if tuple(out.u0.shape) != (nu, Bn) or tuple(out.x1.shape) != (nx, Bn):
        raise AssertionError(f"{what}: output shapes {tuple(out.u0.shape)}"
                             f", {tuple(out.x1.shape)}")
    for name in ("u0", "x1", "gap"):
        if not torch.isfinite(getattr(out, name)).all():
            raise AssertionError(f"{what}: non-finite {name}")


def _dims(name):
    m = _spec(name).model
    return m.nx, m.nu


def ipm_launcher(lib, qp, idxbu, idxbx, iters):
    """A call of `lib`'s K3 C entry on the contiguous CUDA LaneQP `qp` with
    its outputs and scratch allocated once (the kernel's time without the
    wrapper's checks and allocations, and not counted as a launch).
    Returns (call, (dx, du, gap, eq_res))."""
    import ctypes

    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build, ipm
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    structure = (nx, nu, len(idxbu), len(idxbx), qp.Ch.shape[1],
                 qp.Cs.shape[1])
    opts = dict(dtype=qp.A.dtype, device=qp.A.device)
    out = [torch.empty(shape, **opts) for shape in (
        (N + 1, nx, L), (N, nu, L), (L,), (L,))]
    scratch = torch.empty((lib.nmpc_fused_ipm_scratch(*structure, N) * L,),
                          **opts)
    tensors = [getattr(qp, f) for f in ipm._LANE_FIELDS + ipm._STATIC_FIELDS]
    *ptrs, stream = _build.launch_args(qp.A.device, *tensors, *out, scratch)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    args = (int(qp.A.dtype == torch.float64), *structure, N, L, iters, 0.995,
            0.1, 1.0, (ctypes.c_int * max(len(idxbu), 1))(*idxbu),
            (ctypes.c_int * max(len(idxbx), 1))(*idxbx), ptr_array, stream)

    def call():
        _build.check(lib.nmpc_fused_ipm_lanes(*args), "fused_ipm_lanes")
    return call, out


def fused_qp(name, L, dtype, seed):
    """(LaneQP, idxbu, idxbx) of the fused solver's own assembly at the
    OCP's default scenario, perturbed, at the builder's N on the card."""
    from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import contiguous_qp
    solver, st, x, p, lh, refs = _setup(name, L, dtype, DEVICE, _fused(),
                                        seed=seed)
    qp = contiguous_qp(solver._build_qp(st, x, p, lh, **refs))
    return qp, solver.idxbu, solver.idxbx


def structure_of(qp, idxbu, idxbx):
    return (qp.A.shape[1], qp.B.shape[2], len(idxbu), len(idxbx),
            qp.Ch.shape[1], qp.Cs.shape[1])


# (L, dtype name) at which K3 is timed here (tools/k3_compare.py adds
# float64 at 512)
K3_TIMED = ((1, "float32"), (128, "float32"), (B, "float32"))
K3_ITERS = 12
# K3's structures, each named by the first model that runs it, with the
# models whose main paths run it (usv_position_control shares
# usv_low_level's (8, 2, 2, 5, 0, 0))
K3_STRUCTURES = {FLAGSHIP: (FLAGSHIP,), HULL: (HULL,), PF: (PF,),
                 LOW_LEVEL: (LOW_LEVEL, POSITION), ACADOS: (ACADOS,),
                 **{name: (name,) for name in GUIDANCE},
                 "race_cars_track": ("race_cars_track", "race_cars"),
                 "race_cars_dev_track": ("race_cars_dev_track",)}


def _fused_nan_lane(name, qp, idxbu, idxbx, s_got, lane=7):
    """One NaN in lane 7's dx0: status 2 from the kernel and the plain
    version, every other lane's status unchanged."""
    from mpc_collisionavoidance_tpu_torch.kernels import ipm
    from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
        fused_ipm_lanes_plain, lane_status)
    bad = qp._replace(dx0=qp.dx0.clone())
    bad.dx0[0, lane] = float("nan")
    sb = [lane_status(*fn(bad, idxbu, idxbx, iters=K3_ITERS), 1e-7)
          for fn in (ipm.fused_ipm_lanes_cuda, fused_ipm_lanes_plain)]
    keep = [i for i in range(len(s_got)) if i != lane]
    print(f"K3 {name} NaN lane {lane}: status {int(sb[0][lane])} (kernel), "
          f"{int(sb[1][lane])} (plain)")
    if int(sb[0][lane]) != 2 or int(sb[1][lane]) != 2 or \
            not bool((sb[0][keep] == s_got[keep]).all()):
        raise AssertionError(f"K3 {name}: NaN lane not status 2, or it "
                             "touched others")


def check_fused_ipm():
    """K3 vs fused_ipm_lanes_plain on the card, the NaN lane, and K3's
    times beside its bound, on every model's QP at its builder's N;
    returns {model: dict(err32, err64, ms (L=512 float32), plain_ms,
    bound_ms, bound_by, times {L: (ms, bound_ms)})}."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build, ipm
    from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
        fused_ipm_lanes_plain, lane_status)
    iters, tol = K3_ITERS, 1e-7
    lib = _build.library()
    result = {}
    for name in [m for models in K3_STRUCTURES.values() for m in models]:
        worst = {torch.float32: 0.0, torch.float64: 0.0}
        for L in (1, 130, B):
            for dtype in (torch.float64, torch.float32):
                qp, iu, ix = fused_qp(name, L, dtype, seed=L)
                args = (qp, iu, ix)
                got = ipm.fused_ipm_lanes_cuda(*args, iters=iters)
                want, want_ms = _timed(lambda: fused_ipm_lanes_plain(
                    *args, iters=iters))
                torch.cuda.synchronize()
                s_got, s_want = (lane_status(*o, tol) for o in (got, want))
                err = _max_err(got[:2], want[:2])
                du_err = float((got[1] - want[1]).abs().max())
                gap_rel = float(((got[2] - want[2]).abs()
                                 / want[2].abs().clamp_min(1e-300)).max())
                share = [float((s == 0).double().mean())
                         for s in (s_got, s_want)]
                print(f"K3 fused IPM {name} L={L} {str(dtype)[6:]}: "
                      f"max|err| dx/du {err:.3e}, du {du_err:.3e}, gap rel "
                      f"{gap_rel:.3e}, status-0 {share[0]:.4f} vs "
                      f"{share[1]:.4f}, status identical "
                      f"{bool(torch.equal(s_got, s_want))}")
                if not all(torch.isfinite(g).all() for g in got):
                    raise AssertionError(f"K3 {name} L={L}: non-finite")
                if dtype == torch.float64:
                    worst[dtype] = max(worst[dtype], err)
                    _check_close(f"K3 {name} dx/du L={L} float64", got[:2],
                                 want[:2], 0.0, 1e-9)
                    _check_close(f"K3 {name} gap L={L} float64", got[2:3],
                                 want[2:3], 1e-9, 0.0)
                    if not torch.equal(s_got, s_want):
                        raise AssertionError(f"K3 {name} L={L} float64: "
                                             "status differs")
                else:
                    worst[dtype] = max(worst[dtype], du_err)
                    if du_err > 5e-3 or abs(share[0] - share[1]) > 0.02:
                        raise AssertionError(
                            f"K3 {name} L={L} float32: du err {du_err:.3e} "
                            f"(limit 5e-3), status-0 shares {share}")
                if L == B and dtype == torch.float32:
                    plain_ms = want_ms
                    _fused_nan_lane(name, *args, s_got)
        times = {}
        for L, dname in K3_TIMED:
            dtype = getattr(torch, dname)
            qp, iu, ix = fused_qp(name, L, dtype, seed=1)
            ms = launch_ms(ipm_launcher(lib, qp, iu, ix, iters)[0],
                           launches=10)
            item, N = qp.A.element_size(), qp.B.shape[0]
            bound_ms, by = bound(*ipm_work(N, structure_of(qp, iu, ix), L,
                                           iters, item), item)
            times[L] = (ms, bound_ms)
            print(f"K3 {name} N={N} L={L} {dname}, {iters} iterations: "
                  f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
                  f"{100 * bound_ms / ms:.2f}% of the bound")
        print(f"K3 {name} plain version at L={B} float32: {plain_ms:.4f} ms")
        result[name] = dict(err32=worst[torch.float32],
                            err64=worst[torch.float64], ms=times[B][0],
                            plain_ms=plain_ms, bound_ms=times[B][1],
                            bound_by=by, times=times)
    return result


def card_vs_cpu_tick(name, Bn, config=None):
    """One float64 tick (the production schedule unless `config` says
    otherwise) on the card vs the plain path on the CPU from the same
    inputs."""
    import torch
    config = config or _production()
    solver, st, x, p, lh, refs = _setup(name, Bn, torch.float64, DEVICE,
                                        config)
    st, out = solver.step_fn(st, x, p, lh, **refs)
    solver_c, st_c, x_c, p_c, lh_c, refs_c = _setup(
        name, Bn, torch.float64, "cpu", config)
    t0 = time.perf_counter()
    st_c, out_c = solver_c.step_fn(st_c, x_c, p_c, lh_c, **refs_c)
    cpu_s = time.perf_counter() - t0
    _check_output(out, Bn, f"{name} float64 card tick", *_dims(name))
    du0 = float((out.u0.cpu() - out_c.u0).abs().max())
    dx1 = float((out.x1.cpu() - out_c.x1).abs().max())
    same_status = bool((out.status.cpu() == out_c.status).all())
    print(f"{name} {solver.riccati} tick B={Bn} float64, card vs CPU plain "
          f"({cpu_s:.1f} s): "
          f"max|du0| {du0:.3e}, max|dx1| {dx1:.3e}, status identical "
          f"{same_status}, status-0 "
          f"{float((out.status == 0).double().mean()):.3f}")
    if du0 > 5e-6 or dx1 > 5e-6 or not same_status:
        raise AssertionError(f"{name}: float64 card tick disagrees with the "
                             "CPU plain tick")


def main_path_tick(name, config, expect):
    """One float32 tick at B=512 with every launch count set to 0 just
    before and read just after; `expect(counts)` gates the counts.  The
    tick before it captures the graph that the counted tick replays."""
    import torch
    solver, st, x, p, lh, refs = _setup(name, B, torch.float32, DEVICE,
                                        config)
    st0 = type(st)(*(t.clone() for t in st))
    solver.step_fn(st, x, p, lh, **refs)             # captures
    _reset_counts()
    st, out = solver.step_fn(st0, x, p, lh, **refs)  # the main path
    counts = _read_counts()
    _check_output(out, B, f"{name} float32 card tick", *_dims(name))
    print(f"{name} {solver.riccati} tick B={B} float32: launches {counts}, "
          f"max gap {float(out.gap.max()):.3e}, status-0 "
          f"{float((out.status == 0).float().mean()):.3f}")
    if not expect(counts):
        raise AssertionError(f"{name} {solver.riccati} main path launch "
                             f"counts {counts}")
    return counts


def closed_loop(name, config, gate, ticks=30, failed_ok=False):
    """Warm-started closed loop at B=512, x0 <- x1.  Every output must be
    finite, except, with `failed_ok`, on the lanes the solver itself
    reports as failed (status 2), which are counted."""
    import torch
    solver, st, x, p, lh, refs = _setup(name, B, torch.float32, DEVICE,
                                        config)
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh, **refs)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    failed = out.status == 2
    if failed_ok:
        ok = ~failed
        out = out._replace(u0=out.u0[:, ok], x1=out.x1[:, ok],
                           gap=out.gap[ok])
    _check_output(out, int(out.gap.numel()), f"{name} closed loop",
                  *_dims(name))
    frac = float((out.gap < 1e-5).sum()) / B
    tick_ms = float(np.median(times[2:]))
    print(f"{name} {solver.riccati} closed loop {ticks} ticks B={B} float32: "
          f"converged_frac {frac:.4f} ({int(failed.sum())} lanes status 2), "
          f"median tick {tick_ms:.3f} ms "
          f"({B / tick_ms * 1e3:.1f} solves/s), first tick "
          f"{times[0]:.3f} ms")
    if gate and frac <= 0.9:
        raise AssertionError(f"{name} closed loop converged_frac {frac} "
                             "<= 0.9")
    return tick_ms, frac


def latency_b1(name, config, budget_ms, ticks=50, versus=None):
    """Single-vehicle tick latency (printed against the budget, not
    gated; `budget_ms` None for a model with no node, which `versus`, if
    given, names something to print it beside: (what, ms))."""
    import torch
    solver, st, x, p, lh, refs = _setup(name, 1, torch.float32, DEVICE,
                                        config)
    for _ in range(3):                                 # warm-up
        st, out = solver.step_fn(st, x, p, lh, **refs)
        x = out.x1
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh, **refs)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    _check_output(out, 1, f"{name} B=1 latency", *_dims(name))
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    verdict = ("no budget (no node)" if budget_ms is None else
               f"vs the {budget_ms:.0f} ms budget: "
               f"{'within' if p99 < budget_ms else 'OVER'}")
    if versus is not None:
        verdict += f", beside the {versus[0]} of {versus[1]:g} ms"
    print(f"{name} {solver.riccati} B=1 tick float32: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms {verdict}")
    return float(p50), float(p99)


def mission(ticks=1000):
    """The reference's 1000-tick flagship closed loop from a cold start."""
    import torch
    solver, st, x, p, lh, _ = _setup(FLAGSHIP, B, torch.float32, DEVICE,
                                     _production())
    fracs, worst = [], []
    t0 = time.perf_counter()
    for _ in range(ticks):
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
        fracs.append((out.gap < 1e-5).float().mean())
        worst.append(out.gap.max())
    fr = torch.stack(fracs).cpu().numpy()
    gmax = torch.stack(worst).cpu().numpy()
    wall = time.perf_counter() - t0
    if not np.all(np.isfinite(gmax)):
        raise AssertionError("mission: non-finite gaps")
    frac = float(fr.mean())
    print(f"mission {ticks} ticks B={B} float32: mission_converged_frac "
          f"{frac:.4f}, worst gap {gmax.max():.3e} at tick "
          f"{int(np.argmax(gmax))}, {wall:.1f} s "
          f"({B * ticks / wall:.1f} solves/s)")
    if frac <= 0.9:
        raise AssertionError(f"mission_converged_frac {frac} <= 0.9")
    return frac


# ---- phase 11: the real-time server ----

@contextlib.contextmanager
def _serving(**kw):
    """The port's RTServer on a Unix socket, warmed up, its event loop on
    a background thread; stopped (solve thread included) on exit."""
    import asyncio

    from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
    tmp = tempfile.mkdtemp(prefix="nmpc_rt")
    server = RTServer(os.path.join(tmp, "rt.sock"), device=DEVICE,
                      max_batch=SERVER_LANES, batch_window_ms=2.0, **kw)
    server.warmup()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        yield server
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _count_phases(server):
    """Wrap the server's device phases (`_tick`, `_feedback`, `_prepare`)
    to record the launch counts of every call, read on the solve thread
    around it; returns {phase: [counts of each call]}."""
    calls = {}
    for phase in ("tick", "feedback", "prepare"):
        def run(*args, fn=getattr(server, "_" + phase),
                log=calls.setdefault(phase, [])):
            before = _launch_counts()
            out = fn(*args)
            after = _launch_counts()
            log.append({k: after[k] - before[k] for k in after})
            return out
        setattr(server, "_" + phase, run)
    return calls


def _served(label, drive, expect, **kw):
    """Serve `kw`'s configuration, run `drive(server)` with every launch
    count set to 0 just before and read just after, and gate each device
    phase call with `expect[phase]` (a phase not in `expect` must not
    run).  Returns (the run's launch counts, what `drive` returned)."""
    with _serving(**kw) as server:
        calls = _count_phases(server)
        _reset_counts()
        result = drive(server)
        server._executor.submit(int).result()   # a preparation in flight
        counts = _read_counts()
    for phase, got in calls.items():
        want = expect.get(phase)
        if got:
            per = {k: [c[k] for c in got] for k in got[0]}
            print(f"  {label}: {len(got)} {phase} calls, launches per call "
                  + ", ".join(f"{k} {min(v)}..{max(v)} (mean "
                              f"{np.mean(v):.2f})" for k, v in per.items()))
        if (want is None) != (not got) or not all(map(want or bool, got)):
            raise AssertionError(f"{label}: {phase} launch counts per call "
                                 f"{got[:4]} (of {len(got)})")
    print(f"  {label}: launches {counts}")
    return counts, result


def _connect(path):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(120)
    s.connect(path)
    return s


def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise AssertionError("the server closed the connection")
        buf += chunk
    return buf


def _checked(resp, seq):
    """A reply echoes its seq, has status 0 (converged) or 1 (not yet), and
    finite numbers."""
    if resp.seq != seq or resp.status not in (0, 1) \
            or not np.all(np.isfinite(np.r_[resp.u0, resp.x1])):
        raise AssertionError(f"bad reply to request {seq}: {resp}")
    return resp


def _send1(s, seq, x0, p, lh):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    s.sendall(protocol.pack_request(protocol.Request(
        seq=seq, x0=tuple(x0), p_obs=p, r_obs=lh)))


def _reply1(s, seq):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    return _checked(protocol.unpack_response(_recv(s, protocol.RESP_SIZE)),
                    seq)


def _solve2(s, seq, x0, p, lh, yref, model):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    s.sendall(protocol.pack_request2(protocol.Request2(
        seq=seq, model_id=protocol.MODEL_IDS[model], x0=tuple(x0), params=p,
        lh=lh, yref=yref)))
    hdr = _recv(s, protocol.RESP2_HDR_SIZE)
    nu, nx = struct.unpack(protocol.RESP2_HDR_FMT, hdr)[3:]
    return _checked(protocol.unpack_response2(hdr, _recv(s, 4 * (nu + nx))),
                    seq)


def _client_loop(path, ticks, solve, x0):
    """`ticks` closed-loop requests on one connection (the next x0 is the
    reply's x1); returns (the replies, client-timed request->reply ms)."""
    replies, ms = [], []
    with contextlib.closing(_connect(path)) as s:
        for seq in range(ticks):
            t0 = time.perf_counter()
            replies.append(solve(s, seq, x0))
            ms.append((time.perf_counter() - t0) * 1e3)
            x0 = replies[-1].x1
    return replies, ms


def _pcts(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _build_rt_demo():
    """The unchanged C++ client's closed-loop demo, built with g++ into
    build/rt_client/ (no cmake: the card's host may lack it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise AssertionError("g++ not found: the C++ client phase cannot "
                             "run")
    src, out = REPO / "rt_client", REPO / "build" / "rt_client"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{src}",
                    str(src / "rt_demo.cpp"), str(src / "nmpc_rt_client.cpp"),
                    "-o", str(out / "rt_demo")], check=True, timeout=300)
    return out / "rt_demo"


def _run_rt_demo(demo, path, ticks):
    """`rt_demo <socket> <ticks>`: exit 0 and final |ye| < 0.5."""
    proc = subprocess.run([str(demo), path, str(ticks)], capture_output=True,
                          text=True, timeout=900)
    last = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"  rt_demo {ticks} ticks: exit {proc.returncode}, {last[0]}")
    if proc.returncode != 0 or "final_ye" not in proc.stdout:
        raise AssertionError(f"rt_demo failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    final_ye = float(proc.stdout.rsplit("final_ye", 1)[1])
    if abs(final_ye) >= 0.5:
        raise AssertionError(f"rt_demo final |ye| {abs(final_ye)} >= 0.5")


def _flagship_served(card, x0, p, lh, solve1):
    """The flagship production server: the first tick, B=1 and the fleet
    of 8.  Returns the first reply."""
    def drive(server):
        first = _client_loop(server.path, 1, solve1, x0)[0][0]
        warm = 5
        n0 = len(server.solve_ms)
        _, totals = _client_loop(server.path, 200, solve1, x0)
        solves = list(server.solve_ms)[n0:]
        if len(solves) != 200:
            raise AssertionError(f"B=1: {len(solves)} ticks for 200 requests")
        over = [t - s for t, s in zip(totals[warm:], solves[warm:])]
        b1, sv, ov = _pcts(totals[warm:]), _pcts(solves[warm:]), _pcts(over)
        print(f"served flagship B=1, 200 ticks: rt_b1_p50 {b1[0]:.3f} ms, "
              f"rt_b1_p99 {b1[1]:.3f} ms, rt_b1_solve_p50 {sv[0]:.3f} ms, "
              f"rt_b1_overhead_p50 {ov[0]:.3f} ms, rt_b1_overhead_p99 "
              f"{ov[1]:.3f} ms ({card})")
        xs, fleet = [x0] * 8, []
        n0 = len(server.solve_ms)
        with contextlib.ExitStack() as stack:
            socks = [stack.enter_context(contextlib.closing(
                _connect(server.path))) for _ in range(8)]
            for seq in range(100):
                t0 = time.perf_counter()
                for s, x in zip(socks, xs):
                    _send1(s, seq, x, p, lh)
                xs = [_reply1(s, seq).x1 for s in socks]
                fleet.append((time.perf_counter() - t0) * 1e3)
        f8 = _pcts(fleet[warm:])
        print(f"served flagship fleet of 8, 100 lockstep ticks: "
              f"rt_fleet8_p50 {f8[0]:.3f} ms, rt_fleet8_p99 {f8[1]:.3f} ms, "
              f"{len(server.solve_ms) - n0} server ticks ({card})")
        return first

    return _served("flagship sweep server", drive,
                   {"tick": _production_counts}, model=FLAGSHIP, N=100,
                   Tf=5.0, **_server_engine())


def _server_engine(**flags):
    """The server's engine arguments for the given CLI flags (unset ones:
    the production schedule)."""
    from mpc_collisionavoidance_tpu_torch.rt.server import resolve_engine_args
    return resolve_engine_args(**flags)


def server_vs_solver(first, x0, p, lh):
    """The first served tick of a lane (lane 0 of a fresh server, the other
    lanes parked) against `LaneRTISolver.step_fn` on the same packed rows
    on the card."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver
    spec = builders.build(FLAGSHIP, Tf=5.0, N=100)
    nx, ne = spec.model.nx, len(np.asarray(spec.cost.yref_e))
    solver = LaneRTISolver(spec, **_server_engine(), device=DEVICE,
                           dtype=torch.float32)
    L = SERVER_LANES
    rows = np.concatenate([
        np.zeros((L, nx), np.float32), np.full((L, len(p)), 100.0, np.float32),
        np.zeros((L, len(lh)), np.float32),
        np.broadcast_to(np.asarray(spec.cost.yref, np.float32),
                        (L, spec.cost.ny))], axis=1)
    rows[0, :nx + len(p) + len(lh)] = np.r_[x0, p, lh]
    d = torch.from_numpy(rows).to(DEVICE)
    xL, pL = d[:, :nx].T, d[:, nx:nx + len(p)].T
    lhL, yL = d[:, nx + len(p):nx + len(p) + len(lh)].T, \
        d[:, nx + len(p) + len(lh):].T
    _, out = solver.step_fn(solver.init_state(rows[:, :nx]), xL, pL, lhL,
                            yref=yL, yref_e=yL[:ne])
    err = max(abs(first.u0 - float(out.u0[0, 0])),
              float(np.abs(np.subtract(first.x1,
                                       out.x1[:, 0].cpu().numpy())).max()))
    same = first.status == int(out.status[0])
    print(f"served flagship first tick vs step_fn on the same rows: max "
          f"|err| u0/x1 {err:.3e}, status {first.status} vs "
          f"{int(out.status[0])}")
    if err > 1e-6 or not same:
        raise AssertionError("the server's reply differs from step_fn")


def _latency_drive(label, ticks, solve, x0, card):
    def drive(server):
        _, ms = _client_loop(server.path, ticks, solve, x0)
        p50, p99 = _pcts(ms[1:])
        print(f"served {label}, {ticks} ticks: request->reply p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms ({card})")
    return drive


def serving(card):
    """Phase 11: the port's RT server on the card.  Returns {(model,
    label): launch counts} of its main-path runs."""
    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    x0, p, lh = (tuple(float(v) for v in np.asarray(a, np.float32))
                 for a in (sc.x0, sc.params, sc.lh))
    demo = _build_rt_demo()

    def solve1(s, seq, x):
        _send1(s, seq, x, p, lh)
        return _reply1(s, seq)

    counts = {}
    counts[(FLAGSHIP, "served sweep")], first = _flagship_served(
        card, x0, p, lh, solve1)
    server_vs_solver(first, x0, p, lh)

    def k1_per_iteration(iters):
        return lambda c: (c["riccati_lanes"] == 2 * iters
                          and c["linearize_lanes"] == 1
                          and c["fused_ipm_lanes"] == 0)

    def mehrotra_production(c):
        # 4 fixed + up to 24 escalation iterations, two sweeps each
        return (c["riccati_lanes"] % 2 == 0
                and 8 <= c["riccati_lanes"] <= 56
                and c["linearize_lanes"] == 1 and c["fused_ipm_lanes"] == 0)

    for label, flags, expect in (
            ("mehrotra", dict(centering="mehrotra"), mehrotra_production),
            ("mehrotra, 8 iterations",
             dict(centering="mehrotra", ipm_iters=8, extra_iters=0),
             k1_per_iteration(8))):
        counts[(FLAGSHIP, "served " + label)], _ = _served(
            f"flagship {label} server",
            _latency_drive(f"flagship {label}", 20, solve1, x0, card),
            {"tick": expect}, model=FLAGSHIP, N=100, Tf=5.0,
            **_server_engine(**flags))
    counts[(FLAGSHIP, "served fused")], _ = _served(
        "flagship fused server",
        _latency_drive("flagship fused", 20, solve1, x0, card),
        {"tick": _fused_counts}, model=FLAGSHIP, N=100, Tf=5.0,
        **dataclasses.asdict(SolverConfig(riccati="fused")))

    hsc = scenarios.pf_ca_default()
    hx0, hp, hlh, hy = (tuple(float(v) for v in np.asarray(a, np.float32))
                        for a in (hsc.x0, hsc.params, hsc.lh, hsc.yref))

    def solve2(s, seq, x):
        return _solve2(s, seq, x, hp, hlh, hy, HULL)

    def feedback(c):
        return (c["riccati_lanes"] >= 4 and c["linearize_lanes"] == 0
                and c["fused_ipm_lanes"] == 0)

    def prepare(c):
        return (c["linearize_lanes"] == 1 and c["riccati_lanes"] == 0
                and c["fused_ipm_lanes"] == 0)

    counts[(HULL, "served rti_split")], _ = _served(
        "hull v2 rti_split server",
        _latency_drive("hull v2 rti_split", 50, solve2, hx0, card),
        {"tick": _production_counts, "feedback": feedback,
         "prepare": prepare}, model=HULL, N=100, Tf=1.0, rti_split=True,
        **_server_engine())
    c = counts[(HULL, "served rti_split")]
    # one joining tick in full, 49 feedback ticks, 50 preparations
    if c["linearize_lanes"] != 51:
        raise AssertionError(f"hull rti_split: {c} (K2 = 1 joining tick + "
                             "50 preparations expected)")
    served_cli(demo)
    return counts


def served_cli(demo):
    """`python -m mpc_collisionavoidance_tpu_torch.rt.server --device cuda`
    in its own process (the entry point a deployment starts), driven by
    the C++ client's rt_demo for the reference's 1000 ticks, then
    terminated."""
    tmp = tempfile.mkdtemp(prefix="nmpc_cli")
    path = os.path.join(tmp, "rt.sock")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpc_collisionavoidance_tpu_torch.rt.server",
         path, "--device", DEVICE], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        while not os.path.exists(path):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the server process did not start: "
                                     f"{proc.communicate(timeout=60)[0]}")
            time.sleep(0.1)
        print(f"served from the command line: listening after "
              f"{time.perf_counter() - t0:.1f} s")
        _run_rt_demo(demo, path, 1000)
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 12: the hull family's models with no rows ----

# models whose fused (fixed-schedule) closed loop is gated: JAX's lane
# engine at that schedule, float32 on the CPU at B=8, leaves
# usv_position_control (weights of 1e5, mu0 = 1) at converged_frac 0.625.
# usv_acados' loops at B=512 lose a few lanes to status 2 near tick 20-22
# in float32 (its thrusts reach their 35 box), in JAX's lane engine on the
# CPU as in the port, on both schedules (tests/test_torch_hull_family.py::
# test_jax_usv_acados_loop_at_full_width): those lanes may be non-finite.
FUSED_GATED = (PF, LOW_LEVEL, ACADOS)


def hull_family(card):
    """Phase 12: usv_pf, usv_low_level, usv_acados, usv_position_control at
    their builders' N, tracking their scenarios' references: the float64
    card tick vs the CPU plain tick at B=32; the float32 production and
    fused ticks at B=512 with their launch counts; 30-tick closed loops of
    both backends (converged_frac gated > 0.9 where JAX's lane engine
    meets it on the CPU in float32 at B=8: every production loop, the
    fused loops of FUSED_GATED); B=1 latency of both against each model's
    budget (printed, 20 ticks); then usv_low_level served over v2 frames.
    Returns {(model, label): launch counts} of its main-path runs."""
    counts = {}
    for name in FAMILY:
        card_vs_cpu_tick(name, FAMILY_CPU_B)
        for label, config, expect in (
                ("sweep", _production(), _production_counts),
                ("fused", _fused(), _fused_counts)):
            counts[(name, label)] = main_path_tick(name, config, expect)
            closed_loop(name, config,
                        gate=label == "sweep" or name in FUSED_GATED,
                        failed_ok=name == ACADOS)
            latency_b1(name, config, FAMILY_BUDGET_MS[name],
                       ticks=FAMILY_B1_TICKS)
    counts[(LOW_LEVEL, "served v2")] = served_v2(card, LOW_LEVEL)
    return counts


def served_v2(card, model, ticks=20):
    """`model` at its builder's N and Tf (production schedule) over v2
    frames: its scenario's x0, obstacle parameters and lh in every request
    (none for a model with no rows; usv_guidance_ca's 16 and 8, hard
    rows), and the scenario's yref where it has one (else the builder's):
    `ticks` closed-loop requests, every reply checked, every served tick
    K2 = 1, K1 >= 4."""
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    spec = builders.build(model)
    sc = scenarios.DEFAULTS[model][0]()
    x0, p, lh, yref = (
        tuple(float(v) for v in np.asarray(a, np.float32))
        for a in (sc.x0, sc.params, sc.lh,
                  () if sc.yref is None else sc.yref))

    def solve2(s, seq, x):
        return _solve2(s, seq, x, p, lh, yref, model)

    c, _ = _served(f"{model} v2 server",
                   _latency_drive(f"{model} v2", ticks, solve2, x0, card),
                   {"tick": _production_counts}, model=model, N=spec.N,
                   Tf=spec.Tf, **_server_engine())
    if c["linearize_lanes"] != ticks:
        raise AssertionError(f"{model} served: {c} ({ticks} ticks of K2 = "
                             "1 expected)")
    return c


# ---- phase 13: the kinematic guidance family ----

def guidance_family(card):
    """Phase 13: usv_guidance_ca, usv_guidance, usv_guidance2..5 at their
    builders' N=100 from their scenarios: the float64 card tick vs the CPU
    plain tick at B=32; the float32 production and fused ticks at B=512
    with their launch counts; 30-tick closed loops of both backends, all
    gated (converged_frac > 0.9: JAX's lane engine meets it on the CPU in
    float32 on every one, tests/test_torch_guidance_family.py::
    test_jax_float32_closed_loop_converges); B=1 latency of both against
    each node's budget (printed, 20 ticks); then usv_guidance_ca served
    over v2 frames.  Returns {(model, label): launch counts} of its
    main-path runs."""
    counts = {}
    for name in GUIDANCE:
        card_vs_cpu_tick(name, FAMILY_CPU_B)
        for label, config, expect in (
                ("sweep", _production(), _production_counts),
                ("fused", _fused(), _fused_counts)):
            counts[(name, label)] = main_path_tick(name, config, expect)
            closed_loop(name, config, gate=True)
            latency_b1(name, config, GUIDANCE_BUDGET_MS[name],
                       ticks=FAMILY_B1_TICKS)
    counts[(GUIDANCE_CA, "served v2")] = served_v2(card, GUIDANCE_CA)
    return counts


# ---- phase 14: the race car ----

def race_family(card):
    """Phase 14: race_cars and race_cars_dev at their builders' N=50 from
    the race scenario (n perturbed), on the synthetic curved track: the
    float64 production and fused ticks on the card vs the CPU plain ticks
    at B=512; for them and for race_cars on the straight track (`RACE`),
    the float32 production and fused ticks at B=512 with their launch
    counts, 30-tick closed loops (converged_frac gated > 0.9 where JAX's
    lane engine meets it on the CPU in float32: every production loop and
    the curved track's fused loops, tests/test_torch_race_cars.py::
    test_jax_float32_closed_loop; on the curved track the lanes flagged
    with status 2 may be non-finite, as in JAX's at B=512,
    test_jax_race_loop_at_full_width) and B=1 latency printed beside the
    shooting interval (20 ticks); then race_cars served over v2 frames on
    the straight track.  Returns {(run, label): launch counts} of its
    main-path runs."""
    counts = {}
    for name in ("race_cars_track", "race_cars_dev_track"):
        for config in (_production(), _fused()):
            card_vs_cpu_tick(name, B, config)
    for name in RACE:
        for label, config, expect in (
                ("sweep", _production(), _production_counts),
                ("fused", _fused(), _fused_counts)):
            counts[(name, label)] = main_path_tick(name, config, expect)
            gated = label == "sweep" or RACE[name][1]
            # on the curved track a few lanes go non-finite in float32 at
            # B=512 with status 2, in JAX's lane engine on the CPU as in
            # the port (tests/test_torch_race_cars.py::
            # test_jax_race_loop_at_full_width): those lanes are counted
            _, frac = closed_loop(name, config, gate=gated,
                                  failed_ok=RACE[name][1])
            if not gated:
                print(f"{name} fused closed loop: converged_frac {frac:.4f} "
                      "(not gated; JAX's lane engine leaves 3 of 8 lanes "
                      "of this start unconverged at this schedule)")
            latency_b1(name, config, None, ticks=FAMILY_B1_TICKS,
                       versus=("shooting interval Tf/N", RACE_INTERVAL_MS))
    counts[("race_cars", "served v2")] = served_v2(card, "race_cars")
    return counts


# ---- phase 15: captured ticks against eager ones ----

def _bits(t):
    """The tensor's bits, for a bitwise comparison that NaN passes."""
    import torch
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.contiguous().view(as_int.get(t.dtype, t.dtype))


def _bitwise(what, got, want):
    import torch
    for field in ("u0", "x1", "gap", "status"):
        g, w = getattr(got, field), getattr(want, field)
        if g.shape != w.shape or not torch.equal(_bits(g), _bits(w)):
            err = float((g.double() - w.double()).abs().nan_to_num().max())
            raise AssertionError(f"{what}: captured {field} differs from "
                                 f"the eager tick's (max |err| {err:.3e})")


def _replay(solver, call):
    """`call()` under torch.cuda.set_sync_debug_mode("error") (a sync in
    it raises); returns (its result, the graph launches it made)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.solver import capture
    _sync()
    n0 = capture.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, capture.launches - n0


def captured_vs_eager(name, label, config, dtype):
    """Phase 15 for one run, backend and dtype at B=512: the captured tick
    (its capturing call, then a replay from the same state with no sync
    and one graph launch) bitwise equal to the eager tick from the same
    inputs, with the same escalation count; in float32 the RTI split too.
    Returns the program's capture figures."""
    import torch
    eager, st, x, p, lh, refs = _setup(name, B, dtype, DEVICE, config,
                                       capture=False)
    solver = _setup(name, B, dtype, DEVICE, config)[0]
    what = f"{name} {label} {str(dtype)[6:]}"
    _, want = eager.step_fn(st, x, p, lh, **refs)
    k_eager = int(eager.last_esc_iters)
    _, got = solver.step_fn(st, x, p, lh, **refs)      # captures
    _bitwise(what + " capturing call", got, want)
    k = int(solver.last_esc_iters)
    (_, got), graphs = _replay(
        solver, lambda: solver.step_fn(st, x, p, lh, **refs))
    _bitwise(what + " replay", got, want)
    k_replay = int(solver.last_esc_iters)
    if not k == k_replay == k_eager or graphs != 1:
        raise AssertionError(f"{what}: escalation {k}, {k_replay} (eager "
                             f"{k_eager}), {graphs} graph launches")
    (program,) = solver._graphs.programs.values()
    split = ""
    if dtype == torch.float32:
        qp = eager.prepare_fn(st, p, lh, **refs)
        _, want = eager.feedback_fn(st, qp, x)
        qp = solver.prepare_fn(st, p, lh, **refs)      # captures
        solver.feedback_fn(st, qp, x)                  # captures
        qp, n_prep = _replay(solver, lambda: solver.prepare_fn(
            st, p, lh, **refs))
        (_, got), n_feed = _replay(solver, lambda: solver.feedback_fn(
            st, qp, x))
        _bitwise(what + " feedback replay", got, want)
        if (n_prep, n_feed) != (1, 1):
            raise AssertionError(f"{what}: {n_prep} preparation, {n_feed} "
                                 "feedback graph launches")
        split = ", RTI split bitwise (1 + 1 graph launches)"
    print(f"{what}: captured == eager bitwise, escalation {k} = {k_eager}, "
          f"replay with no sync: 1 graph launch{split}; graph "
          f"{program.nodes} nodes ({program.conditional} conditional), "
          f"warm-up {program.warmup_s:.3f} s, capture "
          f"{program.capture_s:.3f} s, instantiate "
          f"{program.instantiate_s:.3f} s, pool "
          f"{program.pool_bytes / 2**20:.1f} MiB")
    return dict(run=name, backend=label, dtype=str(dtype)[6:],
                esc_iters=k, nodes=program.nodes,
                conditional=program.conditional,
                capture_s=program.capture_s,
                instantiate_s=program.instantiate_s,
                pool_mib=program.pool_bytes / 2**20)


def captured_ticks():
    """Phase 15: `captured_vs_eager` for every run of phases 5, 9 and
    12-14, both backends, float32 and float64."""
    import torch
    for name in (FLAGSHIP, HULL, *FAMILY, *GUIDANCE, *RACE):
        for label, config in (("sweep", _production()), ("fused", _fused())):
            for dtype in (torch.float32, torch.float64):
                captured_vs_eager(name, label, config, dtype)


def _production_counts(c):
    return (c["riccati_lanes"] >= 4 and c["linearize_lanes"] == 1
            and c["fused_ipm_lanes"] == 0)


def _fused_counts(c):
    return (c["fused_ipm_lanes"] == 1 and c["linearize_lanes"] == 1
            and c["riccati_lanes"] == 0)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()

    def phase_done(label):
        print(f"[{time.perf_counter() - t0:.1f} s] {label} done")

    card = environment()
    phase_done("phase 1")
    k1 = check_riccati()
    phase_done("phase 2 (K1)")
    k2 = check_linearize()
    phase_done("phase 3 (K2)")
    k3 = check_fused_ipm()
    phase_done("phase 4 (K3)")

    # the flagship production tick
    card_vs_cpu_tick(FLAGSHIP, B)
    counts = {(FLAGSHIP, "sweep"): main_path_tick(FLAGSHIP, _production(),
                                                  _production_counts)}
    closed_loop(FLAGSHIP, _production(), gate=True)
    latency_b1(FLAGSHIP, _production(), 50.0)
    mission()
    phase_done("phases 5-8 (the flagship)")
    # the hull production tick
    card_vs_cpu_tick(HULL, HULL_CPU_B)
    counts[(HULL, "sweep")] = main_path_tick(HULL, _production(),
                                             _production_counts)
    closed_loop(HULL, _production(), gate=True)
    latency_b1(HULL, _production(), 10.0)
    # the fused tick of both OCPs
    for name in (FLAGSHIP, HULL):
        counts[(name, "fused")] = main_path_tick(name, _fused(),
                                                 _fused_counts)
        closed_loop(name, _fused(), gate=name == FLAGSHIP)
        latency_b1(name, _fused(), 50.0 if name == FLAGSHIP else 10.0)
    phase_done("phases 9-10 (the hull, the fused ticks)")
    # the real-time server
    counts.update(serving(card))
    phase_done("phase 11 (serving)")
    # the hull family's models with no rows
    counts.update(hull_family(card))
    phase_done("phase 12 (the hull family)")
    # the kinematic guidance family
    counts.update(guidance_family(card))
    phase_done("phase 13 (the guidance family)")
    # the race car
    counts.update(race_family(card))
    phase_done("phase 14 (the race car)")
    captured_ticks()
    phase_done("phase 15 (captured ticks)")

    def launched(kernel, models):
        return sum(c[kernel] for (m, _), c in counts.items() if m in models)

    pkg = "mpc_collisionavoidance_tpu_torch"
    # no single PyTorch call computes a Riccati sweep, a linearization or
    # an IPM solve: library_ms is null for every kernel
    kernels = []
    for (nx, nu), (_, models) in K1_SHAPES.items():
        r = k1[(nx, nu)]
        kernels.append(
            {"name": f"riccati_lanes[{nx}x{nu}]", "route": "cuda",
             "source": f"{pkg}/csrc/riccati_lanes.cuh",
             "replaces": "mpc_collisionavoidance_tpu/kernels/riccati_pallas.py:215",
             "launches": launched("riccati_lanes", models),
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None})
    for name in k2:
        err32, err64, ms, plain_ms, bound_ms, by = k2[name]
        # the curved race form runs on both race models' curved runs
        runs = ((name,) if name != "race_cars_track"
                else ("race_cars_track", "race_cars_dev_track"))
        kernels.append(
            {"name": f"linearize_lanes[{name}]", "route": "cuda",
             "source": f"{pkg}/csrc/linearize_lanes.cuh",
             "replaces": "mpc_collisionavoidance_tpu/kernels/linearize_pallas.py:151",
             "launches": launched("linearize_lanes", runs),
             "max_abs_err": max(err32, err64), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
             "library_ms": None})
    for name, models in K3_STRUCTURES.items():
        r = k3[name]
        kernels.append(
            {"name": f"fused_ipm_lanes[{','.join(models)}]", "route": "cuda",
             "source": f"{pkg}/csrc/ipm_lanes.cuh",
             "replaces": "mpc_collisionavoidance_tpu/kernels/ipm_pallas.py:53",
             "launches": launched("fused_ipm_lanes", models),
             "max_abs_err": max(k3[m][e] for m in models
                                for e in ("err32", "err64")),
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": None})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
