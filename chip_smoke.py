"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`mpc_collisionavoidance_tpu_torch`) through
their hand-written CUDA kernels, each tick (and preparation, feedback) of
both engines as one captured CUDA graph (`solver/capture.py`), and exits
non-zero if anything fails:
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
   ptxas must report 0 bytes spill stores and loads for the fifty-six
   K1 (thirty-four of the warp design, twenty-two of the CTA design), the
   twenty-eight K2 and the twenty-six K3 instances (`NO_SPILL`);
2. K1 (Riccati sweep) vs its plain PyTorch version on the card: random
   SPD LQRs at each instance's main-path horizons (`K1_SHAPES`: (8, 1),
   (14, 2) at N=100, (8, 2) at N=100 and 20, (5, 2) at N=20, the guidance
   family's (9, 1), (10, 1), (12, 1), (11, 1), (4, 1), (5, 1) at N=100,
   the race car's (6, 2) at N=50, and the macro stages of phase 18's
   condensed QPs: (8, 4) at N=25, (8, 5) at 20, (8, 10) at 10, (14, 4) at
   50, (14, 8) at 25, (6, 4) at 25; the flagship's M=2 runs on (8, 2)),
   L in {1, 130, 512}, float32 (rtol 2e-4, atol 2e-5) and float64 (atol
   1e-10), in both designs where the instance has both (nu <= 2: the warp
   per lane and the CTA per lane; the rule's pick through the wrapper, the
   other through `lqr_solve_lanes_cuda_as`);
   one lane's A set to NaN leaves every other lane's dx/du bitwise
   unchanged, in each design; each instance's time at L in {1, 128, 512}
   float32 and 512 float64 (CUDA events over 50 back-to-back launches of
   the C entry) beside its bound, in each design, with the design the rule
   picks and the faster one (a `phase 2 designs:` JSON line);
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
   QP too) at L = 130 (the ragged block) in float64 and at 512 in
   float32 (`K3_COMPARED`); float64 dx/du atol 1e-9, gap rtol 1e-9,
   identical status; float32 du atol 5e-3 (the float32 gap-floor ball)
   and status-0 shares within 0.02; one NaN lane -> status 2 in both, the
   other lanes' status unchanged; each structure's time at L in {1, 128,
   512} float32 (CUDA events over back-to-back launches of the C entry)
   beside its bound;
5. the flagship production tick at B=512: float64 on the card vs the plain
   path on the CPU from the same inputs (u0/x1 atol 5e-6, identical
   status), then float32 on the card, with the kernels' launch counts for
   that tick (K1 >= 4, K2 = 1, K3 = 0).  The CPU ticks of phases 5-14
   run in a worker process beside those phases (`tick_cpu_references`)
   and are held against the card's after phase 14;
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
16. the per-instance engine (`solver/sqp_rti.py::RTISolver`, the JAX
    package's reference engine, whose step, preparation and feedback
    each replay one captured graph, as phase 15's ticks do): (a)
    `ops/riccati.py::lqr_solve` on CUDA tensors, which flattens the batch
    onto K1's lanes, against the per-instance plain `lqr_solve_plain` on
    the card for (8, 1), (14, 2) at N=100 and (6, 2) at N=50, B in {1,
    64}, float32 (rtol 2e-4, atol 2e-5) and float64 (atol 1e-10); one NaN
    instance leaves the others bitwise unchanged; (3, 1), which has no K1
    instance, raises; (b) `ops/linearize.py::build_qp` on the card (K2)
    against the CPU on the flagship, the hull and the race car on the
    curved track, every QPData field (float32 rtol 2e-4 atol 2e-5,
    float64 atol 1e-10 rtol 1e-12); (c) the committed goldens' 30-tick
    prefixes in float64 on the card at atol 1e-6: all 13 RTI fixtures and
    the converged-SQP ones of the flagship and the hull, captured, and
    the flagship's RTI run also eagerly (`capture=False`), bitwise equal;
    (d) one flagship tick at B=8 of the dense QP backend against the
    Riccati one (atol 5e-6); (e) `RTServer(engine="vmap")` serving the
    flagship over UDS, one vehicle and a fleet of 8, every reply status
    0, then two vehicles taking 10 solo ticks each in turn under
    `rti_split`, replies equal to an eager server's (`capture=False`);
    (f) the captured and the eager tick's median and p99 over 20 and 10
    ticks and the captured one's K1/K2 launches per tick (18 and 1 on the
    Riccati backend, 0 and 1 dense) at B=1 and 64, float32, for the
    flagship and the hull on both QP backends, printed; (g) the captured
    tick against the eager one, bitwise, state and output, step_fn and
    prepare_fn + feedback_fn: the flagship, the hull, `usv_low_level`
    and the race car on the curved track at B=1 (unbatched) and 64,
    float32 and float64; Mehrotra centering on the flagship and the hull
    (K1 36 per replay); the dense backend at (d)'s B=8; each replay with
    no sync, one graph launch, K1 18 and K2 1 counted; the float64
    captured tick against the CPU's plain tick from the same inputs
    (atol 1e-10, identical status; B=1, and the flagship's B=64); two
    states taking 6 ticks each in turn through one captured solver
    against two eager solvers; each program's graph nodes, capture and
    instantiation times and pool bytes printed.  A line `phase 16 table:`
    holds (f)'s times and (g)'s programs.
17. the guidance stack (`guidance/`, `sim/`), eager around the solvers'
    ticks: (a) perception (LiDAR cull, top-8 intake) and the waypoint
    manager at B=512 on the card vs the CPU, float32 (atol 1e-5) and
    float64 (atol 1e-12), identical slot rows, k and active; (b) the main
    path of the slice: `FleetMissionEngine` with the flagship (N=100,
    Tf=5) at B=512 on the captured production tick, float32, over 512
    random 1000-tick missions (`random_missions`, a numpy copy of
    tests/test_random_missions.py whose first 20 are that test's), gated
    on its gates (finite, every mission past its first segment, >= 90%
    done, status-0 share > 0.98, the first 20 within the 0.2 m soft
    clearance band; the other 492's breaches counted and named), K2 one
    and K1 at least 4 per tick, the tick's median/p99 and the share of it
    outside the solver's graph; (c) the same fleet on the fused tick (K3
    and K2 one per tick, K1 none; gates printed); (d) the fleet in
    float64 on the card vs the CPU at B=32 for 20 ticks (atol 5e-6,
    identical status), and its captured log against an eager one,
    bitwise; (e) one boat: `GuidanceController` on `LaneSolverAdapter`
    flies the challenge-0 mission for 1200 ticks (completes within 1.2 m
    of the last waypoint, buoy clearance > 1.3 m, no collision, tick p99
    < 50 ms, each tick synced), its captured log equals an eager one, and
    on `RTISolver` (captured) float64 card vs CPU for 20 ticks at 1e-8
    (K1 18, K2 1 per tick and per capture) and bitwise against the eager
    solver; (f) the cascade (guidance on the adapter, `usv_low_level`
    N=100 on the captured `RTISolver`), 40 guidance ticks (200 inner) in
    float32, both loops' p50/p99 printed beside 50 and 10 ms, 2 guidance
    ticks with the inner solver eager bitwise equal (its p50/p99 beside),
    and 5 guidance ticks float64 card vs CPU at 1e-6; (g) `PFController`
    (usv_pf, N=100), `ThrustMPCController` (usv_acados, N=20) and the six
    variant nodes (N=100), on captured ticks, 20 ticks each float64 card
    vs CPU at 1e-6 with identical status, and 20 float32 captured ticks
    and the first 10 eager (the same measurements, commands bitwise
    equal), both p50/p99 beside each node's budget.
    The float64 CPU runs of (d)-(g) run in one worker process (spawned,
    one thread, started with phase 16, joined before (d)) while the card
    runs phase 16, (a)-(c) and the boat's mission.
18. the lane engine's options on the production schedule: partial
    condensing (`LaneRTISolver(..., condense=M)`: N/M macro stages of
    M nu controls, K1 at (nx, M nu)) for the flagship at M in {2, 4, 5,
    10}, the hull at {2, 4} and race_cars_dev on the curved track at 2
    (`CONDENSE`), and the parallel-scan Riccati (`riccati="pscan"`, plain
    PyTorch, no K1) for the flagship and the hull.  Each condensed run:
    the float64 card tick vs the CPU plain tick (B=64; the hull at
    B=130; u0/x1 atol 5e-6, identical status), the float32 main-path tick
    at B=512 (K1 >= 4 at the macro shape, K2 1, K3 0), a 30-tick closed
    loop (converged_frac > 0.9; the curved race track's status-2 lanes
    counted, as phase 14) and B=1 p50/p99 beside the budget, the M=1
    loop and B=1 tick of the same process beside them.  pscan: the
    float64 card tick vs the card's sweep tick and vs the CPU, the
    float32 main-path tick (K1 0, K2 1, K3 0), 30-tick loops, B=1.  Then
    phase 15's captured-vs-eager check (float32, with the RTI split) for
    the flagship at M=4, the hull and the race car at M=2 and the pscan
    ticks of the flagship and the hull, with each graph's nodes, capture
    and instantiation times.  A line `phase 18 table:` holds its figures.
19. the experiment CLI (`python -m mpc_collisionavoidance_tpu_torch`,
    `cli.py`) as a user runs it: (a) `models` as a subprocess, exit 0 and
    13 models; (b) `run --model usv_guidance_ca1` at its defaults (1000
    steps, N=100, B=1 on the captured production tick, float32) in a
    child interpreter (`MODULE_CHILD`: `runpy.run_module` as `-m` runs it)
    that writes its launches and `device_memory_stats()` at exit: exit 0,
    finite, K2 >= 1 and K1 >= 4 per tick; `compile_plus_run_s`,
    `steady_run_s`, ms per tick and the peak device memory printed; (c)
    `run --config` on the captured per-instance engine in float64
    (`CLI_CONFIGS`: `usv_guidance4` N=10 for 30 steps, the flagship N=100
    for 20), the card's metrics within 1e-9 of the CPU's (run in a worker
    process meanwhile), K1 = iterations and K2 = 1 per tick and per
    capture, and the first config with `--eager`: equal metrics; (d)
    `mission --challenge 0 --markers` (600 ticks on the adapter): 300
    frames read back, no collision, `final_pos` beside the JAX CLI's; (e)
    `race --steps 120` on the captured per-instance engine (float64):
    finite, s_final > 0.3, K1 18 and K2 1 per tick and per capture; then
    `race --steps 20` with and without `--eager`: equal output.
    `--plots` (b, e) and `--gif` (a 40-tick mission) are passed where
    matplotlib imports.
20. the scenario-parallel layer (`parallel/`, `mesh_phase`): (a) one
    rank on a one-rank NCCL mesh, captured ticks: `dryrun_multichip` at
    the flagship's full shape (the lane engine at L=512, the sharded
    per-instance engine at B=4, the escalation tier, a 2-vehicle 30-tick
    fleet mission) with every JAX gate (converged shares > 0.9, the
    engines' u0 within 5e-4, clearance > 0, advance > 0.2 m); then the
    production tick at B=512 float32 with its lanes over the mesh (the
    escalation predicate all-reduced inside the captured graph) bitwise
    equal to the tick without a mesh, the same escalation count, K1 >= 4
    and K2 = 1 counted; (b) two ranks sharing the card (gloo, eager: NCCL
    refuses two ranks on one GPU), each stepping 256 of the escalation
    tier's 512 float64 lanes: within 1e-12 of one process's tick over
    the 512, identical status, the same escalation count on both ranks,
    and `fleet_metrics` equal on both and to one process's.  NCCL across
    GPUs and scaling are not measured: the host has one GPU.
21. the native nodes (`rt_client/`, unchanged, `native_nodes`): (a) g++
    builds `guidance_node_demo`, `cascade_demo` and
    `libnmpc_low_level_node.so` into build/rt_client/ (no cmake); (b) the
    two-leg avoidance mission, `guidance_node_demo <addr> 2500`, against
    an in-process captured flagship server (N=100, Tf=5, 14 fixed IPM
    iterations, 128 lanes) over a Unix socket, and (c) over TCP loopback
    (a free port): exit 0, `switched 1`, `done 1`, exactly K1 14 and K2 1
    per served tick (counted on the solve thread), ticks, wall s, ms per
    tick, the node's worst latency and the server's solve_ms p50/p99
    printed; (d) the native cascade, `cascade_demo g.sock ll.sock 1400`,
    against two captured servers on the one card in this process
    (guidance N=40, Tf=3, 14 iterations; `usv_low_level` N=40, Tf=1, 12):
    exit 0, `progressed 1`, `thrust_violations 0`, K1 and K2 per served
    tick per server, both servers' solve_ms p50/p99, ms per guidance tick
    beside its 50 ms period; (e) the live thrust loop: `ll_tick` (v2
    frames) over the JAX test's 40-tick script through a captured
    `usv_low_level` server (N=30, Tf=1, 8 iterations, K1 8 and K2 1 per
    served tick), each tick's thrusts within 1e-3 of the port's
    `LowLevelController` (cuda, float32) ticked from the server's warm
    start before that tick; (f) the NaN quarantine on the captured
    flagship tick at B=512 with lane 3's x0 NaN, float64 and float32:
    status 2 on that lane alone and every other lane finite, at 15 fixed
    iterations the healthy lanes bitwise the clean batch's, at the
    production schedule the float64 card tick within 5e-6 of the CPU
    plain tick (run in a spawned worker meanwhile) with identical status
    and the same escalation count.  A line `phase 21 table:` holds its
    figures.
22. the acados parity bridge (`parity/`, `acados_bridge`): (a) every K2
    form (`CUDA_MODELS` and the curved race form) at phase 3's L=512
    float64 inputs against the CasADi transcription of the reference's
    models (`casadi_models.linearize_lanes`: `numeric_f` through the RK4
    sensitivities of `ops/integrators.py`, `numeric_h` through
    `torch.func.jacfwd`) at phase 3's float64 tolerances, with the
    Jacobian columns outside f_dep exact identity (zero for controls) in
    both, each form's max error printed (a line `phase 22 table:`); (b)
    the flagship's 30-tick and the hull's 20-tick fixtures (the hull's
    with its per-stage yref), recorded by the CPU's float64 `RTISolver`
    in a worker process during phases 18-21, each replayed on the card
    by a child `python -m mpc_collisionavoidance_tpu_torch.parity.
    run_acados_parity --replay <file>` (its default device, captured
    ticks): max_u_dev and max_x_dev within 1e-9, K1 30 and K2 1 per tick
    read at the child's exit; (c) the runner without acados exits 2 with
    the JAX package's message.  Its K2 launches in (a) are comparisons,
    not counted; (b)'s count.

Each main path is driven with every launch count set to 0 just before and
read just after (phase 16's goldens, server and timed ticks each so), on
ticks that replay their captured graphs (a tick that captures runs an
eager warm-up first: the lane engine's counted tick is not the first, and
the per-instance runs' gates count each capture as one more tick): a
replay adds the launches its wrappers counted at capture, and
the escalation steps' launches times the steps that ran on the device,
read after the tick (`capture.settle_launch_counts`).  The race car's
runs are named by the K2 form they take: `race_cars` on the straight
track, `race_cars_track` and
`race_cars_dev_track` on the curved one (`RACE`).  Times come from CUDA events (the server's from the
client's clock); the plain versions' times are those of their checked
calls at L=512 float32, one call each.
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
import functools
import dataclasses
import itertools
import json
import os
import pathlib
import re
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
# instances each has, matched as a part of the name (K1: 17 shapes in the
# warp design and the 11 with nu <= 2 in the CTA design, whose
# riccati_lanes_kernel_cta counts under both names; K2: 14 forms, K3: 13
# structures; each in two types)
NO_SPILL = {"riccati_lanes_kernel": 56, "riccati_lanes_kernel_cta": 22,
            "linearize_lanes_kernel": 28, "fused_ipm_kernel": 26}


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


def riccati_launcher(lib, d, design=None):
    """A call of `lib`'s K1 C entry on the LaneLQR `d` with its outputs and
    scratch allocated once (the kernel's time without the wrapper's checks
    and allocations, and not counted as a launch), in the design the rule
    picks or in `design` ("warp" or "cta").  Returns (call, (dx, du))."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build
    N, nx, _, L = d.A.shape
    nu = d.B.shape[2]
    opts = dict(dtype=d.A.dtype, device=d.A.device)
    out = [torch.empty(shape, **opts) for shape in (
        (N + 1, nx, L), (N, nu, L), (N, nu, nx, L), (N, nu, L))]
    args = (int(d.A.dtype == torch.float64), nx, nu, N, L,
            *_build.launch_args(d.A.device, *d, *out))

    if design is not None:
        from mpc_collisionavoidance_tpu_torch.kernels import riccati
        entry = functools.partial(lib.nmpc_riccati_lanes_as,
                                  riccati.DESIGNS.index(design))
    else:
        entry = lib.nmpc_riccati_lanes

    def call():
        _build.check(entry(*args), "riccati_lanes")
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
             (8, 2): ((100, 20), (LOW_LEVEL, POSITION, f"{FLAGSHIP} M=2")),
             (5, 2): ((20,), (ACADOS,)),
             (9, 1): ((100,), (GUIDANCE_CA,)),
             (10, 1): ((100,), ("usv_guidance",)),
             (12, 1): ((100,), ("usv_guidance2",)),
             (11, 1): ((100,), ("usv_guidance3",)),
             (4, 1): ((100,), ("usv_guidance4",)),
             (5, 1): ((100,), ("usv_guidance5",)),
             (6, 2): ((50,), tuple(RACE)),
             # the macro stages of partially condensed QPs (phase 18): N/M
             # stages of M nu controls
             (8, 4): ((25,), (f"{FLAGSHIP} M=4",)),
             (8, 5): ((20,), (f"{FLAGSHIP} M=5",)),
             (8, 10): ((10,), (f"{FLAGSHIP} M=10",)),
             (14, 4): ((50,), (f"{HULL} M=2",)),
             (14, 8): ((25,), (f"{HULL} M=4",)),
             (6, 4): ((25,), ("race_cars_dev_track M=2",))}
# (L, dtype name) at which K1 is timed
K1_TIMED = ((1, "float32"), (128, "float32"), (512, "float32"),
            (512, "float64"))


def _riccati_nan_lane(nx, nu, N, design, L=130, lane=7):
    """One lane's A set to NaN: that lane goes non-finite and every other
    lane's dx/du stays bitwise as it was (lane 7 shares its warp design's
    block with lanes 4-6)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import riccati
    d = _random_lqr(N, nx, nu, L, seed=7, dtype=torch.float32)
    ref = riccati.lqr_solve_lanes_cuda_as(design, *d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = riccati.lqr_solve_lanes_cuda_as(design, *d._replace(A=A))
    torch.cuda.synchronize()
    keep = torch.arange(L, device=DEVICE) != lane
    same = all(torch.equal(g[..., keep], r[..., keep])
               for g, r in zip(got, ref))
    poisoned = not all(bool(torch.isfinite(g[..., lane]).all())
                       for g in got)
    print(f"K1 ({nx}, {nu}) {design} NaN in lane {lane}'s A at L={L}: lane "
          f"non-finite {poisoned}, the other lanes bitwise unchanged {same}")
    if not (same and poisoned):
        raise AssertionError(f"K1 ({nx}, {nu}) {design}: a NaN lane touched "
                             "another lane, or stayed finite")


def k1_designs(nu):
    """K1's designs for an instance: the warp's, and the CTA's for nu <= 2."""
    return ("warp", "cta") if nu <= 2 else ("warp",)


def check_riccati():
    """K1 vs lqr_solve_lanes_plain on the card in each design, the NaN-lane
    isolation, and each design's time beside the bound; returns {(nx, nu):
    dict(err, ms, plain_ms, bound_ms, bound_by)} (times at the instance's
    first horizon, L=512, float32, in the design the rule picks there)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build, riccati
    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
        lqr_solve_lanes_plain)
    lib = _build.library()
    result, table = {}, []
    for (nx, nu), (horizons, _) in K1_SHAPES.items():
        worst = 0.0
        N = horizons[0]
        designs = k1_designs(nu)
        for NL, L in itertools.product(horizons, (1, 130, 512)):
            for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                                      (torch.float64, 0.0, 1e-10)):
                d = _random_lqr(NL, nx, nu, L, seed=nx * 1000 + L,
                                dtype=dtype)
                want, want_ms = _timed(lambda: lqr_solve_lanes_plain(d))
                if (NL, L, dtype) == (N, B, torch.float32):
                    plain_ms = want_ms
                lanes = riccati.cta_lanes(DEVICE, dtype, nx, nu)
                rule = "cta" if L <= lanes else "warp"
                for design in designs:
                    before = dict(riccati.launches_by_design)
                    got = (riccati.lqr_solve_lanes_cuda(*d) if design == rule
                           else riccati.lqr_solve_lanes_cuda_as(design, *d))
                    torch.cuda.synchronize()
                    if riccati.launches_by_design[design] != (
                            before[design] + 1):
                        raise AssertionError(f"K1 ({nx},{nu}) L={L}: "
                                             f"{design} not launched")
                    err = _max_err(got, want)
                    worst = max(worst, err)
                    print(f"K1 riccati nx={nx} nu={nu} N={NL} L={L} "
                          f"{str(dtype)[6:]} {design}"
                          f"{' (rule)' if design == rule else ''}: "
                          f"max|err| {err:.3e}")
                    _check_close(f"K1 ({nx},{nu}) N={NL} L={L} {dtype} "
                                 f"{design}", got, want, rtol, atol)
        for design in designs:
            _riccati_nan_lane(nx, nu, N, design)
        for L, dname in K1_TIMED:
            dtype = getattr(torch, dname)
            d = _random_lqr(N, nx, nu, L, seed=1, dtype=dtype)
            bound_ms, by = bound(*riccati_work(N, nx, nu, L,
                                               d.A.element_size()),
                                 d.A.element_size())
            lanes = riccati.cta_lanes(DEVICE, dtype, nx, nu)
            rule = "cta" if L <= lanes else "warp"
            times = {}
            for design in designs:
                times[design] = launch_ms(riccati_launcher(lib, d,
                                                           design)[0])
                print(f"K1 ({nx}, {nu}) N={N} L={L} {dname} {design}: "
                      f"{times[design]:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({by}), {100 * bound_ms / times[design]:.2f}% of "
                      "the bound")
            fastest = min(times, key=times.get)
            print(f"K1 ({nx}, {nu}) N={N} L={L} {dname}: the rule picks "
                  f"{rule} (CTA design up to L={lanes}), the faster is "
                  f"{fastest}")
            table.append(dict(shape=[nx, nu], N=N, L=L, dtype=dname,
                              cta_lanes=lanes, rule=rule, fastest=fastest,
                              ms=times, bound_ms=bound_ms))
            if (L, dname) == (B, "float32"):
                result[(nx, nu)] = dict(err=worst, ms=times[rule],
                                        bound_ms=bound_ms, bound_by=by)
        result[(nx, nu)]["plain_ms"] = plain_ms
        print(f"K1 ({nx}, {nu}) plain sweep at L={B} float32: "
              f"{result[(nx, nu)]['plain_ms']:.4f} ms")
    print("phase 2 designs: " + json.dumps(table))
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


def _backend(solver):
    """The solver's IPM backend, and its condensing group size if any."""
    return solver.riccati + (f" condense={solver.condense}"
                             if solver.condense > 1 else "")


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


# (L, dtype name) at which K3 is held against its plain version (whose
# calls, ~0.5-3 s each, are most of phase 4's time: float64 at the ragged
# 130 only, since each lane is its own block and 512 would repeat it), and
# at which it is timed (tools/k3_compare.py adds float64 at 512)
K3_COMPARED = ((130, "float64"), (B, "float32"))
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
        for L, dname in K3_COMPARED:
            dtype = getattr(torch, dname)
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


def f64_tick(name, Bn, config, device):
    """One float64 tick of `config` on `device` from the bench's inputs:
    (its LaneOutput, the solver, seconds)."""
    import torch
    solver, st, x, p, lh, refs = _setup(name, Bn, torch.float64, device,
                                        config)
    t0 = time.perf_counter()
    _, out = solver.step_fn(st, x, p, lh, **refs)
    return out, solver, time.perf_counter() - t0


def compare_ticks(what, out, want, Bn, dims, against="CPU plain"):
    """Gate a float64 card tick against `want` (u0/x1 atol 5e-6,
    identical status)."""
    _check_output(out, Bn, f"{what} float64 card tick", *dims)
    du0 = float((out.u0.cpu() - want.u0.cpu()).abs().max())
    dx1 = float((out.x1.cpu() - want.x1.cpu()).abs().max())
    same_status = bool((out.status.cpu() == want.status.cpu()).all())
    print(f"{what} tick B={Bn} float64, card vs {against}: "
          f"max|du0| {du0:.3e}, max|dx1| {dx1:.3e}, status identical "
          f"{same_status}, status-0 "
          f"{float((out.status == 0).double().mean()):.3f}")
    if du0 > 5e-6 or dx1 > 5e-6 or not same_status:
        raise AssertionError(f"{what}: float64 card tick disagrees with the "
                             f"{against} tick")


# the float64 CPU plain ticks that phases 5-14 hold the card's against
# (`card_vs_cpu_tick`), each (run, lanes, fused?): `main` computes them in
# a worker process (`tick_cpu_references`) while the card runs the phases
CPU_TICKS = ((FLAGSHIP, B, False), (HULL, HULL_CPU_B, False),
             *((name, FAMILY_CPU_B, False) for name in FAMILY + GUIDANCE),
             *((name, B, fused)
               for name in ("race_cars_track", "race_cars_dev_track")
               for fused in (False, True)))
# card_vs_cpu_tick's card outputs, by CPU_TICKS entry, until checked
_CARD_TICKS = {}


def tick_cpu_references():
    """The float64 CPU plain ticks of `CPU_TICKS` on one thread, as numpy:
    {entry: (u0, x1, status, seconds)}."""
    import torch
    torch.set_num_threads(1)
    out = {}
    for name, Bn, fused in CPU_TICKS:
        o, _, sec = f64_tick(name, Bn, _fused() if fused else _production(),
                             "cpu")
        out[(name, Bn, fused)] = (o.u0.numpy(), o.x1.numpy(),
                                  o.status.numpy(), sec)
    return out


def card_vs_cpu_tick(name, Bn, config=None):
    """One float64 tick (the production schedule unless `config` says
    otherwise) on the card, kept for `check_cpu_ticks`, which holds it
    against the CPU plain tick from the same inputs."""
    import types
    config = config or _production()
    out, solver, _ = f64_tick(name, Bn, config, DEVICE)
    _CARD_TICKS[(name, Bn, solver.riccati == "fused")] = (
        f"{name} {_backend(solver)}",
        types.SimpleNamespace(**{k: getattr(out, k).cpu() for k in
                                 ("u0", "x1", "gap", "status")}))


def check_cpu_ticks(ref):
    """Every card tick of `card_vs_cpu_tick` against its CPU plain tick
    (`ref`, from `tick_cpu_references`)."""
    import types

    import torch
    if set(ref) != set(_CARD_TICKS):
        raise AssertionError(f"card ticks {sorted(_CARD_TICKS)} and CPU "
                             f"ticks {sorted(ref)} differ")
    for key, (u0, x1, status, sec) in ref.items():
        what, out = _CARD_TICKS.pop(key)
        want = types.SimpleNamespace(u0=torch.as_tensor(u0),
                                     x1=torch.as_tensor(x1),
                                     status=torch.as_tensor(status))
        compare_ticks(what, out, want, key[1], _dims(key[0]),
                      against=f"CPU plain ({sec:.1f} s, worker)")


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
    print(f"{name} {_backend(solver)} tick B={B} float32: launches {counts}, "
          f"max gap {float(out.gap.max()):.3e}, status-0 "
          f"{float((out.status == 0).float().mean()):.3f}")
    if not expect(counts):
        raise AssertionError(f"{name} {_backend(solver)} main path launch "
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
    print(f"{name} {_backend(solver)} closed loop {ticks} ticks B={B} float32: "
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
    print(f"{name} {_backend(solver)} B=1 tick float32: p50 {p50:.3f} ms, p99 "
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
def _serving(address=None, **kw):
    """The port's RTServer on a Unix socket (or on the TCP `address`,
    `host:port`), warmed up, its event loop on a background thread;
    stopped (solve thread included) on exit."""
    import asyncio

    from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
    tmp = tempfile.mkdtemp(prefix="nmpc_rt")
    server = RTServer(address or os.path.join(tmp, "rt.sock"), device=DEVICE,
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
    _gate_calls(label, calls, expect)
    print(f"  {label}: launches {counts}")
    return counts, result


def _gate_calls(label, calls, expect):
    """Gate a server's recorded device phase calls (`_count_phases`) with
    `expect[phase]`; a phase not in `expect` must not have run."""
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
    fused = dataclasses.asdict(SolverConfig(riccati="fused"))
    del fused["qp_backend"]            # the instance engine's, not served
    counts[(FLAGSHIP, "served fused")], _ = _served(
        "flagship fused server",
        _latency_drive("flagship fused", 20, solve1, x0, card),
        {"tick": _fused_counts}, model=FLAGSHIP, N=100, Tf=5.0, **fused)

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


# ---- phase 16: the per-instance engine ----

# K1 through the per-instance route (`ops/riccati.py::lqr_solve`): the
# horizon of each (nx, nu) checked, and the batch widths
INSTANCE_K1 = {(8, 1): 100, (14, 2): 100, (6, 2): 50}
INSTANCE_B = (1, 64)
# 16f: the timed captured ticks, and the eager ones beside them
INSTANCE_TICKS, INSTANCE_EAGER = 20, 10
# the golden runs' names in the kernels line: the race car's goldens run
# on the synthetic curved track
GOLDEN_RUN_NAME = {"race_cars": "race_cars_track"}


def _instance_lqr(N, nx, nu, Bn, seed, dtype):
    """`_random_lqr`'s LQR in the per-instance layout: batch (Bn,)."""
    from mpc_collisionavoidance_tpu_torch.ops.riccati import LQRData
    d = _random_lqr(N, nx, nu, Bn, seed, dtype)
    return LQRData(*(t.movedim(-1, 0).contiguous() for t in d))


def instance_k1_route():
    """16a: `lqr_solve` on CUDA tensors (the lane route, K1) against the
    per-instance plain `lqr_solve_plain` on the card; one NaN instance
    leaves the others bitwise unchanged; an (nx, nu) with no K1 instance
    raises."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ops.riccati import (
        lqr_solve, lqr_solve_plain)
    for (nx, nu), N in INSTANCE_K1.items():
        for Bn, (dtype, rtol, atol) in itertools.product(
                INSTANCE_B, ((torch.float32, 2e-4, 2e-5),
                             (torch.float64, 0.0, 1e-10))):
            d = _instance_lqr(N, nx, nu, Bn, nx * 100 + Bn, dtype)
            got = lqr_solve(d)
            want = lqr_solve_plain(d)
            torch.cuda.synchronize()
            print(f"16a lqr_solve ({nx}, {nu}) N={N} B={Bn} "
                  f"{str(dtype)[6:]}: K1 route vs plain max|err| "
                  f"{_max_err(got, want):.3e}")
            _check_close(f"lqr_solve ({nx},{nu}) B={Bn} {dtype}", got, want,
                         rtol, atol)
        d = _instance_lqr(N, nx, nu, 64, 7, torch.float32)
        ref = lqr_solve(d)
        A = d.A.clone()
        A[7] = float("nan")
        got = lqr_solve(d._replace(A=A))
        keep = torch.arange(64, device=DEVICE) != 7
        same = all(torch.equal(g[keep], r[keep]) for g, r in zip(got, ref))
        poisoned = not all(bool(torch.isfinite(g[7]).all()) for g in got)
        print(f"16a lqr_solve ({nx}, {nu}) NaN in instance 7's A at B=64: "
              f"instance non-finite {poisoned}, the others bitwise "
              f"unchanged {same}")
        if not (same and poisoned):
            raise AssertionError(f"lqr_solve ({nx}, {nu}): a NaN instance "
                                 "touched another, or stayed finite")
    try:
        lqr_solve(_instance_lqr(4, 3, 1, 2, 0, torch.float64))
    except ValueError as exc:
        print(f"16a lqr_solve (3, 1) on the card raises: {exc}")
    else:
        raise AssertionError("lqr_solve (3, 1): no K1 instance, no error")


def _instance_inputs(name, Bn, dtype, device, seed=SEED):
    """A per-instance iterate of `name` (`RACE` names the track): the
    scenario's x0 on every stage plus 0.05 N(0, 1), controls 0.05 N(0, 1),
    x0 0.01 N(0, 1) off stage 0, the builder's references, the scenario's
    params and lh (None where the model has no rows): the arguments of
    `build_qp` after (spec, layout)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    spec = _spec(name)
    m, N = spec.model, spec.N
    sc = scenarios.DEFAULTS[RACE.get(name, (name,))[0]][0]()
    rng = np.random.default_rng(seed)
    xbar = sc.x0 + 0.05 * rng.standard_normal((Bn, N + 1, m.nx))
    ubar = 0.05 * rng.standard_normal((Bn, N, m.nu))
    x0 = xbar[:, 0] + 0.01 * rng.standard_normal((Bn, m.nx))
    yref = np.broadcast_to(spec.cost.yref, (Bn, N, spec.cost.ny))
    yref_e = np.broadcast_to(spec.cost.yref_e, (Bn, len(spec.cost.yref_e)))
    params = np.broadcast_to(sc.params, (Bn, m.np_))

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    lh = t(np.broadcast_to(sc.lh, (Bn, m.nh))) if m.nh else None
    return (t(xbar), t(ubar), t(x0), t(yref), t(yref_e), t(params), lh)


def instance_k2_route():
    """16b: `build_qp` on the card (the lane route, K2) against the CPU
    plain path on the same iterate, every QPData field: the flagship, the
    hull and the race car on the curved track, B=8.  float32 at phase 3's
    J/C tolerance (rtol 2e-4, atol 2e-5; c and gl are differences of K2's
    outputs and the iterate), float64 at atol 1e-10 (rtol 1e-12: the
    hull's stiff sway-drag Jacobian entries are large)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ops import linearize
    for name in (FLAGSHIP, HULL, "race_cars_track"):
        spec = _spec(name)
        layout = linearize.make_row_layout(spec)
        for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                                  (torch.float64, 1e-12, 1e-10)):
            got = linearize.build_qp(spec, layout, *_instance_inputs(
                name, 8, dtype, DEVICE))
            want = linearize.build_qp(spec, layout, *_instance_inputs(
                name, 8, dtype, "cpu"))
            got = [g.cpu() for g in got]
            print(f"16b build_qp {name} B=8 {str(dtype)[6:]}: card (K2) vs "
                  f"CPU max|err| {_max_err(got, want):.3e} over "
                  f"{len(want)} fields")
            for field, g, w in zip(want._fields, got, want):
                _check_close(f"build_qp {name} {field} {dtype}", [g], [w],
                             rtol, atol)


def _golden(name, family, capture=True):
    from mpc_collisionavoidance_tpu_torch.parity import goldens
    if family == "rti":
        return goldens.compute_golden_rti(
            name, 30, goldens.RTI_GOLDEN_RUNS[name][1], device=DEVICE,
            capture=capture)
    return goldens.compute_golden(name, 30, goldens.GOLDEN_RUNS[name][2],
                                  device=DEVICE, capture=capture)


def instance_goldens():
    """16c: the committed goldens' 30-tick prefixes on the card in float64
    at atol 1e-6, on the captured tick: every RTI fixture, and the
    converged-SQP fixtures of the flagship and the hull; the flagship's RTI
    run also eagerly (`capture=False`), bitwise equal.  Returns {(run name,
    "instance golden"): launch counts} (each run's counts set to 0 just
    before it)."""
    from mpc_collisionavoidance_tpu_torch.parity import goldens
    runs = [(name, "rti") for name in goldens.RTI_GOLDEN_RUNS]
    runs += [(FLAGSHIP, "sqp"), (HULL, "sqp")]
    counts = {}
    for name, family in runs:
        t0 = time.perf_counter()
        _reset_counts()
        got = _golden(name, family)
        c = _read_counts()
        counts[(GOLDEN_RUN_NAME.get(name, name),
                f"instance golden {family}")] = c
        ref = goldens.load_golden(name, family)
        du = float(np.abs(got.simU - ref.simU[:30]).max())
        dx = float(np.abs(got.simX - ref.simX[:30]).max())
        print(f"16c golden {name} [{family}] 30 ticks float64 on the card: "
              f"max|du| {du:.3e}, max|dx| {dx:.3e}, status-0 "
              f"{float(np.mean(got.status == 0)):.3f}, launches {c}, "
              f"{time.perf_counter() - t0:.1f} s")
        if not (du <= 1e-6 and dx <= 1e-6):
            raise AssertionError(f"golden {name} [{family}]: drift over 1e-6")
        if c["linearize_lanes"] < 30 or c["riccati_lanes"] < 30:
            raise AssertionError(f"golden {name} [{family}]: launches {c}")
        if (name, family) == (FLAGSHIP, "rti"):
            t0 = time.perf_counter()
            eager = _golden(name, family, capture=False)
            same = all(np.array_equal(a, b) for a, b in zip(got, eager))
            print(f"16c golden {name} [{family}] eager (capture=False) vs "
                  f"captured: bitwise {same}, "
                  f"{time.perf_counter() - t0:.1f} s")
            if not same:
                raise AssertionError("16c: the captured golden run differs "
                                     "from the eager one")
    return counts


def _instance_setup(name, Bn, dtype, **kw):
    """An RTISolver of `name` on the card, its warm start at the scenario's
    x0 (ye perturbed by 0.1 N(0, 1) over a batch; B=1 unbatched) and the
    scenario's params, lh."""
    import torch

    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    spec = _spec(name)
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    x0 = np.array(sc.x0, float)
    if Bn > 1:
        x0 = np.broadcast_to(x0, (Bn, spec.model.nx)).copy()
        x0[:, coord] += 0.1 * np.random.default_rng(SEED).standard_normal(Bn)
    solver = RTISolver(spec, **kw, device=DEVICE, dtype=dtype)
    x = torch.tensor(x0, dtype=dtype, device=DEVICE)
    p = torch.tensor(sc.params, dtype=dtype, device=DEVICE)
    lh = torch.tensor(sc.lh, dtype=dtype, device=DEVICE)
    return solver, solver.init_state(x), x, p, lh


def instance_dense():
    """16d: one flagship tick at B=8, float64 on the card, of the dense
    backend against the Riccati one (30 IPM iterations), atol 5e-6 as in
    tests/test_dense_qp.py; both status 0."""
    import torch
    outs = {}
    for backend in ("riccati", "dense"):
        solver, st, x, p, lh = _instance_setup(
            FLAGSHIP, 8, torch.float64, ipm_iters=30, qp_backend=backend)
        outs[backend] = solver.step_fn(st, x, p, lh)[1]
    r, d = outs["riccati"], outs["dense"]
    err = max(float((d.xtraj - r.xtraj).abs().max()),
              float((d.utraj - r.utraj).abs().max()))
    ok = bool((r.status == 0).all() and (d.status == 0).all())
    print(f"16d flagship B=8 float64: dense vs riccati backend max|err| "
          f"xtraj/utraj {err:.3e}, all status 0 {ok}")
    if err > 5e-6 or not ok:
        raise AssertionError("dense and riccati backends disagree")


def instance_served(card):
    """16e: `RTServer(engine="vmap")` serving the flagship (N=100, Tf=5,
    float32, the per-instance engine's default schedule: 18 fixed IPM
    iterations, mu0 1, tol 1e-7) over UDS: one vehicle for 20 ticks and a
    fleet of 8 for 20 lockstep ticks, every reply status 0.  Returns the
    run's launch counts."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    x0, p, lh = (tuple(float(v) for v in np.asarray(a, np.float32))
                 for a in (sc.x0, sc.params, sc.lh))
    replies = []

    def solve1(s, seq, x):
        _send1(s, seq, x, p, lh)
        replies.append(_reply1(s, seq))
        return replies[-1]

    with _serving(model=FLAGSHIP, N=100, Tf=5.0, engine="vmap",
                  **_server_engine(engine="vmap", ipm_iters=18, mu0=1.0,
                                   ipm_tol=1e-7)) as server:
        _reset_counts()
        _, ms = _client_loop(server.path, 20, solve1, x0)
        rng = np.random.default_rng(SEED)
        xs = [tuple(np.float32(v) for v in np.r_[x0[:2], x0[2] + 0.1 * e,
                                                 x0[3:]])
              for e in rng.standard_normal(8)]
        fleet, n0 = [], len(server.solve_ms)
        with contextlib.ExitStack() as stack:
            socks = [stack.enter_context(contextlib.closing(
                _connect(server.path))) for _ in range(8)]
            for seq in range(20):
                t0 = time.perf_counter()
                for s, x in zip(socks, xs):
                    _send1(s, seq, x, p, lh)
                got = [_reply1(s, seq) for s in socks]
                replies.extend(got)
                xs = [r.x1 for r in got]
                fleet.append((time.perf_counter() - t0) * 1e3)
        counts = _read_counts()
        ticks = len(server.solve_ms) - n0
    bad = [r for r in replies if r.status != 0]
    b1, f8 = _pcts(ms[1:]), _pcts(fleet[1:])
    print(f"16e vmap server flagship: B=1 20 ticks request->reply p50 "
          f"{b1[0]:.3f} ms, p99 {b1[1]:.3f} ms; fleet of 8, 20 lockstep "
          f"ticks p50 {f8[0]:.3f} ms, p99 {f8[1]:.3f} ms in {ticks} server "
          f"ticks; {len(replies)} replies, {len(bad)} not status 0; "
          f"launches {counts} ({card})")
    if bad:
        raise AssertionError(f"vmap server: replies not status 0: {bad[:3]}")
    turns = {}
    for capture in (True, False):
        with _serving(model=FLAGSHIP, N=100, Tf=5.0, engine="vmap",
                      rti_split=True, capture=capture,
                      **_server_engine(engine="vmap", ipm_iters=18, mu0=1.0,
                                       ipm_tol=1e-7)) as server:
            turns[capture] = _turns(server.path, xs[:2], p, lh, 10)
    same = turns[True] == turns[False]
    statuses = sorted({r.status for v in turns[True] for r in v})
    print(f"16e vmap server flagship, rti_split: two vehicles taking 10 solo "
          f"ticks each in turn, captured vs eager server (capture=False): "
          f"replies equal {same}, statuses {statuses}")
    if not same or statuses != [0]:
        raise AssertionError("16e: the vehicles in turn got other replies "
                             "than from the eager server, or not status 0")
    return counts


def _turns(path, xs, p, lh, ticks):
    """Closed-loop v1 ticks of the vehicles `xs` (their first x0), one
    connection each, taken in turn (each request alone in its window: the
    solo path).  Replies per vehicle."""
    xs, out = list(xs), [[] for _ in xs]
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(contextlib.closing(_connect(path)))
                 for _ in xs]
        for seq in range(ticks):
            for i, s in enumerate(socks):
                _send1(s, seq, xs[i], p, lh)
                out[i].append(_reply1(s, seq))
                xs[i] = out[i][-1].x1
    return out


def instance_tick_times(card):
    """16f: the per-instance tick, float32, warm closed loop (x0 <- x1),
    captured and eager (`capture=False`) in turns: each one's median and
    p99 over `INSTANCE_TICKS` captured and `INSTANCE_EAGER` eager ticks
    (CUDA events, after a first tick that captures or warms up) and the
    captured tick's K1/K2 launches per tick, at B=1 and B=64, for the
    flagship and the hull on both QP backends.  Returns
    {(model, label): launch counts} of the captured Riccati runs (the
    engine's main path) and {(model, backend, B): (captured median, p99,
    eager median, p99)}."""
    import torch
    counts, table = {}, {}
    for name, backend, Bn in itertools.product(
            (FLAGSHIP, HULL), ("riccati", "dense"), (1, 64)):
        row = []
        for capture in (True, False):
            solver, st, x, p, lh = _instance_setup(
                name, Bn, torch.float32, qp_backend=backend,
                capture=capture)
            st, out = solver.step_fn(st, x, p, lh)      # captures or warms
            x = out.x1
            times = []
            _reset_counts()
            for _ in range(INSTANCE_TICKS if capture else INSTANCE_EAGER):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                st, out = solver.step_fn(st, x, p, lh)
                end.record()
                x = out.x1
                end.synchronize()
                times.append(start.elapsed_time(end))
            c = _read_counts()
            if not torch.isfinite(out.u0).all():
                raise AssertionError(f"{name} {backend} B={Bn}: non-finite "
                                     "u0")
            row += [float(np.median(times)), float(np.percentile(times, 99))]
            if capture:
                if backend == "riccati":
                    counts[(name, f"instance B={Bn}")] = c
                per = {k: v / INSTANCE_TICKS for k, v in c.items()}
                want = {"riccati_lanes": 18 if backend == "riccati" else 0,
                        "linearize_lanes": 1, "fused_ipm_lanes": 0}
                if per != want:
                    raise AssertionError(f"16f {name} {backend} B={Bn}: "
                                         f"launches per tick {per}")
                status0 = float((out.status == 0).float().mean())
        table[(name, backend, Bn)] = tuple(row)
        print(f"16f instance tick {name} {backend} B={Bn} float32: captured "
              f"median {row[0]:.3f} ms, p99 {row[1]:.3f} ms; eager median "
              f"{row[2]:.3f} ms, p99 {row[3]:.3f} ms ({row[2] / row[0]:.1f}x)"
              f"; captured launches per tick K1 {per['riccati_lanes']:g}, "
              f"K2 {per['linearize_lanes']:g}, K3 "
              f"{per['fused_ipm_lanes']:g}, status-0 {status0:.3f} ({card})")
    return counts, table


# 16g: the runs whose captured tick is held against the eager one
INSTANCE_CAPTURED = (FLAGSHIP, HULL, LOW_LEVEL, "race_cars_track")
INSTANCE_MEHROTRA = (FLAGSHIP, HULL)


def _instance_case(name, Bn, dtype, device, **kw):
    """(RTISolver of `name`, its state, x0, params, lh, references) at
    `_instance_inputs`'s iterate (the warm start is that iterate; yref per
    stage), on `device`; B=1 drops the batch axis (a node's shapes)."""
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (
        RTISolver, SolverState)
    xbar, ubar, x0, yref, yref_e, params, lh = _instance_inputs(
        name, Bn, dtype, device)
    if Bn == 1:
        xbar, ubar, x0, yref, yref_e, params = (
            t[0] for t in (xbar, ubar, x0, yref, yref_e, params))
        lh = None if lh is None else lh[0]
    solver = RTISolver(_spec(name), **kw, device=device, dtype=dtype)
    return (solver, SolverState(xbar, ubar), x0, params, lh,
            dict(yref=yref, yref_e=yref_e))


def _leaves(tree):
    import torch
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _leaves(v)]


def _same_bits(got, want):
    """Every tensor of `got` has the shape and the bits of `want`'s."""
    import torch
    g, w = _leaves(got), _leaves(want)
    return len(g) == len(w) and all(
        a.shape == b.shape and torch.equal(_bits(a), _bits(b))
        for a, b in zip(g, w))


def _program_figures(solver, what):
    """Print (one line) and return each captured program's nodes,
    conditional nodes, capture and instantiation seconds and pool
    bytes."""
    rows = [dict(run=what, entry=key[0], nodes=prog.nodes,
                 conditional=prog.conditional, capture_s=prog.capture_s,
                 instantiate_s=prog.instantiate_s,
                 pool_bytes=prog.pool_bytes)
            for key, prog in solver._graphs.programs.items()]
    print(f"16g {what} programs: " + "; ".join(
        f"{r['entry']} {r['nodes']} nodes ({r['conditional']} "
        f"conditional), capture {r['capture_s']:.3f} s, instantiate "
        f"{r['instantiate_s']:.3f} s, pool {r['pool_bytes']} bytes"
        for r in rows))
    return rows


def _instance_vs_eager(name, Bn, dtype, k1, split, **kw):
    """One 16g case: the captured tick (capturing call, then a replay with
    no sync and one graph launch, counted) bitwise equal to the eager one
    from the same inputs, state and output; with `split`, prepare_fn +
    feedback_fn likewise.  Returns (the captured output, the programs'
    figures)."""
    eager, st, x, p, lh, refs = _instance_case(name, Bn, dtype, DEVICE,
                                               capture=False, **kw)
    solver = _instance_case(name, Bn, dtype, DEVICE, **kw)[0]
    what = (f"{name} B={Bn} {str(dtype)[6:]} "
            f"{kw.get('qp_backend', 'riccati')} "
            f"{kw.get('centering', 'fixed')}")
    want = eager.step_fn(st, x, p, lh, **refs)
    ok = _same_bits(solver.step_fn(st, x, p, lh, **refs), want)
    before = _launch_counts()
    got, graphs = _replay(solver, lambda: solver.step_fn(st, x, p, lh,
                                                         **refs))
    after = _launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    ok = ok and _same_bits(got, want) and graphs == 1
    if split:
        want_s = eager.feedback_fn(st, eager.prepare_fn(st, p, lh, **refs),
                                   x)
        solver.feedback_fn(st, solver.prepare_fn(st, p, lh, **refs), x)
        qp, n_prep = _replay(solver, lambda: solver.prepare_fn(st, p, lh,
                                                               **refs))
        got_s, n_feed = _replay(solver, lambda: solver.feedback_fn(st, qp,
                                                                   x))
        ok = ok and _same_bits(got_s, want_s) and n_prep == n_feed == 1
    want_counts = {"riccati_lanes": k1, "linearize_lanes": 1,
                   "fused_ipm_lanes": 0}
    print(f"16g {what}: captured == eager bitwise {ok} (step"
          f"{', prepare + feedback' if split else ''}; replays with no "
          f"sync, one graph launch each); launches per replay {launched}")
    if not ok:
        raise AssertionError(f"16g {what}: the captured tick differs from "
                             "the eager one")
    if launched != want_counts:
        raise AssertionError(f"16g {what}: launches per replay {launched}, "
                             f"want {want_counts}")
    return got, _program_figures(solver, what)


def instance_captured(card):
    """16g: the captured per-instance tick against the eager one
    (`capture=False`), bitwise, state and output: the flagship, the hull,
    usv_low_level and the race car on the curved track at B in {1, 64}
    (B=1 unbatched) in float32 and float64 from `_instance_inputs`'s
    iterate, step_fn and prepare_fn + feedback_fn; Mehrotra centering on
    the flagship and the hull; the dense backend at 16d's flagship B=8
    (30 iterations).  Each replay makes no sync and one graph launch and
    counts K1 18 (36 under Mehrotra, 0 dense) and K2 1.  The float64
    captured tick against the CPU's plain tick from the same inputs, atol
    1e-10, identical status (B=1, and the flagship's B=64).  Two states
    taking ticks in turn through one captured solver against two eager
    solvers.  Returns the programs' figures."""
    import torch
    rows = []
    for name, Bn, dtype in itertools.product(
            INSTANCE_CAPTURED, INSTANCE_B, (torch.float32, torch.float64)):
        got, figs = _instance_vs_eager(name, Bn, dtype, 18, split=True)
        rows += figs
        if dtype == torch.float64 and (Bn == 1 or name == FLAGSHIP):
            cpu, st, x, p, lh, refs = _instance_case(name, Bn, dtype, "cpu")
            want = cpu.step_fn(st, x, p, lh, **refs)
            err = max(float((g.cpu() - w).abs().max())
                      for g, w in zip(_leaves(got[1])[:5],
                                      _leaves(want[1])[:5]))
            same = torch.equal(got[1].status.cpu(), want[1].status)
            print(f"16g {name} B={Bn} float64: captured card tick vs CPU "
                  f"plain tick max |err| {err:.3e} (u0, x1, xtraj, utraj, "
                  f"qp_gap), status identical {same}")
            if err > 1e-10 or not same:
                raise AssertionError(f"16g {name} B={Bn}: the captured "
                                     "card tick disagrees with the CPU")
    for name, Bn, dtype in itertools.product(
            INSTANCE_MEHROTRA, INSTANCE_B, (torch.float32, torch.float64)):
        rows += _instance_vs_eager(name, Bn, dtype, 36, split=False,
                                   centering="mehrotra")[1]
    for dtype in (torch.float32, torch.float64):
        rows += _instance_vs_eager(FLAGSHIP, 8, dtype, 0, split=True,
                                   qp_backend="dense", ipm_iters=30)[1]
    instance_turns()
    return rows


def instance_turns():
    """16g: two vehicles' states (the flagship, B=1, float32, ye 0.3
    apart) take 6 ticks each in turn through one captured solver, full
    ticks and the RTI split alternating, against two eager solvers:
    bitwise, one static state."""
    import torch

    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import SolverState
    solver, st, x, p, lh, refs = _instance_case(FLAGSHIP, 1, torch.float32,
                                                DEVICE)
    eager = [_instance_case(FLAGSHIP, 1, torch.float32, DEVICE,
                            capture=False)[0] for _ in range(2)]
    logs = []
    for solvers in ((solver, solver), eager):
        sts = [st, SolverState(st.xbar + 0.3, st.ubar)]
        xs = [x, x + 0.3]
        log = []
        for k in range(6):
            for i, s in enumerate(solvers):
                if k % 2:
                    qp = s.prepare_fn(sts[i], p, lh, **refs)
                    sts[i], out = s.feedback_fn(sts[i], qp, xs[i])
                else:
                    sts[i], out = s.step_fn(sts[i], xs[i], p, lh, **refs)
                xs[i] = out.x1
                log += _leaves(out)
        logs.append(log)
    same = _same_bits(logs[0], logs[1])
    print(f"16g two states in turn through one captured solver (6 ticks "
          f"each, step and split alternating) vs two eager solvers: bitwise "
          f"{same}, static states {len(solver._graphs.states)}")
    if not same or len(solver._graphs.states) != 1:
        raise AssertionError("16g: states taking turns through one captured "
                             "solver differ from two eager solvers")


def instance_engine(card):
    """Phase 16: the per-instance engine (`solver/sqp_rti.py`) on the
    card.  Returns {(run, label): launch counts} of its runs, the timed
    ticks of 16f and the captured programs' figures of 16g."""
    t0 = time.perf_counter()

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 16{label} done")

    instance_k1_route()
    step_done("a")
    instance_k2_route()
    step_done("b")
    counts = instance_goldens()
    step_done("c")
    instance_dense()
    step_done("d")
    counts[(FLAGSHIP, "instance vmap server")] = instance_served(card)
    step_done("e")
    times, table = instance_tick_times(card)
    counts.update(times)
    step_done("f")
    programs = instance_captured(card)
    step_done("g")
    return counts, table, programs


# ---- phase 17: the guidance stack ----

MISSION_TICKS = 1000         # the reference harness length (main.py:116)
MISSION_SEED = 42            # tests/test_random_missions.py's seed
MISSION_N_WP = 4
MISSION_FIRST = 20           # the JAX slow test's missions
BOAT_R, SOFT_BAND = 0.5, 0.2
FLEET_CPU_B, FLEET_CPU_TICKS = 32, 20
BOAT_TICKS = 1200            # tests/test_guidance.py's challenge-0 mission
BOAT_BUDGET_MS = 50.0        # the flagship node at 20 Hz
CASCADE_TICKS = 40
CASCADE_CPU_TICKS = 5
NODE_TICKS = 20
NODE_EAGER = 10              # 17g's eager comparison: its first 10 ticks
CHALLENGE0_WPS = ((4.0, -5.0), (4.0, 25.0))
# 17g's nodes with each one's budget in ms (phases 12 and 13)
NODE_BUDGET_MS = {PF: FAMILY_BUDGET_MS[PF],
                  ACADOS: FAMILY_BUDGET_MS[ACADOS], **GUIDANCE_BUDGET_MS}


def random_missions(Bn, rng):
    """tests/test_random_missions.py:33-94 in numpy, for `Bn` missions:
    random 4-waypoint polylines (3 legs of 4-8 m turning up to 60 deg)
    and per-mission fields of 12-24 passable buoys, more than 8 visible
    at once.  A mission's draws do not depend on Bn, so the first 20 at
    seed 42 are the JAX slow test's.  One change: a mission whose field
    starves (fewer than 9 buoys placed in 500 attempts, which the JAX test
    asserts does not happen in its 20) is drawn again from the stream
    (at seed 42, mission 376 of 512).  Returns waypoints (Bn, 4, 2),
    fields (Bn, M, 3) float32, masks (Bn, M), and the five (Bn,)
    measurement arrays (u, v, nedx, nedy, psi)."""
    from mpc_collisionavoidance_tpu_torch.sim.scenarios import FIELD_CAPACITY
    wps = np.zeros((Bn, MISSION_N_WP, 2))
    fields = np.zeros((Bn, FIELD_CAPACITY, 3), np.float32)
    valid = np.zeros((Bn, FIELD_CAPACITY), bool)
    psi0 = np.zeros(Bn)
    for b in range(Bn):
        rows = []
        while len(rows) < 9:
            heading = rng.uniform(-np.pi, np.pi)
            psi0[b] = heading
            p = np.zeros(2)
            wps[b, 0] = p
            for k in range(1, MISSION_N_WP):
                if k > 1:
                    heading += rng.uniform(-np.pi / 3, np.pi / 3)
                p = p + rng.uniform(4.0, 8.0) * np.array(
                    [np.cos(heading), np.sin(heading)])
                wps[b, k] = p
            n_obs = rng.integers(12, 25)
            rows = []
            attempts = 0
            while len(rows) < n_obs and attempts < 500:
                attempts += 1
                leg = rng.integers(0, MISSION_N_WP - 1)
                t = rng.uniform(0.1, 0.9)
                c = wps[b, leg] * (1 - t) + wps[b, leg + 1] * t
                d = wps[b, leg + 1] - wps[b, leg]
                n = np.array([-d[1], d[0]]) / (np.linalg.norm(d) + 1e-9)
                pos = c + rng.normal(0.0, 1.5) * n
                r = rng.uniform(0.1, 0.3)
                if np.min(np.linalg.norm(wps[b] - pos, axis=1)) < 2.0 + r:
                    continue
                if np.linalg.norm(wps[b, 0] - pos) < 4.0:
                    continue
                if any(np.linalg.norm(pos - np.asarray(q[:2]))
                       < r + q[2] + 1.8 for q in rows):
                    continue
                rows.append((pos[0], pos[1], r))
        fields[b, :len(rows)] = np.asarray(rows, np.float32)
        valid[b, :len(rows)] = True
    meas0 = (np.full(Bn, 0.7, np.float32), np.zeros(Bn, np.float32),
             wps[:, 0, 0].astype(np.float32),
             wps[:, 0, 1].astype(np.float32), psi0.astype(np.float32))
    return wps, fields, valid, meas0


def _slot_rows(slots, fields, valid):
    """The field row each obstacle slot holds (-1 for a sentinel slot):
    the valid row nearest the slot's NED centre."""
    p = slots.p_obs.double().cpu().numpy().reshape(len(fields), -1, 2)
    d = np.linalg.norm(p[:, :, None, :] - fields[:, None, :, :2], axis=-1)
    d = np.where(valid[:, None, :], d, np.inf)
    return np.where(slots.r_obs.cpu().numpy() > 0, d.argmin(-1), -1)


def guidance_perception():
    """17a: perception and the waypoint manager at B=512 on the card vs
    the CPU, on 17b's missions (a pose on each polyline; 40 waypoint
    ticks walking 1.2 m toward the target, past the finish): identical
    slot rows, k and active; values float32 atol 1e-5, float64 atol
    1e-12.  (float32: the card's sin/cos/atan2/hypot differ from the
    CPU's by an ulp, and the coordinates, up to ~30 m, round at 1.9e-6 an
    ulp: perceive's float32 slot centres differ from its float64 ones by
    up to 1.9e-6 on these fields on the CPU alone.)"""
    import torch

    from mpc_collisionavoidance_tpu_torch.guidance import (obstacles,
                                                           waypoints)
    wps, fields, valid, meas0 = random_missions(
        B, np.random.default_rng(MISSION_SEED))
    rng = np.random.default_rng(SEED)
    rows = np.arange(B)
    leg = rng.integers(0, MISSION_N_WP - 1, B)
    t = rng.uniform(0.0, 1.0, B)[:, None]
    pose = np.column_stack([wps[rows, leg] * (1 - t)
                            + wps[rows, leg + 1] * t,
                            rng.uniform(-np.pi, np.pi, B)])
    n_wp = np.full(B, MISSION_N_WP)
    for dtype, atol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        def on(dev):
            return lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                             device=dev)
        slots = {dev: obstacles.perceive(
            on(dev)(fields), torch.as_tensor(valid, device=dev),
            *map(on(dev), pose.T)) for dev in (DEVICE, "cpu")}
        got, want = slots[DEVICE], slots["cpu"]
        same_rows = np.array_equal(_slot_rows(got, fields, valid),
                                   _slot_rows(want, fields, valid))
        _check_close(f"17a perceive {dtype}",
                     (got.p_obs.cpu(), got.r_obs.cpu()),
                     (want.p_obs, want.r_obs), 0.0, atol)
        flags = (torch.equal(got.collision.cpu(), want.collision)
                 and torch.equal(got.n_visible.cpu(), want.n_visible))
        states = {dev: waypoints.mission_init(on(dev)(wps), n_wp,
                                              on(dev)(meas0[4]))
                  for dev in (DEVICE, "cpu")}
        xy = wps[:, 0].copy()
        werr, same_k = 0.0, True
        for _ in range(40):
            frames = {}
            for dev in (DEVICE, "cpu"):
                states[dev], frames[dev] = waypoints.waypoint_manager(
                    states[dev], on(dev)(wps), n_wp,
                    on(dev)(xy[:, 0]), on(dev)(xy[:, 1]))
            sg, sw = states[DEVICE], states["cpu"]
            same_k &= (torch.equal(sg.k.cpu(), sw.k)
                       and torch.equal(sg.active.cpu(), sw.active))
            fg, fw = frames[DEVICE], frames["cpu"]
            pairs = [(getattr(fg, f).cpu(), getattr(fw, f))
                     for f in ("x1", "y1", "ak", "ye", "target", "u_d")]
            pairs.append((sg.past_psied.cpu(), sw.past_psied))
            _check_close(f"17a waypoint_manager {dtype}",
                         *zip(*pairs), 0.0, atol)
            werr = max(werr, _max_err(*zip(*pairs)))
            d = fw.target.double().numpy() - xy
            xy = xy + 1.2 * d / np.maximum(
                np.linalg.norm(d, axis=1), 1e-9)[:, None]
        done = float((~states["cpu"].active).double().mean())
        n_vis = want.n_visible.numpy()
        print(f"17a perception B={B} {dtype}: slot rows identical "
              f"{same_rows}, max |dp_obs| "
              f"{float((got.p_obs.cpu() - want.p_obs).abs().max()):.3e}, "
              f"collision/n_visible identical {flags} (more than 8 visible "
              f"in {float((n_vis > 8).mean()):.3f}); waypoint_manager 40 "
              f"ticks: k/active identical {same_k}, max |err| {werr:.3e}, "
              f"finished {done:.3f}")
        if not (same_rows and flags and same_k):
            raise AssertionError(f"17a {dtype}: the card's selection or "
                                 "mission state differs from the CPU's")


def _timed_calls(obj, name, store):
    """Record CUDA events around every call of obj.<name> (no sync)."""
    import torch
    fn = getattr(obj, name)

    def run(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        store.append((start, end))
        return out

    setattr(obj, name, run)


def _event_ms(store):
    _sync()
    return np.array([s.elapsed_time(e) for s, e in store])


def _instrumented(obj, name, times, counts):
    """Wrap obj.<name>: each call runs from an idle device to a synced
    result (a node reads its command back every tick), its CUDA-event time
    goes to `times`, and the kernel launches it made to `counts` (a list
    of per-call dicts)."""
    import torch
    fn = getattr(obj, name)

    def run(*args, **kw):
        before = _read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        after = _read_counts()
        times.append(start.elapsed_time(end))
        counts.append({k: after[k] - before[k] for k in after})
        return out

    setattr(obj, name, run)


def _summed(per_call):
    return {k: sum(c[k] for c in per_call) for k in per_call[0]}


def _pcts(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def fleet_mission(card, label, config, gated):
    """17b (production schedule, `gated`) and 17c (`riccati="fused"`): the
    flagship fleet at B=512, N=100, Tf=5, float32, captured tick, over
    the 512 random missions for 1000 ticks.  Launches over the run: K2 one
    per tick; K1 at least 4 per tick and K3 none (sweep), K3 one and K1
    none (fused).  The JAX slow test's gates, enforced when `gated`:
    finite, every k_final >= 2, done >= 0.9, status-0 share > 0.98, and
    clearance > -(0.2 + 1e-3) on the first 20 missions (the others'
    breaches counted).  Tick median/p99 (CUDA events, no sync per tick)
    and the share of the tick outside the solver's graph.  Returns (launch
    counts, the missions beyond the first 20 that breach)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
    wps, fields, valid, meas0 = random_missions(
        B, np.random.default_rng(MISSION_SEED))
    n_wp = np.full(B, MISSION_N_WP)
    engine = FleetMissionEngine(builders.usv_guidance_ca1(), config,
                                device=DEVICE, dtype=torch.float32)
    engine.run(meas0, wps, n_wp, fields, valid, n_steps=2)   # captures
    ticks, solves = [], []
    _timed_calls(engine, "tick", ticks)
    _timed_calls(engine.solver, "step_fn", solves)
    _reset_counts()
    t0 = time.perf_counter()
    log = engine.run(meas0, wps, n_wp, fields, valid, n_steps=MISSION_TICKS)
    counts = _read_counts()
    wall = time.perf_counter() - t0
    tick_ms, solve_ms = _event_ms(ticks), _event_ms(solves)

    f = torch.as_tensor(fields, dtype=torch.float64, device=DEVICE)
    pos = log.pos.double()                                   # (T, B, 2)
    net = torch.linalg.norm(pos[:, :, None, :] - f[None, :, :, :2], dim=-1)
    net = torch.where(torch.as_tensor(valid, device=DEVICE)[None],
                      net - (f[None, :, :, 2] + BOAT_R), torch.inf)
    worst = net.amin(dim=(0, 2)).cpu().numpy()               # (B,)
    finite = bool(torch.isfinite(log.pos).all())
    k_final = log.final.mission_k.cpu().numpy()
    done = float((~log.active[-1]).float().mean())
    ok_frac = float((log.status == 0).float().mean())
    bound = -(SOFT_BAND + 1e-3)
    first_ok = bool((worst[:MISSION_FIRST] > bound).all())
    breach = [int(b) for b in np.nonzero(worst <= bound)[0]
              if b >= MISSION_FIRST]
    per_tick = {k: v / MISSION_TICKS for k, v in counts.items()}
    glue = 1.0 - solve_ms.sum() / tick_ms.sum()
    tp50, tp99 = _pcts(tick_ms)
    print(f"17{label} fleet B={B} {engine.solver.riccati} float32 "
          f"{MISSION_TICKS} ticks: tick p50 {tp50:.3f} ms p99 {tp99:.3f} ms "
          f"(solver graph p50 {np.median(solve_ms):.3f} ms; outside it "
          f"{glue:.3f} of the tick), {wall:.1f} s, launches per tick "
          f"K1 {per_tick['riccati_lanes']:g}, K2 "
          f"{per_tick['linearize_lanes']:g}, K3 "
          f"{per_tick['fused_ipm_lanes']:g} ({card})")
    print(f"17{label} gates{'' if gated else ' (printed, not enforced)'}: "
          f"finite {finite}, min k_final {int(k_final.min())}, done "
          f"{done:.4f}, status-0 {ok_frac:.4f}, first {MISSION_FIRST} "
          f"worst clearance {worst[:MISSION_FIRST].min():.4f} (gate > "
          f"{bound}), the other {B - MISSION_FIRST}: {len(breach)} breach "
          f"{breach}, worst {worst[MISSION_FIRST:].min():.4f}")
    if engine.solver.riccati == "fused":
        launches_ok = (counts["fused_ipm_lanes"] == MISSION_TICKS
                       and counts["linearize_lanes"] == MISSION_TICKS
                       and counts["riccati_lanes"] == 0)
    else:
        launches_ok = (counts["riccati_lanes"] >= 4 * MISSION_TICKS
                       and counts["linearize_lanes"] == MISSION_TICKS
                       and counts["fused_ipm_lanes"] == 0)
    if not launches_ok:
        raise AssertionError(f"17{label}: launch counts {counts}")
    if not finite:
        raise AssertionError(f"17{label}: non-finite track")
    if gated and not (k_final.min() >= 2 and done >= 0.9 and ok_frac > 0.98
                      and first_ok):
        raise AssertionError(f"17{label}: the random-mission gates failed")
    return counts, breach


def _fleet_logs(dtype, device, capture, Bn, ticks):
    """The fleet log's six streams (pos, ye, psi_d, active, collision,
    status) of the first `Bn` random missions, production schedule."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
    wps, fields, valid, meas0 = random_missions(
        Bn, np.random.default_rng(MISSION_SEED))
    engine = FleetMissionEngine(builders.usv_guidance_ca1(), _production(),
                                device=device, dtype=dtype, capture=capture)
    log = engine.run(meas0, wps, np.full(Bn, MISSION_N_WP), fields, valid,
                     n_steps=ticks)
    return [t.cpu() for t in log[:6]]


def cpu_references(fleet_b, fleet_ticks, node_ticks, cascade_ticks):
    """The float64 CPU runs that 17d-17g hold the card against, as numpy:
    `main` runs this in a worker process while the card runs phase 16 and
    17a-17e.  Each node run (17g) closes its own loop; the card replays
    the measurements it was fed."""
    import torch
    torch.set_num_threads(1)
    f64 = torch.float64
    ref = {"17d": [t.numpy() for t in _fleet_logs(f64, "cpu", True, fleet_b,
                                                   fleet_ticks)],
           "17e": [t.numpy() for t in _mission_tensors(_challenge0(
               _instance_boat("cpu"), node_ticks))],
           "17f": [t.double().numpy() for t in _run_cascade(
               *_cascade_controllers("cpu", f64), cascade_ticks)]}
    for name in NODE_BUDGET_MS:
        ref[name] = _node_run(name, "cpu", f64, node_ticks)[:2]
    return ref


def _torch_list(arrays):
    import torch
    return [torch.as_tensor(a) for a in arrays]


def fleet_card_vs_cpu(ref):
    """17d: the first 32 random missions, production schedule, 20 ticks:
    float64 on the card vs the CPU plain path (`ref`; pos/ye/psi_d atol
    5e-6, identical status); the captured fleet's log against the eager
    one's (`capture=False`), float64 and float32, bitwise (the log copies
    what it keeps of the captured tick's outputs)."""
    import torch
    got = _fleet_logs(torch.float64, DEVICE, True, FLEET_CPU_B,
                      FLEET_CPU_TICKS)
    want = _torch_list(ref)
    err = _max_err(got[:3], want[:3])
    same_status = torch.equal(got[5], want[5])
    print(f"17d fleet B={FLEET_CPU_B} float64 card vs CPU "
          f"{FLEET_CPU_TICKS} ticks: max |err| pos/ye/psi_d {err:.3e}, "
          f"status identical {same_status}")
    if err > 5e-6 or not same_status:
        raise AssertionError("17d: the card's fleet disagrees with the CPU")
    for dtype in (torch.float64, torch.float32):
        eager = _fleet_logs(dtype, DEVICE, False, FLEET_CPU_B,
                            FLEET_CPU_TICKS)
        captured = got if dtype == torch.float64 else _fleet_logs(
            dtype, DEVICE, True, FLEET_CPU_B, FLEET_CPU_TICKS)
        same = all(torch.equal(a, b) for a, b in zip(captured, eager))
        print(f"17d fleet {dtype} captured vs eager log: bitwise {same}")
        if not same:
            raise AssertionError(f"17d: captured fleet log != eager {dtype}")


def _boat_controller(device, dtype, capture=True):
    """The flagship node at N=100, Tf=5 on `LaneSolverAdapter` over the
    production schedule."""
    from mpc_collisionavoidance_tpu_torch.guidance import GuidanceController
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.solver.batch import (
        LaneSolverAdapter)
    spec = builders.usv_guidance_ca1()
    return GuidanceController(spec, solver=LaneSolverAdapter(
        _production().build(spec, device=device, dtype=dtype,
                            capture=capture)))


def _challenge0(ctrl, ticks):
    from mpc_collisionavoidance_tpu_torch.sim import mission, scenarios
    field, valid = scenarios.challenge0_field()
    return mission.run_mission(ctrl, (0.7, 0.0, 0.0, 0.0, 0.0),
                               np.array(CHALLENGE0_WPS), 2, field, valid,
                               n_steps=ticks)


def _mission_tensors(log):
    """A MissionLog's track, heading and command streams, on the CPU in
    float64 (exact for every field)."""
    return [t.cpu().double() for t in (log.pos, log.psi, *log.cmds)]


def one_boat(card):
    """17e: the flagship node on `LaneSolverAdapter` (production schedule,
    captured, float32, N=100) flies tests/test_guidance.py's challenge-0
    mission for 1200 ticks: it completes within 1.2 m of (4, 25), stays
    > 1.3 m from buoys 0-3 and never collides; each tick synced (a node
    reads its command back), p99 < 50 ms; K2 1 and K1 >= 4 per tick.
    The captured run's log equals a `capture=False` run's bitwise (20
    ticks).  Returns {(model, label): launch counts}."""
    import torch

    from mpc_collisionavoidance_tpu_torch.sim import mission, scenarios
    ctrl = _boat_controller(DEVICE, torch.float32)
    _challenge0(ctrl, 2)                                  # captures
    times, per_call = [], []
    _instrumented(ctrl, "tick", times, per_call)
    log = _challenge0(ctrl, BOAT_TICKS)
    counts = _summed(per_call)
    field, valid = scenarios.challenge0_field()
    pos = log.pos.cpu().numpy()
    active = log.cmds.active.cpu().numpy()
    end = pos[np.argmax(~active)]
    miss = float(np.hypot(end[0] - 4.0, end[1] - 25.0))
    clear = mission.min_obstacle_clearance(log, field, valid).cpu().numpy()
    collided = bool(log.cmds.collision.any())
    p50, p99 = _pcts(times)
    k1 = min(c["riccati_lanes"] for c in per_call)
    k2 = {c["linearize_lanes"] for c in per_call}
    print(f"17e one boat challenge-0 {BOAT_TICKS} ticks float32 (adapter, "
          f"captured): finished {not bool(active[-1])} {miss:.3f} m from "
          f"(4, 25), buoy clearance {np.round(clear[:4], 3).tolist()}, "
          f"collision {collided}, status-0 "
          f"{float((log.cmds.solver_status == 0).float().mean()):.4f}; tick "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms vs the {BOAT_BUDGET_MS:.0f} ms "
          f"budget; launches per tick K1 >= {k1}, K2 {sorted(k2)} ({card})")
    if not (np.all(np.isfinite(pos)) and not active[-1] and miss < 1.2
            and np.all(clear[:4] > 1.3) and not collided):
        raise AssertionError("17e: the challenge-0 mission gates failed")
    if p99 >= BOAT_BUDGET_MS:
        raise AssertionError(f"17e: tick p99 {p99:.3f} ms over the budget")
    if k1 < 4 or k2 != {1}:
        raise AssertionError(f"17e: launches per tick {per_call[:3]}")
    captured = _mission_tensors(_challenge0(_boat_controller(
        DEVICE, torch.float32), 20))
    eager = _mission_tensors(_challenge0(_boat_controller(
        DEVICE, torch.float32, capture=False), 20))
    same = all(torch.equal(a, b) for a, b in zip(captured, eager))
    print(f"17e adapter mission 20 ticks: captured vs eager log bitwise "
          f"{same}")
    if not same:
        raise AssertionError("17e: captured adapter log != eager log")
    return {(FLAGSHIP, "17e adapter mission"): counts}


def _instance_boat(device, capture=True):
    """The flagship node on `RTISolver` (N=100, 18 fixed iterations) in
    float64."""
    import torch

    from mpc_collisionavoidance_tpu_torch.guidance import GuidanceController
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    spec = builders.usv_guidance_ca1()
    return GuidanceController(spec, solver=RTISolver(
        spec, device=device, dtype=torch.float64, capture=capture))


def _eager(ctrl):
    """`ctrl` with its `RTISolver` replaced by an eager twin
    (`capture=False`: the same OCP and schedule, op by op)."""
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    s = ctrl.solver
    ctrl.solver = RTISolver(s.spec, ipm_iters=s.ipm_iters, ipm_tol=s.ipm_tol,
                            qp_backend=s.qp_backend, centering=s.centering,
                            mu0=s.mu0, device=s.device, dtype=s.dtype,
                            capture=False)
    return ctrl


def _captured_counts(what, c, ticks, programs, k1):
    """Gate a captured per-instance run's launches: K2 once per tick plus
    once per program's capture (its eager warm-up), K1 `k1` per K2."""
    k2 = ticks + programs
    if (c["linearize_lanes"] != k2 or c["riccati_lanes"] != k1 * k2
            or c["fused_ipm_lanes"]):
        raise AssertionError(f"{what}: launch counts {c} over {ticks} "
                             f"ticks and {programs} captures")


def boat_instance(ref):
    """17e, second part: the flagship node on `RTISolver` (captured) in
    float64, card vs CPU (`ref`), 20 challenge-0 ticks at 1e-8, K1 18 and
    K2 1 per tick (and per capture); the same ticks eagerly
    (`capture=False`) bitwise equal.  Returns {(model, label): launch
    counts}."""
    ctrl = _instance_boat(DEVICE)
    _reset_counts()
    got = _mission_tensors(_challenge0(ctrl, NODE_TICKS))
    c = _read_counts()
    err = _max_err(got, _torch_list(ref))
    eager = _mission_tensors(_challenge0(_instance_boat(
        DEVICE, capture=False), NODE_TICKS))
    same = all(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(got, eager))
    programs = len(ctrl.solver._graphs.programs)
    print(f"17e one boat on RTISolver float64 card (captured) vs CPU "
          f"{NODE_TICKS} ticks: max |err| {err:.3e}; vs eager bitwise "
          f"{same}; launches {c} over {NODE_TICKS} ticks and {programs} "
          f"capture(s)")
    if err > 1e-8 or not same:
        raise AssertionError("17e: RTISolver controller card != CPU, or "
                             "captured != eager")
    _captured_counts("17e", c, NODE_TICKS, programs, 18)
    return {(FLAGSHIP, "17e instance"): c}


HULL0 = (0.0, 0.001, 0.0, 0.0, 0.0, 0.0)


def _cascade_controllers(device, dtype, capture=True):
    """The flagship node on the adapter and the `usv_low_level` node on
    `RTISolver` (`capture`: the inner solver's)."""
    from mpc_collisionavoidance_tpu_torch.guidance.low_level import (
        LowLevelController)
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    ll = LowLevelController(builders.usv_low_level(), device=device,
                            dtype=dtype)
    return _boat_controller(device, dtype), (ll if capture else _eager(ll))


def _run_cascade(g, ll, ticks):
    from mpc_collisionavoidance_tpu_torch.sim import cascade, scenarios
    field, valid = scenarios.challenge0_field()
    return cascade.run_cascade(g, ll, cascade.HullState(*HULL0),
                               np.array(CHALLENGE0_WPS), 2, field, valid,
                               n_steps=ticks)


def cascade_loops(card, ref):
    """17f: the two-rate cascade on the challenge-0 course: guidance on
    `LaneSolverAdapter` (production, captured, N=100), the low level
    `usv_low_level` (N=100) on `RTISolver` (8 fixed iterations, captured),
    40 guidance ticks (200 inner), float32: finite, both loops' p50/p99
    (each tick synced) printed beside 50 ms and 10 ms, not gated; its
    first 2 guidance ticks (10 inner) with the inner solver eager
    (`capture=False`) bitwise equal, the eager inner tick's p50/p99
    beside; then float64 card vs CPU (`ref`) for 5 guidance ticks at 1e-6.
    Returns {(model, label): launch counts}."""
    import torch
    g, ll = _cascade_controllers(DEVICE, torch.float32)
    _run_cascade(g, ll, 1)                                # captures
    g_ms, g_counts, ll_ms, ll_counts = [], [], [], []
    _instrumented(g, "tick", g_ms, g_counts)
    _instrumented(ll, "tick", ll_ms, ll_counts)
    t0 = time.perf_counter()
    log = _run_cascade(g, ll, CASCADE_TICKS)
    wall = time.perf_counter() - t0
    logs = []
    eager_ms = []
    for capture in (True, False):
        g2, ll2 = _cascade_controllers(DEVICE, torch.float32, capture)
        if not capture:
            _instrumented(ll2, "tick", eager_ms, [])
        logs.append(_run_cascade(g2, ll2, 2))
    same = _same_bits(tuple(logs[0]), tuple(logs[1]))
    ep = _pcts(eager_ms[1:])
    print(f"17f cascade 2 guidance ticks float32, inner solver captured vs "
          f"eager: bitwise {same}; eager inner tick p50 {ep[0]:.3f} ms p99 "
          f"{ep[1]:.3f} ms")
    if not same:
        raise AssertionError("17f: the captured inner loop differs from "
                             "the eager one")
    finite = all(bool(torch.isfinite(t).all())
                 for t in (log.pos, log.psi, log.u, log.thrust))
    gp, lp = _pcts(g_ms), _pcts(ll_ms)
    gc, lc = _summed(g_counts), _summed(ll_counts)
    print(f"17f cascade {CASCADE_TICKS} guidance ticks "
          f"({len(ll_ms)} inner) float32: finite {finite}, {wall:.1f} s, "
          f"final pos {np.round(log.pos[-1].cpu().numpy(), 3).tolist()}, "
          f"max u {float(log.u.max()):.3f}; guidance tick p50 {gp[0]:.3f} "
          f"ms p99 {gp[1]:.3f} ms beside 50 ms; inner tick p50 {lp[0]:.3f} "
          f"ms p99 {lp[1]:.3f} ms beside 10 ms (not gated); launches per "
          f"inner tick K1 {lc['riccati_lanes'] / len(ll_ms):g}, K2 "
          f"{lc['linearize_lanes'] / len(ll_ms):g} ({card})")
    if not finite:
        raise AssertionError("17f: non-finite cascade")
    got = [t.cpu().double() for t in _run_cascade(
        *_cascade_controllers(DEVICE, torch.float64), CASCADE_CPU_TICKS)]
    err = _max_err(got, _torch_list(ref))
    print(f"17f cascade float64 card vs CPU {CASCADE_CPU_TICKS} guidance "
          f"ticks: max |err| {err:.3e}")
    if err > 1e-6:
        raise AssertionError("17f: the card's cascade disagrees with the CPU")
    return {(FLAGSHIP, "17f cascade guidance"): gc,
            (LOW_LEVEL, "17f cascade inner"): lc}


def _node_drive(name):
    """(build(device, dtype) -> controller, init(ctrl) -> state,
    step(ctrl, state, meas) -> (state, cmds), meas0, plant(meas, cmds) ->
    meas) of one 17g node: usv_pf on the true hull at 100 Hz from 1.5 m
    off an eastward path, usv_acados from rest at 20 Hz, each variant from
    1.5 m off a northward path through a first-order heading plant (a
    rate plant for usv_guidance3, which publishes no heading)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.guidance import nodes, variants
    from mpc_collisionavoidance_tpu_torch.ops.integrators import rk4_step
    from mpc_collisionavoidance_tpu_torch.sim import cascade

    def hull(veh, cmds, dt):
        x = torch.as_tensor(veh, dtype=torch.float64)
        thr = torch.stack([cmds.t_port, cmds.t_stbd]).double().cpu()
        return rk4_step(cascade.hull_dynamics, x, thr,
                        torch.zeros(0, dtype=torch.float64), dt).numpy()

    if name == PF:
        wps = np.array([[0.0, 0.0], [40.0, 0.0]])
        return (lambda dev, dt: nodes.PFController(device=dev, dtype=dt),
                lambda c, veh: c.init_state(_pf_meas(veh), wps, 2),
                lambda c, st, veh: c.tick(st, _pf_meas(veh), wps, 2),
                np.array([0.0, 0.001, 0.0, 0.0, 0.0, 1.5]),
                lambda veh, cmds: hull(veh, cmds, 0.01))
    if name == ACADOS:
        return (lambda dev, dt: nodes.ThrustMPCController(device=dev,
                                                          dtype=dt),
                lambda c, veh: c.init_state(tuple(veh[1:4])),
                lambda c, st, veh: c.tick(st, tuple(veh[1:4])),
                np.array([0.0, 0.001, 0.0, 0.0, 0.0, 0.0]),
                lambda veh, cmds: hull(veh, cmds, 0.05))
    wps = np.array([[0.0, -5.0], [0.0, 25.0]])

    def plant(meas, cmds, dt=0.05):
        u_d = float(cmds.u_d)
        _, v, r0, nedx, nedy, psi0 = meas
        if name == "usv_guidance3":
            r = r0 + dt * (float(cmds.r_d) - r0) / 0.3
            psi = psi0 + dt * r
        else:
            err = np.mod(float(cmds.psi_d) - psi0 + np.pi, 2 * np.pi) - np.pi
            psi = psi0 + dt * err / 0.5
            r = (psi - psi0) / dt
        return np.array([u_d, 0.0, r, nedx + dt * u_d * np.cos(psi),
                         nedy + dt * u_d * np.sin(psi), psi])

    return (lambda dev, dt: variants.VariantGuidanceController(
                name, device=dev, dtype=dt),
            lambda c, m: c.init_state(tuple(m), wps, 2),
            lambda c, st, m: c.tick(st, tuple(m), wps, 2),
            np.array([0.7, 0.0, 0.0, 1.5, 0.0, 0.3]), plant)


def _node_run(name, device, dtype, ticks, meas_seq=None, instrument=None,
              capture=True):
    """Drive node `name` for `ticks` ticks: its plant closes the loop, or
    each tick takes `meas_seq`'s measurement.  `instrument`: (times,
    counts) for `_instrumented`; `capture=False`: its solver eager.
    Returns (the measurements fed, each tick's commands as {field:
    float64 array}, the controller)."""
    build, init, step, meas0, plant = _node_drive(name)
    ctrl = build(device, dtype)
    if not capture:
        _eager(ctrl)
    if instrument is not None:
        _instrumented(ctrl, "tick", *instrument)
    st = init(ctrl, meas0)
    meas, fed, log = meas0, [], []
    for t in range(ticks):
        if meas_seq is not None:
            meas = meas_seq[t]
        fed.append(np.asarray(meas, float))
        st, cmds = step(ctrl, st, meas)
        log.append({f: getattr(cmds, f).cpu().double().numpy()
                    for f in cmds._fields})
        meas = plant(meas, cmds)
    return fed, log, ctrl


def _pf_meas(veh):
    """(psi, u, v, r, nedx, nedy) hull state -> PFMeasurements order."""
    return (veh[1], veh[2], veh[3], veh[4], veh[5], veh[0])


def other_nodes(card, ref):
    """17g: usv_pf (N=100), usv_acados (N=20) and the six variants
    (N=100), on their captured `RTISolver` ticks, each 20 ticks in float64
    on the card against the CPU's run (`ref`, which closed its own loop)
    from the same measurements: commands at 1e-6, identical status; then
    20 float32 ticks on the card, each synced, median and p99 of the 19
    after the capturing one beside the node's budget (printed), and the
    first `NODE_EAGER` measurements through the eager solver
    (`capture=False`): its commands bitwise equal, its median and p99
    beside.  Returns {(model,
    label): launch counts} of the float32 ticks after the first."""
    import torch
    out = {}
    for name, budget in NODE_BUDGET_MS.items():
        fed, want = ref[name]
        t0 = time.perf_counter()
        _, got, _ = _node_run(name, DEVICE, torch.float64, NODE_TICKS,
                              meas_seq=fed)
        pair_s = time.perf_counter() - t0
        values = [f for f in want[0] if f not in ("solver_status", "active")]
        err = max(float(np.abs(g[f] - w[f]).max())
                  for g, w in zip(got, want) for f in values)
        same = all(np.array_equal(g["solver_status"], w["solver_status"])
                   for g, w in zip(got, want))
        times, per_call = [], []
        fed32, got32, c32 = _node_run(name, DEVICE, torch.float32,
                                      NODE_TICKS, instrument=(times,
                                                              per_call))
        counts = _summed(per_call[1:])
        p50, p99 = _pcts(times[1:])
        e_times = []
        _, eager32, _ = _node_run(name, DEVICE, torch.float32, NODE_EAGER,
                                  meas_seq=fed32, instrument=(e_times, []),
                                  capture=False)
        e50, e99 = _pcts(e_times[1:])
        bitwise = all(np.array_equal(g[f], w[f]) for g, w in
                      zip(got32, eager32) for f in g)
        n = NODE_TICKS - 1
        print(f"17g {name} N={c32.spec.N}: float64 card vs CPU "
              f"{NODE_TICKS} ticks max |err| {err:.3e}, status identical "
              f"{same} (card {pair_s:.1f} s); float32 captured tick p50 "
              f"{p50:.3f} ms p99 {p99:.3f} ms, eager p50 {e50:.3f} ms p99 "
              f"{e99:.3f} ms, beside the {budget:.0f} ms budget; captured "
              f"== eager commands bitwise {bitwise}; launches per captured "
              f"tick K1 {counts['riccati_lanes'] / n:g}, K2 "
              f"{counts['linearize_lanes'] / n:g} ({card})")
        if err > 1e-6 or not same:
            raise AssertionError(f"17g {name}: the card disagrees with the "
                                 "CPU")
        if not bitwise:
            raise AssertionError(f"17g {name}: the captured node's commands "
                                 "differ from the eager node's")
        if (counts["linearize_lanes"] != n or counts["fused_ipm_lanes"]
                or counts["riccati_lanes"] != c32.solver.ipm_iters * n):
            raise AssertionError(f"17g {name}: launches {counts} over {n} "
                                 "captured ticks")
        out[(name, "17g node")] = counts
    return out


def _cpu_worker():
    """One spawned worker process for a phase's float64 CPU runs; the
    `with` block that holds it stops it."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))


def guidance_stack(card, cpu):
    """Phase 17: the guidance stack (17a-17g); `cpu` is the future of the
    float64 CPU runs that 17d-17g compare with (`cpu_references`, started
    in a worker process before phase 16), joined before 17d.  Returns
    {(model, label): launch counts} of its main-path runs."""
    t0 = time.perf_counter()

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 17{label} done")

    guidance_perception()
    step_done("a")
    sweep, breach = fleet_mission(card, "b", _production(), gated=True)
    step_done("b")
    fused, _ = fleet_mission(card, "c", _fused(), gated=False)
    step_done("c")
    counts = {(FLAGSHIP, "17b fleet"): sweep,
              (FLAGSHIP, "17c fleet"): fused}
    counts.update(one_boat(card))
    step_done("e (the boat's mission)")
    ref = cpu.result()
    step_done(" CPU references")
    fleet_card_vs_cpu(ref["17d"])
    step_done("d")
    counts.update(boat_instance(ref["17e"]))
    step_done("e")
    counts.update(cascade_loops(card, ref["17f"]))
    step_done("f")
    counts.update(other_nodes(card, ref))
    step_done("g")
    if breach:
        print(f"17b missions beyond the first {MISSION_FIRST} that breach "
              f"the clearance band: {breach}")
    return counts


# ---- phase 18: the lane engine's options ----

# the condensing group sizes of each run (JAX's tests/test_condense_partial
# and benchmarks/bench_condense.py, those that divide the builder's N), and
# the B=1 budget of each run's node in ms
CONDENSE = {FLAGSHIP: (2, 4, 5, 10), HULL: (2, 4), "race_cars_dev_track": (2,)}
OPTION_BUDGET_MS = {FLAGSHIP: 50.0, HULL: 10.0}
OPTION_CPU_B = {FLAGSHIP: 64, HULL: HULL_CPU_B, "race_cars_dev_track": 64}


@dataclasses.dataclass(frozen=True)
class Condensed:
    """The production schedule's `LaneRTISolver` with partial condensing
    by M (`SolverConfig` has no such field, as the JAX package's has
    none): a config with its `build`."""
    M: int

    def build(self, spec, *, device, dtype, capture=True):
        from mpc_collisionavoidance_tpu_torch.solver.batch import (
            LaneRTISolver)
        c = _production()
        return LaneRTISolver(spec, ipm_iters=c.ipm_iters, ipm_tol=c.ipm_tol,
                             riccati=c.riccati, centering=c.centering,
                             mu0=c.mu0, extra_iters=c.extra_iters,
                             stall_tol=c.stall_tol, condense=self.M,
                             device=device, dtype=dtype, capture=capture)


def _pscan():
    import dataclasses as dc
    return dc.replace(_production(), riccati="pscan")


def _pscan_counts(c):
    return (c["riccati_lanes"] == 0 and c["linearize_lanes"] == 1
            and c["fused_ipm_lanes"] == 0)


def _option(label):
    """The config of a phase 18 run label: "M=<M>" or "pscan"."""
    return _pscan() if label == "pscan" else Condensed(int(label[2:]))


# phase 18's runs: (run, label)
OPTION_RUNS = tuple((name, f"M={M}") for name, Ms in CONDENSE.items()
                    for M in Ms) + ((FLAGSHIP, "pscan"), (HULL, "pscan"))


def option_cpu_references():
    """The float64 CPU plain ticks that phase 18 holds the card's against,
    as numpy: `lane_options` runs this in a worker process while the card
    runs the rest of the phase."""
    import torch
    torch.set_num_threads(1)
    out = {}
    for name, label in OPTION_RUNS:
        o, _, sec = f64_tick(name, OPTION_CPU_B[name], _option(label), "cpu")
        out[(name, label)] = (o.u0.numpy(), o.x1.numpy(), o.status.numpy(),
                              sec)
    return out


def lane_options(card, baseline):
    """Phase 18: partial condensing (`condense=M`) and the parallel-scan
    Riccati (`riccati="pscan"`), each on the production schedule.  For
    every run of `OPTION_RUNS`: the float64 card tick vs the CPU plain
    tick (B=64; the hull at B=130), the float32 main-path tick at B=512
    (condensed: K1 >= 4 launches at its macro shape, K2 1, K3 0; pscan:
    K1 0, K2 1, K3 0), a 30-tick closed loop (converged_frac > 0.9; on
    the curved race track the lanes with status 2 counted, as phase 14)
    and B=1 p50/p99 beside the node's budget; `baseline` holds the M=1
    loop and B=1 figures of phases 6, 7 and 9 (this process).  pscan's
    float64 card tick is also held against the card's sweep tick.  Then
    captured vs eager bitwise (phase 15's method, float32 with the RTI
    split) for one condensed and one pscan tick of each model, with each
    graph's nodes, capture and instantiation times.  The CPU ticks run in
    a worker process (`option_cpu_references`) meanwhile.  Returns
    ({(run, label): launch counts}, {(run, label): figures})."""
    import types

    import torch
    counts, table = {}, dict(baseline)
    t0 = time.perf_counter()

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 18 {label} done")

    with _cpu_worker() as pool:
        cpu = pool.submit(option_cpu_references)
        card64 = {}
        for name, label in OPTION_RUNS:
            card64[(name, label)] = f64_tick(name, OPTION_CPU_B[name],
                                             _option(label), DEVICE)[0]
            if label == "pscan":
                out_s = f64_tick(name, OPTION_CPU_B[name], _production(),
                                 DEVICE)[0]
                compare_ticks(f"{name} pscan", card64[(name, label)], out_s,
                              OPTION_CPU_B[name], _dims(name),
                              against="the card's sweep")
        step_done("float64 card ticks")
        for name, label in OPTION_RUNS:
            race = name in RACE
            cfg = _option(label)
            run = name if label == "pscan" else f"{name} {label}"
            counts[(run, "18 " + label)] = main_path_tick(
                name, cfg, _pscan_counts if label == "pscan"
                else _production_counts)
            tick, frac = closed_loop(name, cfg, gate=True, failed_ok=race)
            b1 = latency_b1(name, cfg, OPTION_BUDGET_MS.get(name), ticks=20,
                            versus=(("shooting interval Tf/N",
                                     RACE_INTERVAL_MS) if race else None))
            table[(name, label)] = dict(tick_ms=tick, frac=frac,
                                        b1_p50=b1[0], b1_p99=b1[1])
        step_done("ticks, loops and B=1")
        for name, label in ((FLAGSHIP, "M=4"), (HULL, "M=2"),
                            ("race_cars_dev_track", "M=2"),
                            (FLAGSHIP, "pscan"), (HULL, "pscan")):
            table[(name, label)]["graph"] = captured_vs_eager(
                name, label, _option(label), torch.float32)
        step_done("captured")
        ref = cpu.result()
    for (name, label), (u0, x1, status, sec) in ref.items():
        want = types.SimpleNamespace(u0=torch.as_tensor(u0),
                                     x1=torch.as_tensor(x1),
                                     status=torch.as_tensor(status))
        compare_ticks(f"{name} {label}", card64[(name, label)], want,
                      OPTION_CPU_B[name], _dims(name),
                      against=f"CPU plain ({sec:.1f} s, worker)")
    step_done("card vs CPU")
    return counts, table


# ---- phase 19: the command line ----

CLI = "mpc_collisionavoidance_tpu_torch"
# 19b and 22b: `python -m MODULE ARGS` (runpy.run_module with alter_sys,
# which is what -m runs) in a child interpreter that writes its kernel
# launch counts and device memory to the file named by its first argument
# when it exits; MODULE is its second argument
MODULE_CHILD = """
import atexit, json, runpy, sys
report_path = sys.argv.pop(1)
module = sys.argv.pop(1)


def report():
    import torch
    from mpc_collisionavoidance_tpu_torch.kernels import (ipm, linearize,
                                                          riccati)
    from mpc_collisionavoidance_tpu_torch.solver import capture
    from mpc_collisionavoidance_tpu_torch.utils.profiling import (
        device_memory_stats)
    torch.cuda.synchronize()
    capture.settle_launch_counts()
    with open(report_path, "w") as f:
        json.dump({"counts": {"riccati_lanes": riccati.launches,
                              "linearize_lanes": linearize.launches,
                              "fused_ipm_lanes": ipm.launches},
                   "memory": device_memory_stats()}, f)


atexit.register(report)
sys.argv[0] = module
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
# 19c: `run --config` on the per-instance engine: the JAX suite's config
# (tests/test_cli.py:25-36) for 30 steps and the flagship at its N=100 for
# 20, float64 on the card against the CPU
CLI_CONFIGS = {
    "usv_guidance4": ({"model": "usv_guidance4", "N": 10, "Tf": 0.1,
                       "solver": {"engine": "instance", "ipm_iters": 6}},
                      30),
    FLAGSHIP: ({"model": FLAGSHIP, "N": 100, "Tf": 5.0,
                "solver": {"engine": "instance"}}, 20),
}
# 19d: what the JAX CLI's `mission --challenge 0` prints on the CPU
JAX_MISSION = {"ticks": 600, "frames": 300, "collisions": 0,
               "final_pos": [4.451, 14.377]}
# 19e: the race's steps.  The command's default, 700, took 61.5 s on an
# H100 80GB HBM3 at 700 W (88 ms per eager per-instance tick), past the
# phase's 90 s with 19b-19d; 120 is the JAX suite's depth
# (tests/test_cli.py::test_cli_race)
RACE_STEPS = 120
# 19e's eager comparison: `race --steps 20` with and without --eager
RACE_EAGER_STEPS = 20
# the metrics of `run` that are wall-clock times, not results
CLI_TIMES = ("compile_plus_run_s", "steady_run_s", "solves_per_s_closed_loop")


def _cli(argv):
    """(exit code, stdout's lines) of the port's `cli.main(argv)` in this
    process."""
    import contextlib
    import io

    from mpc_collisionavoidance_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def _config_run(path, steps, device, eager=False):
    rc, lines = _cli(["run", "--config", path, "--steps", str(steps),
                      "--device", device] + (["--eager"] if eager else []))
    if rc != 0:
        raise AssertionError(f"19c run --config {path} on {device}: exit "
                             f"{rc}")
    return json.loads(lines[-1])


def cli_cpu_references(paths):
    """19c's CPU runs (float64, one thread): {name: the run's metrics}.
    `command_line` runs this in a worker process while the card runs
    19b."""
    import torch
    torch.set_num_threads(1)
    return {name: _config_run(paths[name], CLI_CONFIGS[name][1], "cpu")
            for name in CLI_CONFIGS}


def _expect(what, c, k1_per_tick, ticks):
    """K3 none; on the captured per-instance tick K2 one launch per tick
    and K1 `k1_per_tick` per K2, plus one tick's for the capture's eager
    warm-up (one program per run); None: the captured production lane
    tick, K2 at least one per tick and K1 at least 4 (the tick that
    captures also runs an eager warm-up, and escalation adds K1
    launches)."""
    if k1_per_tick is None:
        ok = (c["riccati_lanes"] >= 4 * ticks
              and c["linearize_lanes"] >= ticks)
    else:
        ok = (c["riccati_lanes"] == k1_per_tick * (ticks + 1)
              and c["linearize_lanes"] == ticks + 1)
    if not (ok and c["fused_ipm_lanes"] == 0):
        raise AssertionError(f"{what}: launch counts {c} over {ticks} "
                             "ticks")


def command_line(card):
    """Phase 19: the experiment CLI (`python -m
    mpc_collisionavoidance_tpu_torch`) on the card.  19a `models` as a
    subprocess (meanwhile 19b-19c run); 19b `run --model usv_guidance_ca1`
    at its defaults (1000 steps, N=100, the production lane tick captured,
    B=1) in a child interpreter that reads its launches and peak device
    memory at exit; 19c `run --config` on the per-instance engine, float64,
    card vs CPU (the CPU runs in a worker process during 19b-19d); 19d
    `mission --challenge 0 --markers` (600 ticks, 300 frames read back, no
    collision); 19e `race --steps 120` (per-instance engine, float64).
    `--plots` (19b, 19e) and `--gif` (a 40-tick mission) where matplotlib
    imports.  Returns {(run, label): launch counts}."""
    from mpc_collisionavoidance_tpu_torch.utils import viz
    t0 = time.perf_counter()
    counts = {}

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 19{label} done")

    try:
        import matplotlib  # noqa: F401
        mpl = True
    except ImportError:
        mpl = False
    print(f"19: matplotlib imports on this image: {mpl} (--plots and --gif "
          f"{'passed' if mpl else 'not passed'})")
    with tempfile.TemporaryDirectory() as tmp, _cpu_worker() as pool:
        tmp = pathlib.Path(tmp)
        paths = {}
        for name, (cfg, _) in CLI_CONFIGS.items():
            paths[name] = str(tmp / f"{name}.json")
            pathlib.Path(paths[name]).write_text(json.dumps(cfg))
        cpu = pool.submit(cli_cpu_references, paths)
        models = subprocess.Popen([sys.executable, "-m", CLI, "models"],
                                  cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        # 19b
        report = tmp / "run.json"
        argv = ["run", "--model", FLAGSHIP]
        if mpl:
            argv += ["--plots", str(tmp / "flagship")]
        run = subprocess.run([sys.executable, "-c", MODULE_CHILD,
                              str(report), CLI, *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"19b {' '.join(argv)}: exit "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
        out = json.loads(run.stdout.strip().splitlines()[-1])
        child = json.loads(report.read_text())
        steps = out["steps"]
        peak = child["memory"]["peak_bytes_in_use"]
        print(f"19b python -m {CLI} {' '.join(argv[:3])} ({card}): "
              f"steps {steps}, N {out['N']}, {out['engine']} "
              f"{out['schedule']}, finite {out['finite']}, status_ok_rate "
              f"{out['status_ok_rate']}, compile_plus_run_s "
              f"{out['compile_plus_run_s']}, steady_run_s "
              f"{out['steady_run_s']} ({1e3 * out['steady_run_s'] / steps:.3f}"
              f" ms per tick, {out['solves_per_s_closed_loop']} solves/s), "
              f"ye_mae {out['ye_mae']:.6f}; device memory peak {peak} bytes "
              f"({peak / 2**20:.1f} MiB) of {child['memory']['bytes_limit']}; "
              f"launches {child['counts']}")
        if not (out["finite"] and steps == 1000 and out["N"] == 100):
            raise AssertionError(f"19b: {out}")
        if mpl and not (tmp / "flagship_xy.png").exists():
            raise AssertionError("19b: --plots wrote no flagship_xy.png")
        _expect("19b", child["counts"], None, 2 * steps)
        counts[(FLAGSHIP, "19b run")] = child["counts"]
        step_done("b")
        # 19c
        card_runs = {}
        for name, (cfg, steps) in CLI_CONFIGS.items():
            _reset_counts()
            card_runs[name] = _config_run(paths[name], steps, DEVICE)
            c = _read_counts()
            _expect(f"19c {name}", c, cfg["solver"].get("ipm_iters", 12),
                    2 * steps)
            counts[(name, "19c run --config")] = c
        # one eager comparison: the first config with `--eager`
        name, (cfg, steps) = next(iter(CLI_CONFIGS.items()))
        eager = _config_run(paths[name], steps, DEVICE, eager=True)
        same = all(eager[k] == card_runs[name][k] for k in eager
                   if k not in CLI_TIMES)
        print(f"19c run --config {name} --eager: metrics equal to the "
              f"captured run's {same}; steady_run_s captured "
              f"{card_runs[name]['steady_run_s']}, eager "
              f"{eager['steady_run_s']}")
        if not same:
            raise AssertionError(f"19c {name}: --eager {eager} vs captured "
                                 f"{card_runs[name]}")
        step_done("c (card)")
        # 19d
        markers = tmp / "m.jsonl"
        _reset_counts()
        t = time.perf_counter()
        rc, lines = _cli(["mission", "--device", DEVICE, "--markers",
                          str(markers)])
        sec = time.perf_counter() - t
        c = _read_counts()
        head = json.loads(lines[0])
        frames = viz.read_jsonl(str(markers))
        print(f"19d mission --challenge 0: {head} (JAX's CLI on the CPU: "
              f"{JAX_MISSION}); {len(frames)} frames read back; {sec:.1f} s "
              f"with the markers ({1e3 * sec / head['ticks']:.2f} ms per "
              f"tick); K1 {c['riccati_lanes'] / head['ticks']:g} and K2 "
              f"{c['linearize_lanes'] / head['ticks']:g} per tick")
        if rc != 0 or head["ticks"] != 600 or head["frames"] != 300 \
                or head["collisions"] != 0 or len(frames) != 300:
            raise AssertionError(f"19d: exit {rc}, {head}")
        _expect("19d", c, None, 600)
        counts[(FLAGSHIP, "19d mission")] = c
        if mpl:
            gif = tmp / "mission.gif"
            rc, _ = _cli(["mission", "--device", DEVICE, "--steps", "40",
                          "--stride", "4", "--gif", str(gif)])
            if rc != 0 or gif.read_bytes()[:6] not in (b"GIF87a", b"GIF89a"):
                raise AssertionError("19d: --gif wrote no GIF")
            print("19d mission --steps 40 --gif: GIF written")
        step_done("d")
        rc = models.wait(timeout=300)
        lines = models.stdout.read().strip().splitlines()
        print(f"19a python -m {CLI} models: exit {rc}, {len(lines)} models")
        if rc != 0 or len(lines) != 13:
            raise AssertionError(f"19a: exit {rc}, {models.stderr.read()}")
        ref = cpu.result()
        for name, got in card_runs.items():
            want = ref[name]
            err = max(abs(got[k] - want[k]) for k in want
                      if isinstance(want[k], float) and k not in CLI_TIMES)
            same = all(got[k] == want[k] for k in want
                       if not isinstance(want[k], float))
            print(f"19c run --config {name} {CLI_CONFIGS[name][1]} steps "
                  f"float64 card vs CPU: metrics max |err| {err:.3e}, the "
                  f"rest equal {same}; card steady_run_s "
                  f"{got['steady_run_s']}, CPU {want['steady_run_s']}")
            if err > 1e-9 or not same or not got["finite"]:
                raise AssertionError(f"19c {name}: card {got} vs CPU {want}")
        step_done("c")
        # 19e
        argv = ["race", "--device", DEVICE, "--steps", str(RACE_STEPS)]
        if mpl:
            argv += ["--plots", str(tmp / "race")]
        _reset_counts()
        t = time.perf_counter()
        rc, lines = _cli(argv)
        sec = time.perf_counter() - t
        c = _read_counts()
        out = json.loads(lines[-1])
        print(f"19e race {RACE_STEPS} steps (RTISolver float64, "
              f"captured): {out}; {sec:.1f} s ({1e3 * sec / RACE_STEPS:.1f} "
              f"ms per tick, the capture included); K1 "
              f"{c['riccati_lanes'] / RACE_STEPS:g} and K2 "
              f"{c['linearize_lanes'] / RACE_STEPS:g} per tick")
        if rc != 0 or not out["finite"] or out["s_final"] <= 0.3:
            raise AssertionError(f"19e: exit {rc}, {out}")
        if mpl and not (tmp / "race_track.png").exists():
            raise AssertionError("19e: --plots wrote no race_track.png")
        _expect("19e", c, 18, RACE_STEPS)
        counts[("race_cars_track", "19e race")] = c
        # one eager comparison: RACE_EAGER_STEPS steps with and without
        # --eager, each its own process-wide solver
        runs = {}
        for flag in ((), ("--eager",)):
            t = time.perf_counter()
            rc, lines = _cli(["race", "--device", DEVICE, "--steps",
                              str(RACE_EAGER_STEPS), *flag])
            runs[flag] = (rc, lines[-1], time.perf_counter() - t)
        (rc_c, out_c, sec_c), (rc_e, out_e, sec_e) = runs.values()
        print(f"19e race {RACE_EAGER_STEPS} steps captured vs --eager: "
              f"output equal {out_c == out_e}; {sec_c:.2f} s vs "
              f"{sec_e:.2f} s ({1e3 * sec_e / RACE_EAGER_STEPS:.1f} ms per "
              f"eager tick)")
        if rc_c or rc_e or out_c != out_e:
            raise AssertionError(f"19e: captured {out_c} vs eager {out_e}")
        step_done("e")
    return counts


# ---- phase 20: the mesh ----

MESH_RANKS = 2             # (b): two ranks sharing the card
MESH_LANES = 512           # (b): the escalation tier's lanes, 256 per rank
MESH_TIMEOUT_S = 300       # (b): the launcher's limit; each rank's group
                           # times out in half of it
# (b)'s tick: the escalation tier of JAX's dryrun_multichip
MESH_ESC = dict(ipm_iters=2, extra_iters=12, ipm_tol=3e-6,
                centering="adaptive")
MESH_RANK = "import sys, chip_smoke; chip_smoke.mesh_rank(sys.argv[1])"


def _escalation_inputs():
    """(b)'s global inputs at MESH_LANES lanes: dryrun_multichip's (the
    flagship's scenario, ye perturbed by 0.1 N(0, 1), seed 0), with the
    obstacles of the second half of the lanes (rank 1's) drawn around the
    boat, so that those QPs stall longer than rank 0's: alone, rank 0
    would stop escalating before the mesh does (as the CPU test's
    `tests/torch_parallel_worker.py::escalation_inputs`).  Returns x0b
    (L, 8) batch-first, params (16, L) and lh (8, L) lane-minor."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(0)
    x0b = np.broadcast_to(sc.x0, (MESH_LANES, 8)).astype(np.float64).copy()
    x0b[:, 2] += 0.1 * rng.standard_normal(MESH_LANES)
    p = np.broadcast_to(np.asarray(sc.params, float)[:, None],
                        (16, MESH_LANES)).copy()
    lh = np.broadcast_to(np.asarray(sc.lh, float)[:, None],
                         (8, MESH_LANES)).copy()
    h = MESH_LANES // 2
    p[:, h:] = rng.uniform(-2, 2, (16, h)) * 0.5
    return x0b, p, lh


def _escalation_tick(device, mesh=None, group=None):
    """(b)'s tick, the escalation tier in float64, eager: on this rank's
    lanes of `mesh` (all of them without one), its predicate reduced over
    `group` (None: this process's lanes alone).  Returns (output, state,
    escalation steps, launch counts)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
        shard_batch, shard_lanes)
    from mpc_collisionavoidance_tpu_torch.solver.batch import (
        LaneRTISolver, to_lanes)
    x0b, p, lh = _escalation_inputs()
    lanes = (to_lanes(torch.as_tensor(x0b)), p, lh)
    if mesh is not None:
        x0b, lanes = shard_batch(mesh, x0b), shard_lanes(mesh, lanes)
    solver = LaneRTISolver(_spec(FLAGSHIP), **MESH_ESC, device=device,
                           dtype=torch.float64, capture=False, group=group)
    state = solver.init_state(x0b)
    _reset_counts()
    state, out = solver.step_fn(state, *lanes)
    counts = _read_counts()
    return out, state, int(solver.last_esc_iters), counts


def mesh_rank(outdir):
    """One rank of phase 20(b), started by `parallel.dryrun.launch`: the
    escalation tick on its half of the lanes of a two-rank mesh on the
    one card, and `fleet_metrics` of it, saved to outdir/rank<r>.npz; then
    the same lanes with a rank-local predicate (no group), whose step
    count is saved too.  NCCL refuses two ranks on one GPU, so the ranks
    that share the card run gloo (its CUDA collectives stage through the
    host and cannot be captured: the tick runs eagerly)."""
    import datetime

    import torch
    import torch.distributed as dist

    from mpc_collisionavoidance_tpu_torch.parallel import distributed
    from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
        fleet_metrics)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rank = distributed.init(device=device, backend="gloo",
                            timeout=datetime.timedelta(
                                seconds=MESH_TIMEOUT_S // 2))
    mesh = distributed.make_mesh(device=device)
    out, state, steps, counts = _escalation_tick(device, mesh,
                                                 mesh.get_group())
    frac, gmax = fleet_metrics(mesh, out.status, out.gap)
    local_steps = _escalation_tick(device, mesh)[2]
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), steps=steps,
             local_steps=local_steps,
             metrics=np.array([float(frac), float(gmax)]),
             counts=np.array([counts[k] for k in sorted(counts)]),
             **{k: v.cpu().numpy() for k, v in (*out._asdict().items(),
                                                *state._asdict().items())})
    dist.destroy_process_group()


def mesh_phase(card):
    """Phase 20: the scenario-parallel layer (`parallel/`) on the one card.
    (a) one rank, NCCL (a one-rank group), captured ticks:
    `dryrun_multichip` at the flagship's full shape with every JAX gate,
    then the production tick at B=512 float32 with the lane axis over the
    one-rank mesh (its escalation predicate all-reduced in the captured
    graph, in the unconditional segment before each escalation step, so
    extra_iters times a replay) bitwise equal to the same tick without a
    mesh, capturing call and replay, with equal escalation counts and
    K1 >= 4, K2 = 1 counted on the replay.  A one-rank all-reduce moves
    nothing: (a) shows that the collective captures and replays, not
    NCCL between GPUs.  (b) two ranks sharing the card (gloo, eager;
    `mesh_rank`, started first so that they start while (a) runs): the
    escalation tier in float64 at L=512, 256 lanes each, on inputs where
    rank 1's lanes stall longer, against this process's tick over the
    512 lanes (1e-12, identical status, the same escalation count on both
    ranks; rank 0 alone would stop earlier), and `fleet_metrics` equal
    on both ranks and to this process's.  Returns {(run, label): launch
    counts}."""
    import concurrent.futures

    import torch
    import torch.distributed as dist

    from mpc_collisionavoidance_tpu_torch.parallel import distributed, dryrun
    from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
        fleet_metrics)
    t0 = time.perf_counter()
    counts = {}

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 20{label} done")

    outdir = tempfile.mkdtemp(prefix="mesh_ranks_")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(dryrun.launch, MESH_RANKS, ["-c", MESH_RANK, outdir],
                        MESH_TIMEOUT_S)
    try:
        # ---- (a) one rank, NCCL, captured ----
        mesh = distributed.global_scenario_mesh(device=DEVICE)
        print(f"  20a: a {mesh.size()}-rank {dist.get_backend()} mesh on "
              f"{card}")
        _reset_counts()
        metrics = dryrun.dryrun_multichip(
            device=DEVICE, log=lambda line: print("  " + line))
        counts[(FLAGSHIP, "mesh dryrun")] = c = _read_counts()
        print(f"  20a dryrun_multichip(1): {json.dumps(metrics)}; "
              f"launches {c}")
        step_done("a (dryrun_multichip)")
        plain, st, x, p, lh, _ = _setup(FLAGSHIP, B, torch.float32, DEVICE,
                                        _production())
        meshed = _production().build(_spec(FLAGSHIP), device=DEVICE,
                                     dtype=torch.float32,
                                     group=mesh.get_group())
        for call in ("capturing call", "replay"):
            _, want = plain.step_fn(st, x, p, lh)
            k_plain = int(plain.last_esc_iters)
            _reset_counts()
            _, got = meshed.step_fn(st, x, p, lh)
            c = _read_counts()
            k = int(meshed.last_esc_iters)
            _bitwise(f"mesh production tick B={B} float32 {call}", got, want)
            if k != k_plain:
                raise AssertionError(f"mesh tick {call}: escalation {k}, "
                                     f"without the mesh {k_plain}")
        if not _production_counts(c):
            raise AssertionError(f"mesh tick launches {c}")
        counts[(FLAGSHIP, "mesh tick")] = c
        print(f"  20a: production tick B={B} float32 on the one-rank "
              f"mesh == without it, bitwise (capturing call and replay), "
              f"escalation {k} = {k_plain}, launches {c}")
        step_done("a (the meshed production tick)")

        # ---- (b) two ranks sharing the card, gloo, eager ----
        want, wstate, steps, _ = _escalation_tick(torch.device(DEVICE))
        ref = [float(v) for v in fleet_metrics(mesh, want.status, want.gap)]
        code, text = ranks.result()
        if code != 0:
            raise AssertionError(f"20b: the ranks failed (exit {code}):\n"
                                 f"{text[-4000:]}")
        data = [np.load(os.path.join(outdir, f"rank{r}.npz"))
                for r in range(MESH_RANKS)]
        err = 0.0
        for k, v in (*want._asdict().items(), *wstate._asdict().items()):
            got = np.concatenate([d[k] for d in data], axis=-1)
            v = v.cpu().numpy()
            if k == "status":
                if not np.array_equal(got, v):
                    raise AssertionError("20b: status differs")
                continue
            err = max(err, float(np.abs(got - v).max()))
        rank_steps = [int(d["steps"]) for d in data]
        local_steps = [int(d["local_steps"]) for d in data]
        rank_metrics = [d["metrics"].tolist() for d in data]
        print(f"  20b: {MESH_RANKS} gloo ranks x {MESH_LANES // MESH_RANKS} "
              f"lanes, escalation tier float64: max |err| {err:.3e} vs one "
              f"process, escalation {rank_steps} (one process {steps}; "
              f"each rank alone {local_steps}), fleet_metrics "
              f"{rank_metrics} (one process {ref})")
        if err > 1e-12 or rank_steps != [steps] * MESH_RANKS:
            raise AssertionError("20b: the two ranks differ from one "
                                 "process")
        # the inputs split the ranks, so a rank-local predicate would fail
        if not local_steps[0] < steps:
            raise AssertionError(f"20b: rank 0 alone runs {local_steps[0]} "
                                 f"escalation steps, the mesh {steps}: the "
                                 "check cannot tell a rank-local predicate")
        if (rank_metrics[0] != rank_metrics[1]
                or rank_metrics[0][0] != ref[0]
                or abs(rank_metrics[0][1] - ref[1]) > 1e-12):
            raise AssertionError("20b: fleet_metrics differ")
        summed = np.sum([d["counts"] for d in data], axis=0)
        counts[(FLAGSHIP, "mesh gloo")] = dict(zip(
            sorted(_launch_counts()), (int(n) for n in summed)))
        step_done("b (two gloo ranks)")
    finally:
        pool.shutdown(wait=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    print("  20: NCCL across GPUs (the captured all-reduce moving data "
          "between cards) and scaling: not measured, this host has one GPU")
    return counts


# ---- phase 21: the native nodes ----

NATIVE_TICKS = 2500          # guidance_node_demo's default
CASCADE_GTICKS = 1400        # cascade_demo's default
# the two-leg mission's server (tests/test_guidance_node_cpp.py:242-270)
NATIVE_MISSION = dict(model=FLAGSHIP, N=100, Tf=5.0, ipm_iters=14)
# the native cascade's two servers (tests/test_low_level_node_cpp.py:203-206)
CASCADE_GUIDANCE = dict(model=FLAGSHIP, N=40, Tf=3.0, ipm_iters=14)
CASCADE_LOW_LEVEL = dict(model=LOW_LEVEL, N=40, Tf=1.0, ipm_iters=12)
# the live thrust loop (tests/test_low_level_node_cpp.py:137-190)
THRUST_LOOP = dict(model=LOW_LEVEL, N=30, Tf=1.0, ipm_iters=8)
THRUST_TICKS, THRUST_GUARD = 40, 20
QUARANTINE_LANE = 3
QUARANTINE_FIXED_ITERS = 15


def _native_sources(*names):
    src = REPO / "rt_client"
    return [str(src / n) for n in names]


def build_native_nodes():
    """21a: the unchanged C++ nodes, built with g++ into build/rt_client/
    (no cmake: the card's host may lack it), the three in parallel:
    `guidance_node_demo`, `cascade_demo` and `libnmpc_low_level_node.so`
    (the low-level node and the client in one library, for ctypes)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise AssertionError("g++ not found: the native nodes cannot be "
                             "built")
    out = REPO / "build" / "rt_client"
    out.mkdir(parents=True, exist_ok=True)
    base = [gxx, "-std=c++17", "-O2", f"-I{REPO / 'rt_client'}"]
    client, guidance, low = ("nmpc_rt_client.cpp", "nmpc_guidance_node.cpp",
                             "nmpc_low_level_node.cpp")
    targets = {
        "guidance_node_demo": base + _native_sources(
            "guidance_node_demo.cpp", guidance, client) + ["-lm"],
        "cascade_demo": base + _native_sources(
            "cascade_demo.cpp", guidance, low, client) + ["-lm"],
        "libnmpc_low_level_node.so": base + ["-fPIC", "-shared"]
        + _native_sources(low, client) + ["-lm"],
    }
    procs = {name: subprocess.Popen(argv + ["-o", str(out / name)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, argv in targets.items()}
    for name, proc in procs.items():
        log = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            raise AssertionError(f"g++ {name} failed: {log[-2000:]}")
    return {name: out / name for name in targets}


def _tail_fields(line):
    """The `key value` pairs of a demo's last line ("bad_status 3/700"
    keeps its text)."""
    return {k: (float(v) if re.fullmatch(r"-?[\d.]+", v) else v)
            for k, v in re.findall(r"([a-z_]+) (-?[\d./]+)", line)}


def _run_native(argv, what, timeout=600):
    """Run a native demo to its end: (its last line's fields, wall s);
    a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(a) for a in argv], capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    last = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
    print(f"  {what}: exit {proc.returncode} in {wall:.2f} s: {last}")
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    return _tail_fields(last), wall


def _exact(k1, k2):
    """A served tick's launch counts: exactly `k1` K1 and `k2` K2."""
    return lambda c: c == {"riccati_lanes": k1, "linearize_lanes": k2,
                           "fused_ipm_lanes": 0}


def _solve_pcts(server, n):
    return _pcts(list(server.solve_ms)[-n:])


def native_mission(card, demo, transport):
    """21b/21c: `guidance_node_demo <addr> 2500` against an in-process
    captured flagship server (N=100, Tf=5, 14 IPM iterations, the lane
    engine) over a Unix socket or TCP loopback (a free port): exit 0, the
    segment switch and the final capture; K1 14 and K2 1 per served
    tick."""
    address = "127.0.0.1:0" if transport == "tcp" else None

    def drive(server):
        addr = (f"127.0.0.1:{server.bound_port}" if transport == "tcp"
                else server.path)
        tail, wall = _run_native([demo, addr, NATIVE_TICKS],
                                 f"guidance_node_demo over {transport}")
        ticks = int(tail["ticks"])
        if tail.get("switched") != 1 or tail.get("done") != 1:
            raise AssertionError(f"the native mission over {transport} did "
                                 f"not switch or finish: {tail}")
        return dict(ticks=ticks, wall_s=wall, ms_per_tick=wall / ticks * 1e3,
                    worst_latency_us=tail["worst_latency_us"],
                    bad_status=tail["bad_status"],
                    min_center_dist=tail["min_center_dist"],
                    solve_ms_p50_p99=_solve_pcts(server, ticks))

    counts, row = _served(f"native mission server ({transport})", drive,
                          {"tick": _exact(14, 1)}, address=address,
                          **NATIVE_MISSION)
    print(f"  21{'c' if transport == 'tcp' else 'b'} two-leg mission over "
          f"{transport}: {row['ticks']} ticks in {row['wall_s']:.2f} s, "
          f"{row['ms_per_tick']:.3f} ms per tick, worst_latency_us "
          f"{row['worst_latency_us']:.0f}, server solve_ms p50/p99 "
          f"{row['solve_ms_p50_p99'][0]:.3f}/{row['solve_ms_p50_p99'][1]:.3f}"
          f", K1 14 and K2 1 per served tick ({card})")
    return counts, row


def native_cascade(card, demo):
    """21d: `cascade_demo g.sock ll.sock 1400` against two captured port
    servers on the one card in this process (guidance N=40, Tf=3, 14
    iterations; `usv_low_level` N=40, Tf=1, 12 iterations): exit 0,
    progress past the buoy line, no thrust outside the box; K1 and K2
    per served tick counted per server."""
    with _serving(**CASCADE_GUIDANCE) as g, \
            _serving(**CASCADE_LOW_LEVEL) as ll:
        calls = {"guidance": _count_phases(g), "low level": _count_phases(ll)}
        _reset_counts()
        tail, wall = _run_native([demo, g.path, ll.path, CASCADE_GTICKS],
                                 "cascade_demo")
        counts = _read_counts()
        gticks = int(tail["gticks"])
        row = dict(gticks=gticks, wall_s=wall,
                   ms_per_guidance_tick=wall / gticks * 1e3,
                   bad_status=tail["bad_status"],
                   min_center_dist=tail["min_center_dist"],
                   guidance_solve_ms_p50_p99=_solve_pcts(g, gticks),
                   low_level_solve_ms_p50_p99=_solve_pcts(ll, 5 * gticks))
    if tail.get("progressed") != 1 or tail.get("thrust_violations") != 0:
        raise AssertionError(f"the native cascade failed its gates: {tail}")
    _gate_calls("cascade guidance server", calls["guidance"],
                {"tick": _exact(14, 1)})
    _gate_calls("cascade low-level server", calls["low level"],
                {"tick": _exact(12, 1)})
    per = {name: {k: sum(c[k] for c in got["tick"]) for k in counts}
           for name, got in calls.items()}
    if {k: per["guidance"][k] + per["low level"][k] for k in counts} \
            != counts:
        raise AssertionError(f"21d: the servers' ticks {per} do not add up "
                             f"to the run's launches {counts}")
    gp, lp = (row["guidance_solve_ms_p50_p99"],
              row["low_level_solve_ms_p50_p99"])
    print(f"  21d native cascade, two servers on one card: {gticks} guidance "
          f"ticks and {5 * gticks} low-level requests in {wall:.2f} s, "
          f"{row['ms_per_guidance_tick']:.3f} ms per guidance tick (its 1 "
          f"guidance and 5 low-level solves, beside the 50 ms period); "
          f"solve_ms p50/p99 guidance {gp[0]:.3f}/{gp[1]:.3f}, low level "
          f"{lp[0]:.3f}/{lp[1]:.3f} (beside 10 ms); launches guidance "
          f"{per['guidance']}, low level {per['low level']} ({card})")
    return {(FLAGSHIP, "21d cascade guidance"): per["guidance"],
            (LOW_LEVEL, "21d cascade low level"): per["low level"]}, row


class _LlMeas(ctypes.Structure):
    _fields_ = [("psi", ctypes.c_float), ("u", ctypes.c_float),
                ("v", ctypes.c_float), ("r", ctypes.c_float)]


class _LlCmds(ctypes.Structure):
    _fields_ = [("t_port", ctypes.c_float), ("t_stbd", ctypes.c_float),
                ("e_u", ctypes.c_float), ("e_psi", ctypes.c_float),
                ("tx", ctypes.c_float), ("tz", ctypes.c_float),
                ("solver_status", ctypes.c_uint32)]


class _LlNode(ctypes.Structure):
    _fields_ = [("past_t_port", ctypes.c_float),
                ("past_t_stbd", ctypes.c_float),
                ("have_cmd", ctypes.c_int), ("last", _LlCmds)]


def _low_level_library(path):
    """ctypes bindings of the low-level node (`nmpc_low_level_node.h`)
    and the client's connect/close."""
    lib = ctypes.CDLL(str(path))
    lib.ll_init.argtypes = [ctypes.POINTER(_LlNode)]
    lib.ll_tick.restype = ctypes.c_int
    lib.ll_tick.argtypes = [ctypes.POINTER(_LlNode), ctypes.c_void_p,
                            ctypes.c_uint32, ctypes.POINTER(_LlMeas),
                            ctypes.c_float, ctypes.c_float,
                            ctypes.POINTER(_LlCmds)]
    lib.nmpc_rt_connect.restype = ctypes.c_void_p
    lib.nmpc_rt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.nmpc_rt_close.argtypes = [ctypes.c_void_p]
    return lib


def thrust_script():
    """The JAX test's 40-tick script (tests/test_low_level_node_cpp.py:
    144-161): raw u (0 at tick 20), the guarded measurements (psi, u, v,
    r), psi_d and u_d, float32."""
    T = THRUST_TICKS
    raw_u = [0.0 if t == THRUST_GUARD else 0.4 + 0.2 * np.sin(t / 5)
             for t in range(T)]
    meas = np.array([[0.3 * np.sin(t / 7),
                      0.001 if raw_u[t] == 0.0 else raw_u[t],
                      0.05 * np.cos(t / 9), 0.1 * np.sin(t / 4)]
                     for t in range(T)], np.float32)
    psi_ds = 0.4 * np.cos(np.arange(T) / 10).astype(np.float32)
    u_ds = (0.8 + 0.1 * np.sin(np.arange(T) / 6)).astype(np.float32)
    return np.asarray(raw_u, np.float32), meas, psi_ds, u_ds


def thrust_loop(card, lib_path):
    """21e: the live thrust loop on the card: `ll_tick` over the 40-tick
    script through a captured `usv_low_level` server (N=30, Tf=1, 8
    iterations), K1 8 and K2 1 per served tick; every tick's thrusts
    against the port's `LowLevelController` (cuda, float32) ticked from
    the server's warm start before that tick, the node's carried thrusts
    and the measurement (all 40 in one batched tick), atol 1e-3."""
    import torch

    from mpc_collisionavoidance_tpu_torch.guidance.low_level import (
        LowLevelController, LowLevelMeasurements, LowLevelState)
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import SolverState
    lib = _low_level_library(lib_path)
    raw_u, meas, psi_ds, u_ds = thrust_script()

    def drive(server):
        c = lib.nmpc_rt_connect(server.path.encode(), 30000)
        if not c:
            raise AssertionError("21e: nmpc_rt_connect failed")
        node, thrust, carried, warm = _LlNode(), [], [], []
        lib.ll_init(ctypes.byref(node))
        try:
            for t in range(THRUST_TICKS):
                if t:   # the server is idle between a reply and a request
                    (lane,) = server._lane_of.values()
                    st = server._lane_state
                    warm.append((st.xbar[:, :, lane].T.clone(),
                                 st.ubar[:, :, lane].T.clone()))
                carried.append([node.past_t_port, node.past_t_stbd])
                m = _LlMeas(float(meas[t, 0]), float(raw_u[t]),
                            float(meas[t, 2]), float(meas[t, 3]))
                cmd = _LlCmds()
                rc = lib.ll_tick(ctypes.byref(node), c, t + 1,
                                 ctypes.byref(m), float(psi_ds[t]),
                                 float(u_ds[t]), ctypes.byref(cmd))
                if rc != 0 or cmd.solver_status not in (0, 1):
                    raise AssertionError(f"21e tick {t}: rc {rc}, status "
                                         f"{cmd.solver_status}")
                if raw_u[t] == 0.0 and abs(cmd.e_u - (u_ds[t] - 0.001)) \
                        >= 1e-6:
                    raise AssertionError(f"21e: e_u {cmd.e_u} at the guard")
                thrust.append([cmd.t_port, cmd.t_stbd])
        finally:
            lib.nmpc_rt_close(c)
        return np.asarray(thrust), warm, np.asarray(carried, np.float32)

    counts, (native, warm, carried) = _served(
        "thrust loop server", drive, {"tick": _exact(8, 1)}, **THRUST_LOOP)
    spec = builders.usv_low_level(Tf=THRUST_LOOP["Tf"], N=THRUST_LOOP["N"])
    ctrl = LowLevelController(spec, ipm_iters=THRUST_LOOP["ipm_iters"],
                              device=DEVICE, dtype=torch.float32)
    seed = ctrl.init_state(LowLevelMeasurements(*meas[0])).solver
    state = LowLevelState(
        SolverState(torch.stack([seed.xbar] + [x for x, _ in warm]),
                    torch.stack([seed.ubar] + [u for _, u in warm])),
        *torch.from_numpy(carried).to(DEVICE).T)
    _, cmds = ctrl.tick(state, LowLevelMeasurements(*meas.T), psi_ds, u_ds)
    port = torch.stack([cmds.t_port, cmds.t_stbd], -1).cpu().numpy()
    err = float(np.abs(native - port).max())
    print(f"  21e live thrust loop, {THRUST_TICKS} ticks through the card's "
          f"server: max |thrust - LowLevelController| {err:.3e} (atol "
          f"1e-3), K1 8 and K2 1 per served tick ({card})")
    if err > 1e-3:
        raise AssertionError("21e: the native node's thrusts differ from "
                             "the controller's")
    return counts, dict(ticks=THRUST_TICKS, max_abs_err=err)


def _quarantine_tick(config, dtype, device, poisoned=True):
    """One flagship tick at B=512 of `config` from the bench's inputs,
    lane QUARANTINE_LANE's x0 NaN if `poisoned`: the outputs as CPU
    tensors and the tick's escalation iterations."""
    solver, st, x, p, lh, refs = _setup(FLAGSHIP, B, dtype, device, config)
    if poisoned:
        x = x.clone()
        x[0, QUARANTINE_LANE] = float("nan")
    _, out = solver.step_fn(st, x, p, lh, **refs)
    return (type(out)(*(t.cpu().clone() for t in out)),
            int(solver.last_esc_iters))


def quarantine_cpu_reference():
    """21f's float64 CPU plain production tick on the poisoned batch, as
    numpy (run in a worker process while the card runs 21b-21e)."""
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out, esc = _quarantine_tick(_production(), torch.float64, "cpu")
    return ([t.numpy() for t in out], esc, time.perf_counter() - t0)


def _quarantined(what, out, clean=None):
    """The poisoned lane reads status 2, no other does, every other lane
    is finite; with `clean`, the healthy lanes equal it bitwise."""
    import torch
    ok = torch.arange(B) != QUARANTINE_LANE
    status = out.status
    if status[QUARANTINE_LANE] != 2 or (status[ok] == 2).any():
        raise AssertionError(f"{what}: status {status[QUARANTINE_LANE]} on "
                             f"the poisoned lane, {int((status[ok] == 2).sum())}"
                             " other lanes with status 2")
    if not all(torch.isfinite(t[..., ok]).all() for t in (out.u0, out.x1,
                                                           out.gap)):
        raise AssertionError(f"{what}: a healthy lane is not finite")
    if clean is not None and not all(
            torch.equal(a[..., ok], b[..., ok])
            for a, b in zip((out.u0, out.x1, out.gap),
                            (clean.u0, clean.x1, clean.gap))):
        raise AssertionError(f"{what}: a healthy lane differs from the "
                             "clean batch")


def quarantine(card, cpu):
    """21f: the NaN quarantine on the captured flagship tick at B=512,
    lane 3's x0 NaN, float64 and float32: at 15 fixed iterations the
    healthy lanes equal the clean batch's bitwise; at the production
    schedule status 2 on that lane alone, every other lane finite, and in
    float64 the card's tick within 5e-6 of the CPU plain one (`cpu`, the
    future of `quarantine_cpu_reference`), identical status, the same
    escalation count."""
    import torch

    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    fixed = SolverConfig(ipm_iters=QUARANTINE_FIXED_ITERS)
    row, poisoned = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        clean, _ = _quarantine_tick(fixed, dtype, DEVICE, poisoned=False)
        bad, _ = _quarantine_tick(fixed, dtype, DEVICE)
        _quarantined(f"21f {name} {QUARANTINE_FIXED_ITERS} iterations", bad,
                     clean)
        poisoned[name] = out, esc = _quarantine_tick(_production(), dtype,
                                                     DEVICE)
        _quarantined(f"21f {name} production", out)
        _, esc_clean = _quarantine_tick(_production(), dtype, DEVICE,
                                        poisoned=False)
        row[name] = dict(escalation=esc, escalation_clean=esc_clean)
        print(f"  21f {name}: lane {QUARANTINE_LANE} status 2 alone, the "
              f"other {B - 1} finite; {QUARANTINE_FIXED_ITERS} fixed "
              f"iterations: healthy lanes bitwise the clean batch's; "
              f"production escalation {esc} (clean batch {esc_clean})")
    (u0, x1, gap, status), esc_cpu, cpu_s = cpu.result()
    want = type(out)(*(torch.from_numpy(a) for a in (u0, x1, gap, status)))
    out, esc = poisoned["float64"]
    ok = torch.arange(B) != QUARANTINE_LANE
    err = max(float((a[..., ok] - b[..., ok]).abs().max())
              for a, b in ((out.u0, want.u0), (out.x1, want.x1)))
    same = bool(torch.equal(out.status, want.status))
    row["float64"].update(card_vs_cpu=err, status_identical=same,
                          escalation_cpu=esc_cpu)
    print(f"  21f float64 production, card vs CPU plain ({cpu_s:.1f} s) on "
          f"the poisoned batch: max |du0|, |dx1| {err:.3e} (atol 5e-6), "
          f"status identical {same}, escalation {esc} vs {esc_cpu} ({card})")
    if err > 5e-6 or not same or esc != esc_cpu:
        raise AssertionError("21f: the card's poisoned production tick "
                             "differs from the CPU's")
    return row


def native_nodes(card):
    """Phase 21: the native C++ nodes served by the port (21a-21f).
    Returns ({(model, label): launch counts} of its main-path runs, its
    table)."""
    t0 = time.perf_counter()

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 21{label} done")

    with _cpu_worker() as pool:
        cpu = pool.submit(quarantine_cpu_reference)
        built = build_native_nodes()
        step_done("a (g++)")
        counts, table = {}, {}
        for label, transport in (("b", "uds"), ("c", "tcp")):
            c, table[label] = native_mission(
                card, built["guidance_node_demo"], transport)
            counts[(FLAGSHIP, f"21{label} native mission")] = c
            step_done(f"{label} (the mission over {transport})")
        print(f"  21b/21c ms per tick: UDS {table['b']['ms_per_tick']:.3f}, "
              f"TCP {table['c']['ms_per_tick']:.3f} ({card})")
        c, table["d"] = native_cascade(card, built["cascade_demo"])
        counts.update(c)
        step_done("d (the cascade)")
        counts[(LOW_LEVEL, "21e thrust loop")], table["e"] = thrust_loop(
            card, built["libnmpc_low_level_node.so"])
        step_done("e (the thrust loop)")
        table["f"] = quarantine(card, cpu)
        step_done("f (the quarantine)")
    return counts, table


# ---- phase 22: the acados parity bridge ----

PARITY = "mpc_collisionavoidance_tpu_torch.parity.run_acados_parity"
# 22b: the fixtures that the port's eager float64 RTISolver records on the
# CPU (`record_fixture`) and the card replays, with their ticks
REPLAY_TICKS = {FLAGSHIP: 30, HULL: 20}
# 22b: the card's replay against the CPU's recording, float64
REPLAY_TOL = 1e-9
# 22b: K1 launches per replay tick, one per IPM iteration (REPLAY_SOLVER)
REPLAY_K1 = 30
# 22c: what the runner prints without acados (the JAX package's message)
NO_ACADOS = "acados_template/casadi not installed"


def parity_fixtures(outdir):
    """22b's fixtures, recorded on the CPU in float64 on one thread (`main`
    runs this in a worker process while the card runs phases 18-21):
    {model: path}."""
    import torch

    from mpc_collisionavoidance_tpu_torch.parity.run_acados_parity import (
        record_fixture)
    torch.set_num_threads(1)
    return {name: record_fixture(os.path.join(outdir, f"{name}.npz"), name,
                                 ticks, device="cpu")
            for name, ticks in REPLAY_TICKS.items()}


def _skipped_columns(what, J, C, m):
    """The Jacobian columns outside f_dep: exact identity (states) or zero
    (controls); C's outside h_dep: exact zero.  Returns the failures."""
    import torch
    bad = []
    for k in sorted(set(range(m.nx + m.nu)) - set(m.f_dep)):
        col = torch.zeros(m.nx, dtype=J.dtype, device=J.device)
        if k < m.nx:
            col[k] = 1.0
        if not torch.equal(J[:, :, k, :], col[None, :, None].expand(
                J.shape[0], m.nx, J.shape[-1])):
            bad.append(f"{what} J column {k} (outside f_dep)")
    for k in sorted(set(range(m.nx)) - set(m.h_dep or ())):
        if C.numel() and bool(C[:, :, k, :].any()):
            bad.append(f"{what} C column {k} (outside h_dep)")
    return bad


def transcription_vs_k2():
    """22a: every K2 form on the card against the CasADi transcription
    (`parity/casadi_models.py::linearize_lanes`: `numeric_f` through
    `ops.integrators`' RK4 sensitivities, `numeric_h` through
    `torch.func.jacfwd`), at phase 3's L=512 float64 inputs and tolerances
    (atol 1e-10, rtol 1e-12 on the hydrodynamic J), and the columns that
    K2 skips exact in both.  Every form is checked before a miss fails the
    phase; a miss prints its worst point.  Returns {form: {"max_abs_err":
    ...}}."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import linearize
    from mpc_collisionavoidance_tpu_torch.parity import casadi_models
    from mpc_collisionavoidance_tpu_torch.utils import track
    errs, misses = {}, []
    forms = [*linearize.CUDA_MODELS,
             *(f"{name}_track" for name in linearize.TRACK_FORMS)]
    for form in forms:
        spec = _spec(form)
        m = spec.model
        name, curved = RACE.get(form, (form, False))
        kappa_fn = (track.make_kappa_fn(track.make_synthetic_track())
                    if curved else None)
        rng = np.random.default_rng(100 + B)        # phase 3's seed at L=B
        args = [torch.as_tensor(a, dtype=torch.float64, device=DEVICE)
                for a in _linearize_inputs(form, m, spec.N, B, rng, spec.dt)]
        kw = dict(dt=spec.dt, integrator_steps=spec.integrator_steps)
        got = linearize.linearize_lanes_cuda(*args, model=m, **kw)
        want = casadi_models.linearize_lanes(name, *args, kappa_fn=kappa_fn,
                                             **kw)
        torch.cuda.synchronize()
        per = {}
        for out, g, w in zip(("xn", "J", "hbar", "C"), got, want):
            rtol = 1e-12 if (form != FLAGSHIP and out == "J") else 0.0
            per[out] = _max_err([g], [w])
            if g.shape != w.shape or not torch.isfinite(g).all() or \
                    not torch.allclose(g, w, rtol=rtol, atol=1e-10):
                excess = ((g - w).abs() - rtol * w.abs()) if \
                    g.shape == w.shape else None
                where = (tuple(int(i) for i in np.unravel_index(
                    int(excess.argmax()), g.shape))
                    if excess is not None and excess.numel() else ())
                misses.append(f"{form} {out}: max |err| {per[out]:.3e} over "
                              f"rtol {rtol}, atol 1e-10, worst at {where} "
                              f"(layout {tuple(g.shape)}): K2 "
                              f"{float(g[where]) if where else None}, "
                              f"transcription "
                              f"{float(w[where]) if where else None}; "
                              f"inputs: phase 3's at L={B}, seed {100 + B}")
        skipped = _skipped_columns(f"{form} K2", got[1], got[3], m) + \
            _skipped_columns(f"{form} transcription", want[1], want[3], m)
        misses += skipped
        errs[form] = {"max_abs_err": max(per.values())}
        print(f"22a {form} N={spec.N} L={B} float64, K2 vs the "
              f"transcription: max|err| {errs[form]['max_abs_err']:.3e} (xn "
              f"{per['xn']:.3e}, J {per['J']:.3e}, hbar {per['hbar']:.3e}, C "
              f"{per['C']:.3e}); the {m.nx + m.nu - len(m.f_dep)} J columns "
              f"outside f_dep exact in both: {not skipped}")
    if misses:
        raise AssertionError("22a: K2 apart from the transcription:\n" +
                             "\n".join(misses))
    return errs


def acados_bridge(card, fixtures):
    """Phase 22: the acados parity bridge.  (b) and (c) start as child
    interpreters, then (a) runs here: (a) `transcription_vs_k2`; (b) each
    fixture of `parity_fixtures` (the future `fixtures`) replayed on the
    card by `python -m ...run_acados_parity --replay <file>` with no
    `--device`, within REPLAY_TOL of the CPU's recording, its K1 and K2
    launches read at the child's exit (K1 30 and K2 1 per tick, one tick
    more for the capture's eager warm-up); (c) `run_acados_parity
    usv_guidance_ca1` exits 2 with the no-acados message.  Returns
    ({(model, label): launch counts}, {form: 22a's figures})."""
    t0 = time.perf_counter()

    def step_done(label):
        print(f"  [{time.perf_counter() - t0:.1f} s] 22{label} done")

    paths = fixtures.result()
    step_done(" CPU fixtures (waited for)")
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        def child(label, argv):
            out = open(tmp / f"{label}.out", "w")
            err = open(tmp / f"{label}.err", "w")
            return subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                    stdout=out, stderr=err), out, err

        def finish(label, started):
            proc, out, err = started
            rc = proc.wait(timeout=300)
            out.close()
            err.close()
            return (rc, (tmp / f"{label}.out").read_text(),
                    (tmp / f"{label}.err").read_text())

        replays = {name: child(name, ["-c", MODULE_CHILD,
                                      str(tmp / f"{name}.json"), PARITY,
                                      "--replay", path])
                   for name, path in paths.items()}
        no_acados = child("no_acados", ["-m", PARITY, FLAGSHIP])
        errs = transcription_vs_k2()
        step_done("a")
        for name, started in replays.items():
            rc, out, err = finish(name, started)
            if rc != 0:
                raise AssertionError(f"22b --replay {name}: exit {rc}: "
                                     f"{err[-2000:]}")
            res = json.loads(out.strip().splitlines()[-1])
            c = json.loads((tmp / f"{name}.json").read_text())["counts"]
            ticks = REPLAY_TICKS[name]
            print(f"22b python -m {PARITY} --replay {name}.npz ({ticks} ticks "
                  f"recorded by the CPU's float64 RTISolver, replayed on "
                  f"{card}, captured): max_u_dev {res['max_u_dev']:.3e}, "
                  f"max_x_dev {res['max_x_dev']:.3e} (gate {REPLAY_TOL}); "
                  f"K1 {c['riccati_lanes']} and K2 {c['linearize_lanes']} "
                  f"launches, {c['riccati_lanes'] / (ticks + 1):g} and "
                  f"{c['linearize_lanes'] / (ticks + 1):g} per tick over "
                  f"the {ticks} replayed ticks and the capture's warm-up "
                  f"tick")
            if res["variant"] != name or res["ticks"] != ticks \
                    or not res["ok"] or res["max_u_dev"] > REPLAY_TOL \
                    or res["max_x_dev"] > REPLAY_TOL:
                raise AssertionError(f"22b {name}: {res}")
            _expect(f"22b {name}", c, REPLAY_K1, ticks)
            counts[(name, "22b replay")] = c
        step_done("b")
        rc, out, err = finish("no_acados", no_acados)
        print(f"22c python -m {PARITY} {FLAGSHIP}: exit {rc}, stderr "
              f"{err.strip()[:120]!r}...")
        if rc != 2 or NO_ACADOS not in err or out.strip():
            raise AssertionError(f"22c: exit {rc}, stdout {out!r}, stderr "
                                 f"{err[-2000:]!r}")
        step_done("c")
    return counts, errs


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

    # the float64 CPU ticks that phases 5-14 hold the card's against run
    # in a worker process, started after the kernels' timings, while the
    # card runs those phases; they are checked after phase 14
    with _cpu_worker() as pool:
        cpu_ticks = pool.submit(tick_cpu_references)
        # the flagship production tick
        card_vs_cpu_tick(FLAGSHIP, B)
        counts = {(FLAGSHIP, "sweep"): main_path_tick(
            FLAGSHIP, _production(), _production_counts)}
        # M=1 of phase 18's condensed runs: the production loop and B=1
        # tick
        baseline = {}

        def keep(name, loop, b1):
            baseline[(name, "M=1")] = dict(tick_ms=loop[0], frac=loop[1],
                                           b1_p50=b1[0], b1_p99=b1[1])

        keep(FLAGSHIP, closed_loop(FLAGSHIP, _production(), gate=True),
             latency_b1(FLAGSHIP, _production(), 50.0))
        mission()
        phase_done("phases 5-8 (the flagship)")
        # the hull production tick
        card_vs_cpu_tick(HULL, HULL_CPU_B)
        counts[(HULL, "sweep")] = main_path_tick(HULL, _production(),
                                                 _production_counts)
        keep(HULL, closed_loop(HULL, _production(), gate=True),
             latency_b1(HULL, _production(), 10.0))
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
        check_cpu_ticks(cpu_ticks.result())
    phase_done("phases 5-14's card ticks vs the CPU's")
    captured_ticks()
    phase_done("phase 15 (captured ticks)")
    # phase 17's float64 CPU runs start in a worker with phase 16, so
    # that the card does not wait for them
    with _cpu_worker() as pool:
        guidance_cpu = pool.submit(cpu_references, FLEET_CPU_B,
                                   FLEET_CPU_TICKS, NODE_TICKS,
                                   CASCADE_CPU_TICKS)
        instance, instance_times, programs = instance_engine(card)
        counts.update(instance)
        print("phase 16 table: " + json.dumps({
            "16f": {f"{n} {backend} B={Bn}": dict(zip(
                ("captured_ms", "captured_p99_ms", "eager_ms",
                 "eager_p99_ms"), row))
                for (n, backend, Bn), row in instance_times.items()},
            "16g": programs}))
        phase_done("phase 16 (the per-instance engine)")
        counts.update(guidance_stack(card, guidance_cpu))
    phase_done("phase 17 (the guidance stack)")
    # phase 22's fixtures: recorded on the CPU in a worker process while
    # the card runs phases 18-21
    with tempfile.TemporaryDirectory() as parity_dir, \
            _cpu_worker() as parity_pool:
        fixtures = parity_pool.submit(parity_fixtures, parity_dir)
        options, table = lane_options(card, baseline)
        counts.update(options)
        phase_done("phase 18 (the lane engine's options)")
        print("phase 18 table: " + json.dumps(
            {f"{n} {label}": v for (n, label), v in table.items()}))
        counts.update(command_line(card))
        phase_done("phase 19 (the command line)")
        counts.update(mesh_phase(card))
        phase_done("phase 20 (the mesh)")
        native, table = native_nodes(card)
        counts.update(native)
        phase_done("phase 21 (the native nodes)")
        print("phase 21 table: " + json.dumps(table))
        bridge, bridge_errs = acados_bridge(card, fixtures)
        counts.update(bridge)
        phase_done("phase 22 (the acados parity bridge)")
        print("phase 22 table: " + json.dumps(bridge_errs))

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
