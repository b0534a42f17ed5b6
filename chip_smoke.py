"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (`mpc_collisionavoidance_tpu_torch`), the
production RTI tick of the flagship OCP `usv_guidance_ca1` (nx=8, nu=1,
N=100, 8 soft obstacle rows), through its hand-written CUDA kernels, and
exits non-zero if anything fails.  Phases:

1. environment: torch, device, `nvidia-smi` name and power limit, nvcc,
   and the kernels' build (nvcc at first use, into build/torch_kernels/);
2. K1 (Riccati sweep) vs its plain PyTorch version on the card: random
   SPD LQRs at N=100, (nx, nu) in {(8, 1), (14, 2)}, L in {1, 130, 512},
   float32 (rtol 2e-4, atol 2e-5) and float64 (atol 1e-10);
3. K2 (fused linearization) vs its plain version on the card: the
   flagship at N=100, L in {1, 512}, float32 (xn/hbar rtol 2e-5 atol 2e-6,
   J/C rtol 2e-4 atol 2e-5) and float64 (atol 1e-10);
4. one production tick at B=512: float64 on the card vs the plain path on
   the CPU from the same inputs (u0/x1 atol 5e-6, identical status), then
   float32 on the card, with the kernels' launch counts for that tick
   (K1 >= 4, K2 = 1);
5. a 30-tick warm-started float32 closed loop at B=512 (converged_frac of
   the last tick, gap < 1e-5, must exceed 0.9) and its median tick time;
6. B=1 latency: p50/p99 over 50 ticks against the 50 ms budget at 20 Hz;
7. the 1000-tick float32 mission at B=512 (mission_converged_frac > 0.9).

Times come from CUDA events.  The line before the last is a JSON object
with one entry per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
float32 matrix products run in full float32 (TF32 off, set below).
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
B = 512


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


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


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
    print(smi.stdout.strip().splitlines()[0])
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    # registers and spills of every kernel instance (ptxas -v)
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line or "spill" in line \
                or "Used" in line:
            print("  " + line.strip())


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
    return LaneLQR(*(torch.as_tensor(f, dtype=dtype, device="cuda")
                     for f in fields))


def check_riccati():
    """K1 vs lqr_solve_lanes_plain on the card; returns (max float32
    error, kernel ms, plain ms) at the flagship shape."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import riccati
    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
        lqr_solve_lanes_plain)
    N = 100
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for (nx, nu) in ((8, 1), (14, 2)):
        for L in (1, 130, 512):
            for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                                      (torch.float64, 0.0, 1e-10)):
                d = _random_lqr(N, nx, nu, L, seed=nx * 1000 + L,
                                dtype=dtype)
                got = riccati.lqr_solve_lanes_cuda(*d)
                want = lqr_solve_lanes_plain(d)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"K1 riccati nx={nx} nu={nu} L={L} "
                      f"{str(dtype)[6:]}: max|err| {err:.3e}")
                _check_close(f"K1 ({nx},{nu}) L={L} {dtype}", got, want,
                             rtol, atol)
    d = _random_lqr(N, 8, 1, B, seed=1, dtype=torch.float32)
    ms = _tick_ms(lambda: riccati.lqr_solve_lanes_cuda(*d), 50)
    plain_ms = _tick_ms(lambda: lqr_solve_lanes_plain(d), 5)
    print(f"K1 at N=100 nx=8 nu=1 L={B} float32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return worst[torch.float32], worst[torch.float64], ms, plain_ms


def check_linearize():
    """K2 vs linearize_lanes_plain on the card; returns (max float32 error,
    max float64 error, kernel ms, plain ms) at the flagship shape."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import linearize
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
        linearize_lanes_plain)
    spec = builders.usv_guidance_ca1()
    m = spec.model
    N = spec.N
    kw = dict(model=m, dt=spec.dt, integrator_steps=spec.integrator_steps)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    tols32 = ((2e-5, 2e-6), (2e-4, 2e-5), (2e-5, 2e-6), (2e-4, 2e-5))
    for L in (1, B):
        rng = np.random.default_rng(100 + L)
        xs = rng.normal(size=(m.nx, N, L)) * 0.5
        ub = rng.normal(size=(m.nu, N, L)) * 0.2
        prm = rng.uniform(2.0, 50.0, size=(m.np_, L))
        for dtype in (torch.float32, torch.float64):
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in (xs, ub, prm)]
            got = linearize.linearize_lanes_cuda(*args, **kw)
            want = linearize_lanes_plain(*args, **kw)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst[dtype] = max(worst[dtype], err)
            print(f"K2 linearize N={N} L={L} {str(dtype)[6:]}: "
                  f"max|err| {err:.3e}")
            for name, g, w, (rtol, atol) in zip(("xn", "J", "hbar", "C"),
                                                got, want, tols32):
                if dtype == torch.float64:
                    rtol, atol = 0.0, 1e-10
                _check_close(f"K2 {name} L={L} {dtype}", [g], [w], rtol,
                             atol)
            if dtype == torch.float32 and L == B:
                ms = _tick_ms(lambda: linearize.linearize_lanes_cuda(
                    *args, **kw), 50)
                plain_ms = _tick_ms(lambda: linearize_lanes_plain(
                    *args, **kw), 5)
    print(f"K2 at N={N} L={B} float32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return worst[torch.float32], worst[torch.float64], ms, plain_ms


def _flagship(Bn, dtype, device, seed=SEED):
    """Solver, warm start and lane inputs of the bench's throughput
    workload (bench.py:109-127): guidance_ca1_default, ye perturbed."""
    import torch

    from mpc_collisionavoidance_tpu_torch.config import production_engine
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
    spec = builders.usv_guidance_ca1()
    sc = scenarios.guidance_ca1_default()
    m = spec.model
    solver = production_engine().build(spec, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (Bn, m.nx)).copy()
    x0s[:, 2] += 0.1 * rng.standard_normal(Bn)

    def lanes(a):
        return to_lanes(torch.tensor(np.asarray(a), dtype=dtype)).to(device)

    state = solver.init_state(x0s)
    return (solver, state, lanes(x0s),
            lanes(np.broadcast_to(sc.params, (Bn, m.np_))),
            lanes(np.broadcast_to(sc.lh, (Bn, m.nh))))


def _check_output(out, Bn, what):
    import torch
    if tuple(out.u0.shape) != (1, Bn) or tuple(out.x1.shape) != (8, Bn):
        raise AssertionError(f"{what}: output shapes {tuple(out.u0.shape)}"
                             f", {tuple(out.x1.shape)}")
    for name in ("u0", "x1", "gap"):
        if not torch.isfinite(getattr(out, name)).all():
            raise AssertionError(f"{what}: non-finite {name}")


def production_tick():
    """Phase 4; returns the launch counts of the float32 tick."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import linearize, riccati
    solver, st, x, p, lh = _flagship(B, torch.float64, "cuda")
    st, out = solver.step_fn(st, x, p, lh)
    solver_c, st_c, x_c, p_c, lh_c = _flagship(B, torch.float64, "cpu")
    t0 = time.perf_counter()
    st_c, out_c = solver_c.step_fn(st_c, x_c, p_c, lh_c)
    cpu_s = time.perf_counter() - t0
    _check_output(out, B, "float64 card tick")
    du0 = float((out.u0.cpu() - out_c.u0).abs().max())
    dx1 = float((out.x1.cpu() - out_c.x1).abs().max())
    same_status = bool((out.status.cpu() == out_c.status).all())
    print(f"tick B={B} float64, card vs CPU plain ({cpu_s:.1f} s): "
          f"max|du0| {du0:.3e}, max|dx1| {dx1:.3e}, status identical "
          f"{same_status}, status-0 {float((out.status == 0).double().mean()):.3f}")
    if du0 > 5e-6 or dx1 > 5e-6 or not same_status:
        raise AssertionError("float64 card tick disagrees with the CPU "
                             "plain tick")

    solver, st, x, p, lh = _flagship(B, torch.float32, "cuda")
    torch.cuda.synchronize()
    riccati.launches = 0
    linearize.launches = 0
    st, out = solver.step_fn(st, x, p, lh)        # the main path
    torch.cuda.synchronize()
    counts = {"riccati_lanes": riccati.launches,
              "linearize_lanes": linearize.launches}
    _check_output(out, B, "float32 card tick")
    print(f"tick B={B} float32: launches {counts}, max gap "
          f"{float(out.gap.max()):.3e}, status-0 "
          f"{float((out.status == 0).float().mean()):.3f}")
    if counts["riccati_lanes"] < 4 or counts["linearize_lanes"] != 1:
        raise AssertionError(f"main path launch counts {counts}: expected "
                             "K1 >= 4 and K2 == 1")
    return counts


def closed_loop(ticks=30):
    """Phase 5: warm-started closed loop, x0 <- x1."""
    import torch
    solver, st, x, p, lh = _flagship(B, torch.float32, "cuda")
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    _check_output(out, B, "closed loop")
    frac = float((out.gap < 1e-5).float().mean())
    tick_ms = float(np.median(times[2:]))
    print(f"closed loop {ticks} ticks B={B} float32: converged_frac "
          f"{frac:.4f}, median tick {tick_ms:.3f} ms "
          f"({B / tick_ms * 1e3:.1f} solves/s), first tick "
          f"{times[0]:.3f} ms")
    if frac <= 0.9:
        raise AssertionError(f"closed loop converged_frac {frac} <= 0.9")
    return tick_ms, frac


def latency_b1(ticks=50):
    """Phase 6: single-vehicle tick latency."""
    import torch
    solver, st, x, p, lh = _flagship(1, torch.float32, "cuda")
    for _ in range(3):                                 # warm-up
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    _check_output(out, 1, "B=1 latency")
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    print(f"B=1 tick float32: p50 {p50:.3f} ms, p99 {p99:.3f} ms vs the "
          f"50 ms budget at 20 Hz: {'within' if p99 < 50.0 else 'OVER'}")
    return float(p50), float(p99)


def mission(ticks=1000):
    """Phase 7: the reference's 1000-tick closed loop from a cold start."""
    import torch
    solver, st, x, p, lh = _flagship(B, torch.float32, "cuda")
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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    environment()
    k1_err32, k1_err64, k1_ms, k1_plain = check_riccati()
    k2_err32, k2_err64, k2_ms, k2_plain = check_linearize()
    counts = production_tick()
    closed_loop()
    latency_b1()
    mission()

    pkg = "mpc_collisionavoidance_tpu_torch"
    print(json.dumps({"kernels": [
        {"name": "riccati_lanes", "route": "cuda",
         "source": f"{pkg}/csrc/riccati_lanes.cu",
         "replaces": "mpc_collisionavoidance_tpu/kernels/riccati_pallas.py:215",
         "launches": counts["riccati_lanes"],
         "max_abs_err": max(k1_err32, k1_err64), "ms": k1_ms,
         "plain_ms": k1_plain},
        {"name": "linearize_lanes", "route": "cuda",
         "source": f"{pkg}/csrc/linearize_lanes.cu",
         "replaces": "mpc_collisionavoidance_tpu/kernels/linearize_pallas.py:151",
         "launches": counts["linearize_lanes"],
         "max_abs_err": max(k2_err32, k2_err64), "ms": k2_ms,
         "plain_ms": k2_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
