"""Time K3, the fused whole IPM, of this checkout against other builds of
the same C entries (`nmpc_fused_ipm_lanes`, `nmpc_fused_ipm_scratch`), in
one process on one card.

    python -m tools.k3_compare [NAME=DIR ...] [--json PATH]

DIR holds a build's `ipm_lanes.cu` and its instance files (and, where it
differs, its own `ipm_lanes.cuh`); e.g. the first K3 kernel, of commit
14788bf:

    mkdir -p build/k3_14788bf && for f in ipm_lanes.cuh ipm_lanes.cu \
        ipm_lanes_{flagship,hull}_{float,double}.cu; do git show \
        14788bf:mpc_collisionavoidance_tpu_torch/csrc/$f \
        > build/k3_14788bf/$f; done
    python -m tools.k3_compare old=build/k3_14788bf

Each DIR's .cu files are compiled by their own nvcc processes, in
parallel (the flags of `kernels/_build.py`, `-I DIR -I` the port's csrc/),
into build/k3_compare/NAME/, and the ptxas register/spill report of its
K3 instances is printed.  For both structures at N=100, 12 iterations, L
in {1, 128, 512} float32 and 512 float64, on QPs of the fused solver's own
assembly (`chip_smoke.fused_qp`, seeded by L as in `chip_smoke.py` phase
4), every build's dx, du, gap is held against
the checkout's kernel ("repo"; float64 dx/du atol 1e-9 and gap rtol 1e-9,
float32 du atol 5e-3; a build named probe_* is a timing probe with parts
of the work cut out, so its error is recorded and not held), then all are
timed in turns (the others, repo,
repo, the others reversed: each twice), CUDA events over 5 back-to-back
launches of the C entry each, the median of 3 (`chip_smoke.launch_ms`),
beside the bound (`chip_smoke.bound`, `chip_smoke.ipm_work`).  In float32
every build's du and the plain version's are also measured against the
float64 plain solve of the same QP (the float32 error of each).  One line
per shape is printed; with --json the table goes to PATH.  Needs a CUDA
device.
"""

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

import chip_smoke
from mpc_collisionavoidance_tpu_torch.kernels import _build
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    fused_ipm_lanes_plain)

OUT = _build.REPO_ROOT / "build" / "k3_compare"
N = 100
SHAPES = ((1, "float32"), (128, "float32"), (512, "float32"),
          (512, "float64"))


def _nvcc(cmd):
    return subprocess.run(cmd, capture_output=True, text=True)


def build_variant(name, src_dir):
    """Compile every .cu of `src_dir` into build/k3_compare/<name>/ and
    link them; returns (library, ptxas report lines of the K3 kernels)."""
    src_dir = pathlib.Path(src_dir).resolve()
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    units = sorted(src_dir.glob("*.cu"))
    objs = [out / (u.stem + ".o") for u in units]
    flags = [*_build.NVCC_FLAGS, "-I", str(src_dir), "-I", str(_build.CSRC)]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        procs = list(pool.map(_nvcc, [
            [_build.find_nvcc(), *flags, "-c", "-o", str(o), str(u)]
            for u, o in zip(units, objs)]))
    for proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               f"{proc.stderr[-4000:]}")
    lib = out / "libk3.so"
    proc = _nvcc([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                  str(lib), *map(str, objs)])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    log = "".join(p.stdout + p.stderr for p in procs)
    dll = ctypes.CDLL(str(lib))
    for entry in ("nmpc_fused_ipm_lanes", "nmpc_fused_ipm_scratch"):
        fn = getattr(dll, entry)
        fn.argtypes = _build._ENTRIES[entry]
        fn.restype = _build._RESTYPES.get(entry, ctypes.c_int)
    return dll, _k3_report(log)


def _k3_report(log):
    report = chip_smoke.spill_report(log)
    return [f"{n}: spill stores/loads {v}" for n, v in report.items()
            if "fused_ipm_kernel" in n]


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("k3_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = dict(a.split("=", 1) for a in args.variants)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    with concurrent.futures.ThreadPoolExecutor(len(variants) + 1) as pool:
        builds = {n: pool.submit(build_variant, n, p)
                  for n, p in variants.items()}
        libs = {"repo": _build.library()}
        reports = {"repo": _k3_report(
            (pathlib.Path(libs["repo"]._name).parent / "nvcc.log")
            .read_text())}
        for name, fut in builds.items():
            libs[name], reports[name] = fut.result()
    for name, lines in reports.items():
        print(f"{name}:")
        for line in lines:
            print("  " + line)
    others = [n for n in libs if n != "repo"]
    order = [*others, "repo", "repo", *reversed(others)]
    rows = []
    for ocp in (chip_smoke.FLAGSHIP, chip_smoke.HULL):
        for L, dname in SHAPES:
            dtype = getattr(torch, dname)
            qp, iu, ix = chip_smoke.fused_qp(ocp, L, dtype, seed=L)
            runs = {n: chip_smoke.ipm_launcher(lib, qp, iu, ix,
                                               chip_smoke.K3_ITERS)
                    for n, lib in libs.items()}
            for call, _ in runs.values():
                call()
            torch.cuda.synchronize()
            want = runs["repo"][1]
            err = {}
            for n, (_, out) in runs.items():
                err[n] = chip_smoke._max_err(out[:2], want[:2])
                what = f"{n} {ocp} L={L} {dname}"
                if n.startswith("probe_"):
                    continue
                if dtype == torch.float64:
                    chip_smoke._check_close(what, out[:2], want[:2], 0.0,
                                            1e-9)
                    chip_smoke._check_close(what, out[2:3], want[2:3], 1e-9,
                                            0.0)
                elif float((out[1] - want[1]).abs().max()) > 5e-3:
                    raise AssertionError(f"{what}: du differs by more than "
                                         "5e-3")
            if dtype == torch.float32:
                # every build's du and the float32 plain version's against
                # the float64 plain solve of the same QP
                qp64 = qp._replace(**{k: v.double() for k, v in
                                      qp._asdict().items() if v is not None})
                du64 = fused_ipm_lanes_plain(qp64, iu, ix,
                                             iters=chip_smoke.K3_ITERS)[1]
                du32 = fused_ipm_lanes_plain(qp, iu, ix,
                                             iters=chip_smoke.K3_ITERS)[1]
                vs64 = {n: float((out[1].double() - du64).abs().max())
                        for n, (_, out) in runs.items()}
                vs64["plain float32"] = float((du32.double() - du64)
                                              .abs().max())
                vs64["repo vs plain float32"] = float(
                    (want[1] - du32).abs().max())
                print(f"K3 {ocp} L={L} float32: max |du - du of the float64 "
                      "plain solve| " + ", ".join(
                          f"{n} {e:.3e}" for n, e in vs64.items()))
            else:
                vs64 = None
            ms = {n: [] for n in libs}
            for n in order:
                ms[n].append(chip_smoke.launch_ms(runs[n][0], launches=5))
            item = qp.A.element_size()
            structure = chip_smoke.structure_of(qp, iu, ix)
            bound_ms, by = chip_smoke.bound(
                *chip_smoke.ipm_work(N, structure, L, chip_smoke.K3_ITERS,
                                     item), item)
            rows.append(dict(ocp=ocp, structure=structure, N=N, L=L,
                             dtype=dname, iters=chip_smoke.K3_ITERS, ms=ms,
                             max_abs_err_vs_repo=err,
                             du_err_vs_float64_plain=vs64, bound_ms=bound_ms,
                             bound_by=by, card=card))
            print(f"K3 {ocp} L={L} {dname}: " + ", ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in ms[n])} ms"
                for n in libs) + f"; bound {bound_ms:.4f} ms ({by})")
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"shapes": rows, "ptxas": reports},
                                  indent=1))
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
