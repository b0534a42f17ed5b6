"""Time K1, the lane Riccati sweep, of this checkout against other builds of
the same C entry (`nmpc_riccati_lanes`), in one process on one card.

    python -m tools.k1_compare [NAME=PATH ...] [--shapes NXxNU ...]
                               [--json PATH]

PATH is a build's K1 source: one `riccati_lanes.cu` holding the kernel
and its instances (K1 before its split into instance files), or a
directory holding a build's `riccati_lanes.cu`, its instance files and,
where they differ, its own headers.  Each PATH's .cu files are compiled by
their own nvcc processes, in parallel (the flags of `kernels/_build.py`,
`-I` the directory, `-I` the port's csrc/), into build/k1_compare/NAME/,
and its ptxas register/spill report is printed.  For each K1 instance of
`--shapes` (default: every one in `chip_smoke.K1_SHAPES`; a build that
lacks one fails) at N=100 and L in {1, 128, 512} float32 and 512
float64, every build's dx/du
is held against the checkout's kernel ("repo"; float32 rtol 2e-4 atol
2e-5, float64 atol 1e-10; a build named probe_* is a timing probe with
parts of the work cut out, so its error is recorded and not held), then all
are timed in turns (the others,
repo, repo, the others reversed: each twice), CUDA events over 50 back-to-back
launches of the C entry each (`chip_smoke.launch_ms`), beside the bound
(`chip_smoke.bound`).  One line per shape is printed, and per build the
count of some SASS opcodes of each K1 instance (`cuobjdump -sass`); both
go to PATH with --json.  Needs a CUDA device.
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

OUT = _build.REPO_ROOT / "build" / "k1_compare"
N = 100


def _nvcc(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def build_variant(name, src):
    """Compile the .cu file `src`, or every .cu of the directory `src`,
    into build/k1_compare/<name>/ and link them; returns (library, ptxas
    report lines)."""
    src = pathlib.Path(src).resolve()
    units = sorted(src.glob("*.cu")) if src.is_dir() else [src]
    inc = src if src.is_dir() else src.parent
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    objs = [out / (u.stem + ".o") for u in units]
    flags = [*_build.NVCC_FLAGS, "-I", str(inc), "-I", str(_build.CSRC)]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        logs = list(pool.map(_nvcc, [
            [_build.find_nvcc(), *flags, "-c", "-o", str(o), str(u)]
            for u, o in zip(units, objs)]))
    lib = out / "libk1.so"
    _nvcc([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
           str(lib), *map(str, objs)])
    report = [ln.strip() for ln in "".join(logs).splitlines()
              if "entry function" in ln or "spill" in ln or "Used" in ln]
    dll = ctypes.CDLL(str(lib))
    dll.nmpc_riccati_lanes.argtypes = _build._ENTRIES["nmpc_riccati_lanes"]
    dll.nmpc_riccati_lanes.restype = ctypes.c_int
    return dll, report


OPCODES = ("FFMA", "DFMA", "LDS", "STS", "LDGSTS", "LDG", "STG", "LD", "ST",
           "BAR", "SHFL", "MUFU", "CALL", "BRA")


def sass_census(lib):
    """{kernel instance: {opcode: count}} of the K1 kernels in `lib`, from
    `cuobjdump -sass` (the instructions as compiled, not as executed)."""
    dump = subprocess.run(
        [str(pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    census, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = (fn[fn.index("kernelI") + 7:fn.index("EEEv")]
                    if "riccati_lanes_kernel" in fn else None)
            if name:
                census[name] = dict.fromkeys(OPCODES, 0)
        elif name and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].split()[0]
            op = line.split("*/", 1)[1].split()[1] if op.startswith("@") \
                else op
            base = op.split(".")[0]
            if base in census[name]:
                census[name][base] += 1
    return census


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", metavar="NAME=PATH")
    ap.add_argument("--shapes", nargs="*", default=None, metavar="NXxNU",
                    help="these K1 instances only (e.g. 8x1 14x2)")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("k1_compare: no CUDA device")
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
        for name, fut in builds.items():
            libs[name], report = fut.result()
            print(f"{name} ({variants[name]}):")
            for line in report:
                print("  " + line)
    census = {}
    for name, lib in libs.items():
        census[name] = sass_census(lib._name)
        for inst, ops in census[name].items():
            print(f"SASS {name} {inst}: " + ", ".join(
                f"{op} {k}" for op, k in ops.items() if k))
    others = [n for n in libs if n != "repo"]
    order = [*others, "repo", "repo", *reversed(others)]
    shapes = (chip_smoke.K1_SHAPES if args.shapes is None else
              [tuple(map(int, a.split("x"))) for a in args.shapes])
    rows = []
    for nx, nu in shapes:
        for L, dname in chip_smoke.K1_TIMED:
            dtype = getattr(torch, dname)
            rtol, atol = (2e-4, 2e-5) if dname == "float32" else (0.0, 1e-10)
            d = chip_smoke._random_lqr(N, nx, nu, L, seed=1, dtype=dtype)
            runs = {n: chip_smoke.riccati_launcher(lib, d)
                    for n, lib in libs.items()}
            for call, _ in runs.values():
                call()
            torch.cuda.synchronize()
            want = runs["repo"][1]
            err = {n: chip_smoke._max_err(out, want) for n, (_, out) in
                   runs.items()}
            for n, (_, out) in runs.items():
                if not n.startswith("probe_"):
                    chip_smoke._check_close(f"{n} ({nx},{nu}) L={L} {dname}",
                                            out, want, rtol, atol)
            ms = {n: [] for n in libs}
            for n in order:
                ms[n].append(chip_smoke.launch_ms(runs[n][0]))
            item = d.A.element_size()
            bound_ms, by = chip_smoke.bound(
                *chip_smoke.riccati_work(N, nx, nu, L, item), item)
            rows.append(dict(nx=nx, nu=nu, N=N, L=L, dtype=dname, ms=ms,
                             max_abs_err_vs_repo=err, bound_ms=bound_ms,
                             bound_by=by, card=card))
            print(f"K1 ({nx}, {nu}) L={L} {dname}: " + ", ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in ms[n])} ms"
                for n in libs) + f"; bound {bound_ms:.4f} ms ({by})")
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"shapes": rows, "sass": census}, indent=1))
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
