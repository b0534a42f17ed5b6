"""K1's CUDA source run on the CPU, against the plain sweep.

`csrc/riccati_lanes.cu` and `csrc/riccati_team.cuh` are compiled with g++
after a textual rewrite of what only nvcc knows (the cp.async PTX, the
dynamic shared memory declaration, the `<<<...>>>` launch), against a
stand-in header: every CUDA thread is a std::thread, a block's
__syncthreads() and __syncwarp() are one std::barrier (the kernel's control
flow is uniform, so every thread of a block meets the same syncs), a warp
shuffle goes through the barrier, and cp.async is a synchronous copy (its
groups complete early, which the kernel's waits allow).  This checks the
kernel's indexing where no card exists: the tile ring, the warp's rows and
column parts, the transposed tiles, the 16-byte and element copies, the
ragged last block and a NaN lane.  Timing and the card's compiler are the
business of tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    LaneLQR, lqr_solve_lanes_plain)
from tests.test_torch_riccati import random_lqr

STAND_IN = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
#define __restrict__
struct Dim { unsigned x = 0; };
inline thread_local Dim threadIdx, blockIdx, blockDim;
struct Block { std::barrier<>* bar; std::vector<double> lanes;
               unsigned char* smem; };
inline thread_local Block* block = nullptr;
inline void __syncthreads() { block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
template <typename T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int me = threadIdx.x;
  block->lanes[me] = static_cast<double>(v);
  __syncthreads();
  const T got = static_cast<T>(block->lanes[me / width * width + src]);
  __syncthreads();
  return got;
}
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
inline void stand_in_copy(void* dst, const void* src, int bytes, bool valid) {
  if (valid) std::memcpy(dst, src, bytes); else std::memset(dst, 0, bytes);
}
template <typename K, typename... Args>
void stand_in_launch(K kernel, int grid, int threads, size_t smem,
                     cudaStream_t, Args... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(threads);
    // uninitialised shared memory: a fixed garbage pattern
    std::vector<unsigned char> mem(smem + 16, 0xCD);
    unsigned char* base = mem.data() + (16 - reinterpret_cast<uintptr_t>(
        mem.data()) % 16) % 16;
    Block blk{&bar, std::vector<double>(threads), base};
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = threads; block = &blk;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
"""


def _rewrite(src):
    """The nvcc-only parts of K1's sources in the stand-in's terms."""
    src = src.replace("#include <cuda_runtime.h>", '#include "stand_in.h"')
    src = re.sub(r'asm volatile\("cp\.async\.ca[^;]*;\\n"[^;]*;',
                 "stand_in_copy(dst, src, BYTES, valid);", src)
    src = re.sub(r'asm volatile\("cp\.async\.(commit|wait)_group[^;]*;\\n"'
                 r'[^;]*;', "", src)
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = block->smem;")
    src = re.sub(r"kernel<<<(.*?)>>>\(", r"stand_in_launch(kernel, \1, ", src,
                 flags=re.S)
    assert "asm" not in src and "<<<" not in src
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K1's C entry, built from the checkout's sources for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: K1's CUDA source cannot be emulated")
    out = tmp_path_factory.mktemp("k1_emulated")
    (out / "stand_in.h").write_text(STAND_IN)
    for src, dst in (("riccati_lanes.cu", "riccati_lanes.cpp"),
                     ("riccati_team.cuh", "riccati_team.cuh")):
        (out / dst).write_text(_rewrite((_build.CSRC / src).read_text()))
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(out), "-o", str(out / "k1.so"),
         str(out / "riccati_lanes.cpp")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "k1.so"))
    lib.nmpc_riccati_lanes.argtypes = _build._ENTRIES["nmpc_riccati_lanes"]
    lib.nmpc_riccati_lanes.restype = ctypes.c_int
    return lib


def _run(lib, d):
    N, nx, _, L = d.A.shape
    nu = d.B.shape[2]
    opts = dict(dtype=d.A.dtype)
    dx, du = torch.empty(N + 1, nx, L, **opts), torch.empty(N, nu, L, **opts)
    K, k = torch.empty(N, nu, nx, L, **opts), torch.empty(N, nu, L, **opts)
    code = lib.nmpc_riccati_lanes(
        int(d.A.dtype == torch.float64), nx, nu, N, L,
        *(ctypes.c_void_p(t.data_ptr()) for t in (*d, dx, du, K, k)), None)
    assert code == 0
    return dx, du


def _lqr(nx, nu, L, dtype, seed):
    return LaneLQR(*(torch.tensor(a, dtype=dtype)
                     for a in random_lqr(N=7, nx=nx, nu=nu, L=L, seed=seed)))


@pytest.mark.parametrize("L", [1, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2)])
def test_emulated_kernel_matches_plain(emulated, nx, nu, dtype, L):
    """L=1 and 6: ragged last blocks (element copies in float32, 16-byte
    copies in float64 at L=6); L=8: whole blocks, 16-byte copies."""
    d = _lqr(nx, nu, L, dtype, seed=nx + L)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (0.0, 1e-10)
    for g, w in zip(_run(emulated, d), lqr_solve_lanes_plain(d)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2)])
def test_emulated_kernel_nan_lane_leaves_the_others_bitwise(emulated, nx,
                                                            nu):
    L, lane = 9, 5
    d = _lqr(nx, nu, L, torch.float32, seed=3)
    ref = _run(emulated, d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = _run(emulated, d._replace(A=A))
    keep = np.arange(L) != lane
    for g, r in zip(got, ref):
        assert torch.equal(g[..., keep], r[..., keep])
    assert not torch.isfinite(got[0][..., lane]).all()
