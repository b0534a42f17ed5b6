"""Run the port's CUDA sources on the CPU, for the emulated kernel tests.

A kernel's `csrc/` sources are compiled with g++ after a textual rewrite of
what only nvcc knows (the cp.async PTX, the dynamic shared memory
declaration, the `<<<...>>>` launch), against a stand-in header: every CUDA
thread is a std::thread, a block's __syncthreads() and __syncwarp() are one
std::barrier (the kernels' control flow is uniform, so every thread of a
block meets the same syncs), a warp shuffle goes through the barrier, and
cp.async is a synchronous copy (its groups complete early, which the
kernels' waits allow).  Blocks run one after another.  This checks a
kernel's indexing where no card exists; timing and the card's compiler are
the business of tests/test_torch_cuda.py and chip_smoke.py.
"""

import concurrent.futures
import ctypes
import re
import shutil
import subprocess

import pytest

from mpc_collisionavoidance_tpu_torch.kernels import _build

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
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
using std::isfinite;
struct Dim { unsigned x = 0; };
inline thread_local Dim threadIdx, blockIdx, blockDim;
struct Block { std::barrier<>* bar; std::vector<double> lanes;
               unsigned char* smem; };
inline thread_local Block* block = nullptr;
inline void __syncthreads() { block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
// every thread of the block posts its value, then reads thread `src`'s
template <typename T> T stand_in_exchange(T v, int src) {
  block->lanes[threadIdx.x] = static_cast<double>(v);
  __syncthreads();
  const T got = static_cast<T>(block->lanes[src]);
  __syncthreads();
  return got;
}
template <typename T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return stand_in_exchange(v, threadIdx.x / width * width + src);
}
template <typename T> T __shfl_xor_sync(unsigned, T v, int mask,
                                        int width = 32) {
  return stand_in_exchange(v, threadIdx.x ^ mask);
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


def rewrite(src):
    """The nvcc-only parts of a kernel source in the stand-in's terms."""
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


def _compile(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def build(out, headers, units, entries):
    """Rewrite `headers` and the translation units `units` (file names in
    csrc/) into the directory `out`, compile each unit with its own g++
    (in parallel) and link them into one library; returns it as a CDLL
    with the argument types of `entries` (names in `_build._ENTRIES`).
    Skips the calling test if g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the CUDA sources cannot be emulated")
    (out / "stand_in.h").write_text(STAND_IN)
    for name in headers:
        (out / name).parent.mkdir(parents=True, exist_ok=True)
        (out / name).write_text(rewrite((_build.CSRC / name).read_text()))
    objs = []
    cmds = []
    for name in units:
        cpp = out / (name[:-3] + ".cpp")
        cpp.write_text(rewrite((_build.CSRC / name).read_text()))
        objs.append(out / (name[:-3] + ".o"))
        cmds.append([gxx, "-std=c++20", "-O1", "-fPIC", "-pthread",
                     "-pedantic-errors", "-Wno-unknown-pragmas", "-I",
                     str(out), "-c", "-o",
                     str(objs[-1]), str(cpp)])
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        for proc in pool.map(_compile, cmds):
            assert proc.returncode == 0, proc.stderr[-4000:]
    lib = out / "emulated.so"
    proc = _compile([gxx, "-shared", "-pthread", "-o", str(lib),
                     *map(str, objs)])
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    for name in entries:
        fn = getattr(dll, name)
        fn.argtypes = _build._ENTRIES[name]
        fn.restype = _build._RESTYPES.get(name, ctypes.c_int)
    return dll
