// Lane-batched Riccati LQR sweep (K1) for sm_90a: the kernels and their
// launch, instantiated per (nx, nu) in riccati_lanes_<nx>x<nu>_<type>.cu,
// one translation unit each, so that nvcc compiles the instances in
// parallel; the C entry is riccati_lanes.cu.
//
// Replaces mpc_collisionavoidance_tpu/kernels/riccati_pallas.py:
// lqr_solve_lanes_pallas (body `_kernel`).  Same math, per lane (see
// riccati_team.cuh): backward from P = Q_N, p = qx_N over the stages
// N-1 .. 0, then the forward rollout from dx0.  The symmetrization
// 0.5 (P + P') and the Cholesky are the reference's, so float64 results
// agree with the plain sweep to round-off.
//
// Layout: every tensor is (stage, rows, cols, L) with the lane axis L
// minor-most; the G lanes of one block are G neighbouring addresses of
// every entry.
//
// Design: two kernels, and `launch` picks one from what it sees.
//
// The warp design (riccati_lanes_kernel below): one warp per lane
// (riccati_team.cuh) and kLanes = 4 lanes per block: 128 threads, 128
// blocks at L = 512.  The warp splits each stage's matrix work by rows and
// column parts (halves at nx = 14, quarters at nx = 8), so a thread runs
// ~2 nx / SPLIT dot products of length nx per stage instead of the lane's
// ~2 nx^2.  P's row stays in the thread's registers; PA, the new P, PB,
// P c + p and K sit in shared memory, so nothing spills.  Each stage's
// blocks (A, B, c, Q, S, R, qx, qu) are copied for the block's lanes into a
// ring of kRing tiles in shared memory with cp.async, kRing - 1 stages
// ahead of the math; one __syncthreads() per stage hands a tile over.
// The copies are 16 bytes when L and every pointer allow it (a row of 4
// float lanes, or two rows of 2 double lanes), else one element each;
// both give the same tile.  The forward rollout reuses the ring's bytes
// for smaller tiles (A, B transposed, c, K, k) and runs further ahead: its
// math per stage is short, so the copies' latency would otherwise set its
// pace.  K and k go to a global scratch the wrapper allocates (L2-resident
// between the two passes).  Lanes past L (the ragged last block) copy
// zeros, compute on them and store nothing: no edge padding, and a lane's
// result does not depend on its neighbours or on its place in the block.
//
// The CTA design (riccati_lanes_kernel_cta, riccati_cta.cuh; nu <= 2): one
// CTA per lane, one entry of a stage's products per thread, three block
// barriers per backward stage; the forward rollout on one warp.
//
// The rule: the CTA design for nu <= 2 up to one CTA per SM, L <= the SM
// count (where cudaOccupancyMaxActiveBlocksPerMultiprocessor finds room for
// one), else the warp design; the wide instances (nu > 2) always take the
// warp design.  Timed on the H100 (chip_smoke.py phase 2), the CTA design
// wins at L = 1 and 128 for every nu <= 2 instance (1.7-2.5x), and at
// L = 512 for all but (14, 2), whose 512 CTAs of 256 threads fit in one
// wave (4 an SM) but share each SM's issue slots and shared-memory port:
// 0.49 against the warp design's 0.39 ms in float32.  A rule by the
// resident wave alone would slow the hull's fleet, so the CTA design stops
// at one CTA per SM, where it wins for every instance.
//
// What bounds it on the H100: per lane and stage the sweep reads 2 nx^2 +
// 2 nx nu + 2 nx + nu^2 + nu inputs once (482 values at (14, 2)) and does
// ~4 nx^3 FLOP, so at L = 512 the bytes set the bound (30.6 us for the
// hull in float32, 10.5 us for the flagship), and at L = 1 they set it at
// well under a microsecond.  Neither design reaches it: each lane walks
// its 100 dependent stages.  In the warp design one stage's chain (shared-
// memory loads feeding the two products, the Cholesky's square roots and
// reciprocals, three warp syncs, one block barrier) sets the time at every
// L up to a few hundred blocks, with one live warp on one SM at L = 1.  The
// CTA design shortens a stage to three dot products of length nx in
// sequence plus the Cholesky, at the price of three block barriers and a
// CTA per lane, so it serves up to one CTA per SM.  Plain FP32/FP64
// FMAs: the products are 8-14 wide and differ per lane, and the float32 IPM
// needs full float32.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "riccati_cta.cuh"
#include "riccati_team.cuh"

namespace nmpc {
namespace k1 {

constexpr int kLanes = 4;  // lanes per block, a warp each
constexpr int kWarp = 32;
constexpr int kRing = 3;   // backward tiles in the ring

// Copy the ROWS x COLS entries of one stage of a lane-minor tensor (`src`
// at the stage's entry 0, lane 0) for the block's lanes l0 .. l0+kLanes-1
// into a [entry][kLanes] tile, transposed if TR.  `vec`: 16-byte copies
// (L a multiple of 16 / sizeof(T), every pointer 16-byte aligned).
template <typename T, int ROWS, int COLS, bool TR>
__device__ __forceinline__ void stage_field(T* dst, const T* src, int L,
                                            int l0, bool vec) {
  constexpr int E = ROWS * COLS;
  constexpr int V = 16 / sizeof(T);
  static_assert(kLanes % V == 0, "a 16-byte copy must not straddle blocks");
  auto slot = [](int e) { return TR ? (e % COLS) * ROWS + e / COLS : e; };
  if (vec) {
    constexpr int U = kLanes / V;  // 16-byte units per entry
    for (int w = threadIdx.x; w < E * U; w += blockDim.x) {
      const int e = w / U, g = (w % U) * V, l = l0 + g;
      cp_async<16>(dst + slot(e) * kLanes + g,
                   src + static_cast<size_t>(e) * L + (l < L ? l : 0),
                   l < L);
    }
  } else {
    for (int w = threadIdx.x; w < E * kLanes; w += blockDim.x) {
      const int e = w / kLanes, g = w % kLanes, l = l0 + g;
      cp_async<sizeof(T)>(dst + slot(e) * kLanes + g,
                          src + static_cast<size_t>(e) * L + (l < L ? l : 0),
                          l < L);
    }
  }
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void stage_back(
    T* buf, int s, const T* A, const T* B, const T* c, const T* Q,
    const T* S, const T* R, const T* qx, const T* qu, int L, int l0,
    bool vec) {
  using BT = BackTile<NX, NU>;
  const size_t Ls = L;
  stage_field<T, NX, NX, false>(buf + BT::A * kLanes, A + s * NX * NX * Ls,
                                L, l0, vec);
  stage_field<T, NX, NU, false>(buf + BT::B * kLanes, B + s * NX * NU * Ls,
                                L, l0, vec);
  stage_field<T, NX, 1, false>(buf + BT::c * kLanes, c + s * NX * Ls, L, l0,
                               vec);
  stage_field<T, NX, NX, true>(buf + BT::Qt * kLanes, Q + s * NX * NX * Ls,
                               L, l0, vec);
  stage_field<T, NU, NX, false>(buf + BT::S * kLanes, S + s * NU * NX * Ls,
                                L, l0, vec);
  stage_field<T, NU, NU, false>(buf + BT::R * kLanes, R + s * NU * NU * Ls,
                                L, l0, vec);
  stage_field<T, NX, 1, false>(buf + BT::qx * kLanes, qx + s * NX * Ls, L,
                               l0, vec);
  stage_field<T, NU, 1, false>(buf + BT::qu * kLanes, qu + s * NU * Ls, L,
                               l0, vec);
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void stage_fwd(T* buf, int s, const T* A,
                                          const T* B, const T* c, const T* K,
                                          const T* k, int L, int l0,
                                          bool vec) {
  using FT = FwdTile<NX, NU>;
  const size_t Ls = L;
  stage_field<T, NX, NX, true>(buf + FT::At * kLanes, A + s * NX * NX * Ls,
                               L, l0, vec);
  stage_field<T, NX, NU, true>(buf + FT::Bt * kLanes, B + s * NX * NU * Ls,
                               L, l0, vec);
  stage_field<T, NX, 1, false>(buf + FT::c * kLanes, c + s * NX * Ls, L, l0,
                               vec);
  stage_field<T, NU, NX, false>(buf + FT::K * kLanes, K + s * NU * NX * Ls,
                                L, l0, vec);
  stage_field<T, NU, 1, false>(buf + FT::k * kLanes, k + s * NU * Ls, L, l0,
                               vec);
}

// shared memory of one block: the ring, then the teams' scratch
template <typename T, int NX, int NU>
constexpr size_t shared_bytes() {
  return sizeof(T) * kLanes *
         (kRing * BackTile<NX, NU>::size + TeamScratch<NX, NU>::size);
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLanes * kWarp)
riccati_lanes_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ c, const T* __restrict__ Q,
                     const T* __restrict__ S, const T* __restrict__ R,
                     const T* __restrict__ qx, const T* __restrict__ qu,
                     const T* __restrict__ dx0, T* __restrict__ dx,
                     T* __restrict__ du, T* Ks, T* ks, int N, int L,
                     bool vec) {
  using BT = BackTile<NX, NU>;
  using FT = FwdTile<NX, NU>;
  using TM = Team<NX>;
  constexpr int BTILE = BT::size * kLanes, FTILE = FT::size * kLanes;
  // forward tiles in the ring's bytes
  constexpr int FRING = kRing * BT::size / FT::size;
  static_assert(kRing >= 2 && FRING >= 2, "the rings need two tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int g = threadIdx.x / kWarp, t = threadIdx.x % kWarp;
  const int r = t % TM::ROWS, part = t / TM::ROWS;
  const int l0 = blockIdx.x * kLanes, l = l0 + g;
  // t < NX: row t in part 0, which stores column t of K and owns entry t
  // of dx in the forward rollout
  const bool live = l < L, row = t < NX;
  T* scr = ring + kRing * BTILE + g;
  const size_t Ls = L;
  // entry (i, j) of stage s of an (., m, n, L) tensor, this lane
  auto idx = [=](int s, int i, int j, int m, int n) -> size_t {
    return ((static_cast<size_t>(s) * m + i) * n + j) * Ls + l;
  };

  // row r of P in every part, entry r of p in the last part
  T Pi[NX], pi = T(0);
#pragma unroll
  for (int j = 0; j < NX; ++j)
    Pi[j] = (live && r < NX) ? Q[idx(N, r, j, NX, NX)] : T(0);
  if (live && r < NX && part == TM::SPLIT - 1) pi = qx[idx(N, r, 0, NX, 1)];

  // backward: step n works on stage N-1-n in ring slot n % kRing
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) {
    if (n < N)
      stage_back<T, NX, NU>(ring + n * BTILE, N - 1 - n, A, B, c, Q, S, R,
                            qx, qu, L, l0, vec);
    cp_async_commit();
  }
  for (int n = 0; n < N; ++n) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // tile n landed; every warp is done with tile n-1
    const int ahead = n + kRing - 1;
    if (ahead < N)
      stage_back<T, NX, NU>(ring + (ahead % kRing) * BTILE, N - 1 - ahead, A,
                            B, c, Q, S, R, qx, qu, L, l0, vec);
    cp_async_commit();
    const int s = N - 1 - n;
    T Kt[NU], kff[NU];
    backward_stage<T, NX, NU, kLanes>(t, ring + (n % kRing) * BTILE + g,
                                            scr, Pi, pi, Kt, kff);
    if (live) {
      if (row) {
#pragma unroll
        for (int u = 0; u < NU; ++u) Ks[idx(s, u, t, NU, NX)] = Kt[u];
      }
      if (t == 0) {
#pragma unroll
        for (int u = 0; u < NU; ++u) ks[idx(s, u, 0, NU, 1)] = kff[u];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // K and k of every stage written; the ring is free

  // forward: stage n in ring slot n % FRING
  T x = (live && row) ? dx0[idx(0, t, 0, 1, 1)] : T(0);
#pragma unroll
  for (int n = 0; n < FRING - 1; ++n) {
    if (n < N)
      stage_fwd<T, NX, NU>(ring + n * FTILE, n, A, B, c, Ks, ks, L, l0, vec);
    cp_async_commit();
  }
  for (int n = 0; n < N; ++n) {
    cp_async_wait<FRING - 2>();
    __syncthreads();
    const int ahead = n + FRING - 1;
    if (ahead < N)
      stage_fwd<T, NX, NU>(ring + (ahead % FRING) * FTILE, ahead, A, B, c,
                           Ks, ks, L, l0, vec);
    cp_async_commit();
    if (live && row) dx[idx(n, t, 0, NX, 1)] = x;
    T u[NU];
    x = forward_stage<T, NX, NU, kLanes>(
        t, ring + (n % FRING) * FTILE + g, x, u);
    if (live && t == 0) {
#pragma unroll
      for (int v = 0; v < NU; ++v) du[idx(n, v, 0, NU, 1)] = u[v];
    }
  }
  if (live && row) dx[idx(N, t, 0, NX, 1)] = x;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The designs `launch` takes: the rule's, the warp's or the CTA's.
enum Design { kRule = -1, kWarpDesign = 0, kCtaDesign = 1 };

// The most lanes the CTA design takes on the current device: one CTA per
// SM (the SM count where an SM holds one of its CTAs), 0 for a wide
// instance.  Returns 0 or a CUDA error.  Computed once per device.
template <typename T, int NX, int NU>
int cta_lanes(int* lanes) {
  *lanes = 0;
  if constexpr (NU <= 2) {
    constexpr int kDevices = 64;
    static std::atomic<int> known[kDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices && (*lanes = known[dev].load()) > 0) return 0;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, riccati_lanes_kernel_cta<T, NX, NU>,
          cta::Shape<T, NX, NU>::THREADS, cta::shared_bytes<T, NX, NU>());
    if (err != cudaSuccess) return static_cast<int>(err);
    *lanes = per_sm > 0 ? sms : 0;
    if (dev < kDevices) known[dev].store(*lanes);
  }
  return 0;
}

// Launches the instance on `stream` in `design` (a Design); returns
// cudaGetLastError(), the error of raising the kernel's shared-memory limit
// or of the rule's occupancy query, or -3 for a design the instance lacks.
template <typename T, int NX, int NU>
int launch(int design, const void* A, const void* B, const void* c,
           const void* Q, const void* S, const void* R, const void* qx,
           const void* qu, const void* dx0, void* dx, void* du, void* K,
           void* k, int N, int L, cudaStream_t stream) {
  if (design == kRule) {
    int lanes = 0;
    const int err = cta_lanes<T, NX, NU>(&lanes);
    if (err != 0) return err;
    design = L <= lanes ? kCtaDesign : kWarpDesign;
  }
  if (design == kCtaDesign) {
    if constexpr (NU <= 2) {
      constexpr size_t smem = cta::shared_bytes<T, NX, NU>();
      static_assert(smem <= 48 * 1024, "launched without opting in");
      const auto kernel = riccati_lanes_kernel_cta<T, NX, NU>;
      kernel<<<L, cta::Shape<T, NX, NU>::THREADS, smem, stream>>>(
          static_cast<const T*>(A), static_cast<const T*>(B),
          static_cast<const T*>(c), static_cast<const T*>(Q),
          static_cast<const T*>(S), static_cast<const T*>(R),
          static_cast<const T*>(qx), static_cast<const T*>(qu),
          static_cast<const T*>(dx0), static_cast<T*>(dx),
          static_cast<T*>(du), static_cast<T*>(K), static_cast<T*>(k), N,
          L);
      return static_cast<int>(cudaGetLastError());
    }
    return -3;
  }
  if (design != kWarpDesign) return -3;
  constexpr size_t smem = shared_bytes<T, NX, NU>();
  const auto kernel = riccati_lanes_kernel<T, NX, NU>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = L % (16 / sizeof(T)) == 0 && aligned16(A) &&
                   aligned16(B) && aligned16(c) && aligned16(Q) &&
                   aligned16(S) && aligned16(R) && aligned16(qx) &&
                   aligned16(qu) && aligned16(K) && aligned16(k);
  const int grid = (L + kLanes - 1) / kLanes;
  kernel<<<grid, kLanes * kWarp, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(c), static_cast<const T*>(Q),
      static_cast<const T*>(S), static_cast<const T*>(R),
      static_cast<const T*>(qx), static_cast<const T*>(qu),
      static_cast<const T*>(dx0), static_cast<T*>(dx), static_cast<T*>(du),
      static_cast<T*>(K), static_cast<T*>(k), N, L, vec);
  return static_cast<int>(cudaGetLastError());
}

// the instances (nx, nu), each in float and double: (8, 1) usv_guidance_ca1;
// (14, 2) usv_pf_ca and usv_pf; (8, 2) usv_low_level and
// usv_position_control; (5, 2) usv_acados; (9, 1) usv_guidance_ca;
// (10, 1) usv_guidance; (12, 1) usv_guidance2; (11, 1) usv_guidance3;
// (4, 1) usv_guidance4; (5, 1) usv_guidance5; (6, 2) race_cars and
// race_cars_dev (the 8-row team of (8, 2) with two rows idle); and the
// macro stages of partially condensed QPs (ops/condense_partial.py, nu' =
// M nu, Huu in the team's scratch): (8, 4), (8, 5), (8, 10) the flagship
// at M = 4, 5, 10 (its M = 2 is (8, 2)); (14, 4), (14, 8) usv_pf_ca at
// M = 2, 4; (6, 4) race_cars_dev at M = 2.  Declared here, defined in
// riccati_lanes_<nx>x<nu>_<type>.cu.
#define NMPC_K1_SHAPES(X) \
  X(8, 1) X(14, 2) X(8, 2) X(5, 2) X(9, 1) X(10, 1) X(12, 1) X(11, 1) \
  X(4, 1) X(5, 1) X(6, 2) X(8, 4) X(8, 5) X(8, 10) X(14, 4) X(14, 8)  \
  X(6, 4)
#define NMPC_K1_LAUNCH(T, NX, NU)                                          \
  int launch<T, NX, NU>(int, const void*, const void*, const void*,        \
                        const void*, const void*, const void*, const void*, \
                        const void*, const void*, void*, void*, void*,     \
                        void*, int, int, cudaStream_t)
#define NMPC_K1_LANES(T, NX, NU) int cta_lanes<T, NX, NU>(int*)
// what an instance file instantiates
#define NMPC_K1_INSTANCE(T, NX, NU)    \
  template NMPC_K1_LAUNCH(T, NX, NU); \
  template NMPC_K1_LANES(T, NX, NU);
#define NMPC_K1_DECLARE(NX, NU)                   \
  extern template NMPC_K1_LAUNCH(float, NX, NU); \
  extern template NMPC_K1_LAUNCH(double, NX, NU); \
  extern template NMPC_K1_LANES(float, NX, NU);  \
  extern template NMPC_K1_LANES(double, NX, NU);
NMPC_K1_SHAPES(NMPC_K1_DECLARE)
#undef NMPC_K1_DECLARE

}  // namespace k1
}  // namespace nmpc
