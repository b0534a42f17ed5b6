// Fused RTI linearization (K2) for sm_90a: the kernel, its launch and the
// macro of its C entries.  Each model form (csrc/models/<name>.cuh) has its
// own translation unit linearize_lanes_<name>.cu, so that nvcc compiles
// the forms in parallel.
//
// Replaces mpc_collisionavoidance_tpu/kernels/linearize_pallas.py:
// linearize_lanes_pallas.  Per (stage, lane) it computes
//   xn = F(x, u; p)         the RK4 map over `integrator_steps` substeps,
//   J  = dF/d(x, u)         tangents only along f_dep; every other state
//                           column is written as the exact identity column,
//                           every other control column as exact zeros,
//   hbar = h(x, p), C = dh/dx  tangents only along h_dep, zeros elsewhere.
// The model's f and h (csrc/models/<name>.cuh) run once on a forward-mode
// dual number with |f_dep| tangents (the rollout's value part is xn) and
// once on one with |h_dep| tangents (its value part is hbar).
//
// Layouts (lane axis L minor-most):
//   in   xs (nx, N, L), ubar (nu, N, L), params (np, L)
//   out  xn (nx, N, L), J (N, nx, nx+nu, L), hbar (nh, N, L),
//        C (N, nh, nx, L)
// J and C are written straight into the IPM's layout, so the solver needs
// no transpose.
//
// Design: one thread per (stage, lane), threads ordered lane-fastest, so a
// warp reads and writes 32 neighbouring addresses of every plane.  No stage
// blocking and no padding: the last block is bounds-masked.
// What bounds it on the H100: per thread ~2 kFLOP (four model evaluations
// on 7-wide duals plus the row distances) against ~0.4 kB of traffic, so
// it is neither HBM- nor FLOP-bound at the flagship's N*L = 51,200 threads
// (400 blocks of 128 on 132 SMs); the cost is the sin/cos/atan2 latency
// and the register footprint of the duals (x, k, acc and the stage state:
// ~4 x 8 x 7 values per thread), which limits occupancy and may spill in
// float64.  The 14-state hulls (usv_pf_ca, usv_pf: 9 f tangents) carry
// ~4 x 14 x 10 dual values per thread, above the 255-register cap in both
// precisions, so they spill to local memory; so do the double forms of
// the other hull models and of the guidance models with 9-12 states
// (usv_guidance_ca, usv_guidance, usv_guidance2, usv_guidance3), whose
// float forms fit in 224-254 registers.  Accepted for bring-up.
//
// A form whose f reads a curvature table (the curved race track,
// models/track.cuh) says so with kTrack = true; its C entry takes the
// table, its length M and the lap's arc length, and the kernel hands them
// to f.  Every other form's entry passes none, and its f is called
// without.  The table's gathers are four loads per f evaluation from an
// L1-resident array of M values, and come on top of a form's FLOPs.
//
// A model with no parameters (NP = 0) reads none: the kernel hands its
// form a size-1 dummy array, and the params pointer (of an empty tensor,
// possibly null) is never read.  A model with no constraint rows (NH = 0)
// skips the constraint pass at compile time, so hbar and C (empty) are
// never written.  No array has size 0.
//
// The C entries, one per model form: the flagship usv_guidance_ca1, the
// hull family usv_pf_ca, usv_pf, usv_low_level, usv_acados and
// usv_position_control (on models/hydro.cuh), and the kinematic guidance
// family usv_guidance_ca, usv_guidance and usv_guidance2..5 (on
// models/guidance.cuh, with the flagship), and the race car's two forms,
// race_cars on the straight track and race_cars_track on a curved one
// (models/race_cars.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "dual.cuh"
#include "models/track.cuh"

namespace {

constexpr int kBlock = 128;

// position of coordinate k in the model's f_dep (-1: not read by f)
template <typename M>
__device__ __forceinline__ constexpr int f_pos(int k) {
  int pos = -1;
  for (int j = 0; j < M::N_FDEP; ++j)
    if (M::f_dep(j) == k) pos = j;
  return pos;
}
template <typename M>
__device__ __forceinline__ constexpr int h_pos(int k) {
  int pos = -1;
  for (int j = 0; j < M::N_HDEP; ++j)
    if (M::h_dep(j) == k) pos = j;
  return pos;
}

// whether form M's f reads a curvature table (M::kTrack, false if absent)
template <typename M, typename = void>
struct reads_track : std::false_type {};
template <typename M>
struct reads_track<M, std::void_t<decltype(M::kTrack)>>
    : std::bool_constant<M::kTrack> {};

// f of form M, with the table if it reads one
template <typename M, typename S, typename T, int NPA>
__device__ __forceinline__ void eval_f(const S (&x)[M::NX],
                                       const S (&u)[M::NU],
                                       const T (&p)[NPA],
                                       const nmpc::Curvature<T>& tab,
                                       S (&xdot)[M::NX]) {
  if constexpr (reads_track<M>::value)
    M::f(x, u, p, tab, xdot);
  else
    M::f(x, u, p, xdot);
}

template <typename T, typename M>
__global__ void __launch_bounds__(kBlock)
linearize_lanes_kernel(const T* __restrict__ xs, const T* __restrict__ ub,
                       const T* __restrict__ prm, T* __restrict__ xn,
                       T* __restrict__ J, T* __restrict__ hbar,
                       T* __restrict__ C, const T* __restrict__ kap,
                       int M_tab, T track_length, int N, int L, T half_h,
                       T h, T sixth_h, int steps) {
  constexpr int NX = M::NX, NU = M::NU, NXU = M::NX + M::NU;
  const size_t gid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (gid >= static_cast<size_t>(N) * L) return;
  const int s = static_cast<int>(gid / L);
  const int l = static_cast<int>(gid % L);
  // entry of row i at stage s of an (rows, N, L) plane
  auto plane = [=](int i) -> size_t {
    return (static_cast<size_t>(i) * N + s) * L + l;
  };

  // the parameters; a size-1 dummy (never read) for a form with none
  T p[M::NP > 0 ? M::NP : 1] = {};
#pragma unroll
  for (int i = 0; i < M::NP; ++i) p[i] = prm[static_cast<size_t>(i) * L + l];

  const nmpc::Curvature<T> tab{kap, M_tab, track_length};

  // ---- RK4 rollout with |f_dep| forward tangents ----
  using DF = nmpc::Dual<T, M::N_FDEP>;
  DF x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = DF(xs[plane(i)]);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = DF(ub[plane(i)]);
#pragma unroll
  for (int j = 0; j < M::N_FDEP; ++j) {
    const int k = M::f_dep(j);
    if (k < NX)
      x[k].d[j] = T(1);
    else
      u[k - NX].d[j] = T(1);
  }
  for (int step = 0; step < steps; ++step) {
    // acc = k1 + 2 k2 + 2 k3 + k4, summed left to right as the reference
    DF k[NX], acc[NX], tmp[NX];
    eval_f<M>(x, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      tmp[i] = x[i] + half_h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      tmp[i] = x[i] + half_h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      tmp[i] = x[i] + h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + sixth_h * (acc[i] + k[i]);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xn[plane(i)] = x[i].v;
#pragma unroll
    for (int c = 0; c < NXU; ++c) {
      const int pos = f_pos<M>(c);
      const T val = pos >= 0 ? x[i].d[pos >= 0 ? pos : 0]
                             : (c == i ? T(1) : T(0));
      J[((static_cast<size_t>(s) * NX + i) * NXU + c) * L + l] = val;
    }
  }

  // ---- constraint rows with |h_dep| forward tangents ----
  if constexpr (M::NH > 0) {
    using DH = nmpc::Dual<T, M::N_HDEP>;
    DH xh[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xh[i] = DH(xs[plane(i)]);
#pragma unroll
    for (int j = 0; j < M::N_HDEP; ++j) xh[M::h_dep(j)].d[j] = T(1);
    DH hv[M::NH];
    M::h(xh, p, hv);
#pragma unroll
    for (int r = 0; r < M::NH; ++r) {
      hbar[plane(r)] = hv[r].v;
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const int pos = h_pos<M>(c);
        C[((static_cast<size_t>(s) * M::NH + r) * NX + c) * L + l] =
            pos >= 0 ? hv[r].d[pos >= 0 ? pos : 0] : T(0);
      }
    }
  }
}

template <typename T, typename M>
int launch(int N, int L, double dt_step, int steps, const void* xs,
           const void* ub, const void* prm, void* xn, void* J, void* hbar,
           void* C, const void* kap, int M_tab, double track_length,
           cudaStream_t stream) {
  const size_t threads = static_cast<size_t>(N) * L;
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  // the reference scales by Python floats computed in double, then rounds
  // them to the working type: 0.5*h, h and h/6
  const auto kernel = linearize_lanes_kernel<T, M>;
  kernel<<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(ub),
      static_cast<const T*>(prm), static_cast<T*>(xn), static_cast<T*>(J),
      static_cast<T*>(hbar), static_cast<T*>(C), static_cast<const T*>(kap),
      M_tab, static_cast<T>(track_length), N, L,
      static_cast<T>(0.5 * dt_step), static_cast<T>(dt_step),
      static_cast<T>(dt_step / 6.0), steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename M>
int entry(int is_double, int N, int L, double dt_step, int steps,
          const void* xs, const void* ub, const void* prm, void* xn, void* J,
          void* hbar, void* C, const void* kap, int M_tab,
          double track_length, void* stream) {
  if (N < 1 || L < 1 || steps < 1) return -2;
  if (reads_track<M>::value && (M_tab < 1 || !(track_length > 0.0)))
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double, M>(N, L, dt_step, steps, xs, ub, prm, xn, J, hbar,
                             C, kap, M_tab, track_length, st);
  return launch<float, M>(N, L, dt_step, steps, xs, ub, prm, xn, J, hbar, C,
                          kap, M_tab, track_length, st);
}

}  // namespace

// One C entry per model form, nmpc_linearize_<model>(is_double, N, L,
// dt_step, steps, xs, ubar, params, xn, J, hbar, C, stream), with
// dt_step = dt / integrator_steps.  Each returns cudaGetLastError() after
// the launch (0 = success) or -2 for an empty problem (or an empty
// table).  A form that reads a curvature table has the entry
// nmpc_linearize_<model>(..., hbar, C, table, M, track_length, stream),
// the table a (M,) array of the working type.
#define NMPC_LINEARIZE_ENTRY(NAME, FORM)                                    \
  extern "C" int nmpc_linearize_##NAME(                                     \
      int is_double, int N, int L, double dt_step, int steps,              \
      const void* xs, const void* ub, const void* prm, void* xn, void* J,  \
      void* hbar, void* C, void* stream) {                                  \
    return entry<nmpc::FORM>(is_double, N, L, dt_step, steps, xs, ub, prm, \
                             xn, J, hbar, C, nullptr, 0, 0.0, stream);      \
  }
#define NMPC_LINEARIZE_TRACK_ENTRY(NAME, FORM)                              \
  extern "C" int nmpc_linearize_##NAME(                                     \
      int is_double, int N, int L, double dt_step, int steps,              \
      const void* xs, const void* ub, const void* prm, void* xn, void* J,  \
      void* hbar, void* C, const void* kap, int M_tab,                     \
      double track_length, void* stream) {                                 \
    return entry<nmpc::FORM>(is_double, N, L, dt_step, steps, xs, ub, prm, \
                             xn, J, hbar, C, kap, M_tab, track_length,     \
                             stream);                                       \
  }
