// Fused RTI linearization (K2) for sm_90a: the kernel, its launch and the
// macro of its C entries.  Each model form (csrc/models/<name>.cuh) has its
// own translation unit linearize_lanes_<name>.cu, so that nvcc compiles
// the forms in parallel; the unit also chooses the form's team (below)
// in each type.
//
// Replaces mpc_collisionavoidance_tpu/kernels/linearize_pallas.py:
// linearize_lanes_pallas.  Per (stage, lane) it computes
//   xn = F(x, u; p)         the RK4 map over `integrator_steps` substeps,
//   J  = dF/d(x, u)         tangents only along f_dep; every other state
//                           column is written as the exact identity column,
//                           every other control column as exact zeros,
//   hbar = h(x, p), C = dh/dx  tangents only along h_dep, zeros elsewhere.
// The model's f and h (csrc/models/<name>.cuh) are templates over the
// scalar type and run here on forward-mode duals (dual.cuh).
//
// Layouts (lane axis L minor-most):
//   in   xs (nx, N, L), ubar (nu, N, L), params (np, L)
//   out  xn (nx, N, L), J (N, nx, nx+nu, L), hbar (nh, N, L),
//        C (N, nh, nx, L)
// J and C are written straight into the IPM's layout, so the solver needs
// no transpose.
//
// Design: a team of G threads per (stage, lane).  Thread g of the team
// carries the tangent chunk f_dep[g D, (g + 1) D) on a Dual<T, D> (the
// last chunk padded with zero tangents) through the whole RK4 rollout,
// recomputing the value part, and writes the J columns of its chunk.  D
// is the instance's team width (`Team`), G = ceil(|f_dep| / D).  The team
// splits what is left so that every output value is written exactly
// once: row i of xn and the constant column c of J (identity or zeros)
// go to thread i % G and c % G, the constraint pass (one chunk of the
// |h_dep| = 2-4 tangents: hbar and C's h_dep columns) to thread G - 1,
// C's zero column c to thread c % G.  Threads are numbered lane-fastest,
// l = gid % L, g = (gid / L) % G, s = gid / (L G): at L >= 32 a warp
// reads and writes 32 neighbouring lanes of one plane (coalesced), and at
// L = 1 the warps stay full.  No stage blocking and no padding: threads
// past the last (stage, lane) are masked.
//
// What bounds it on the H100: per (stage, lane) and substep ~1-8 kFLOP of
// dual arithmetic with sin/cos/atan2/sqrt, against 0.4-1.3 kB of outputs
// (J and C in float32); at the builders' N and L = 512 the byte bound
// is 0.6-19 us.
// One thread per (stage, lane) carrying all |f_dep| tangents (the first
// design) held x, k, acc and the stage input as 4 NX (1 + |f_dep|) live
// values (~4 x 14 x 10 for the hull): over the 255-register cap in 13 of
// the 28 instances, which spilled to local memory, and each (stage, lane)
// ran its whole chain on one thread, latency-bound at small L.  The team
// cuts a thread's duals to 1 + D values and multiplies the threads by G;
// the recomputed value parts (transcendentals included) are its price, so
// the widest team is not the fastest where the card is full.  Where x and
// acc do not fit the registers beside f's own values (the double hulls),
// the instance keeps them in shared memory (Team::kShared): a column per
// thread, entry e of the thread at e * kBlock + threadIdx.x, so a warp
// touches 32 consecutive words (no bank conflicts); x is read by each of
// the four stage inputs and acc updated once per stage, both only between
// the f calls.  Each instance's team (D and kShared) is chosen by
// measurement (tools/k2_compare.py's sweep of D in {1, 2, 3, 4, |f_dep|},
// registers or shared memory; PERF.md §6):
// among the widths that compile without spills, float takes the least
// time at L = 512 plus L = 1 (one tick of a batch and one of a single
// boat), double the least at L = 512.  Every instance compiles without
// spills (chip_smoke.py's NO_SPILL gate).  dual.cuh takes sin and cos of
// one angle by one sincos and divides tangents by a reciprocal: the SASS
// of separate sin and cos carried two range reductions (and two of their
// slow paths) per angle.
//
// A form whose f reads a curvature table (the curved race track,
// models/track.cuh) says so with kTrack = true; its C entry takes the
// table, its length M and the lap's arc length.  Each block stages the
// table in shared memory once, behind the kernel's only barrier (which
// every thread of the block reaches: the masking comes after it), and f
// gathers its four samples per evaluation from there.  A table that does
// not fit a block's shared memory beside the instance's RK4 columns is
// refused (-3).  Every other form's entry passes none, and its f is
// called without.
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
constexpr size_t kMaxShared = 232448;  // the per-block opt-in of sm_90

// An instance's team: D tangents per thread, and the RK4 state x and
// accumulator acc in shared memory (kShared) or in registers.  A D above
// |f_dep| means |f_dep| (a team of one).
template <int D_, bool kShared_ = false>
struct Team {
  static constexpr int D = D_;
  static constexpr bool kShared = kShared_;
};
constexpr bool kSharedRk4 = true;

// A probe build (tools/k2_compare.py --sweep) compiles every instance at
// one team given on the command line: -DNMPC_K2_PROBE_D=D and
// -DNMPC_K2_PROBE_SHARED=0|1.
#ifdef NMPC_K2_PROBE_D
template <typename>
using Chosen = Team<NMPC_K2_PROBE_D, NMPC_K2_PROBE_SHARED>;
#else
template <typename TM>
using Chosen = TM;
#endif

// the width D and the size G of form M's team TM
template <typename M, typename TM>
__host__ __device__ constexpr int team_width() {
  return TM::D < M::N_FDEP ? TM::D : M::N_FDEP;
}
template <typename M, typename TM>
__host__ __device__ constexpr int team_size() {
  return (M::N_FDEP + team_width<M, TM>() - 1) / team_width<M, TM>();
}

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

// A thread's RK4 state x and accumulator acc, NX duals each, in registers
// (this template) or in shared memory (the specialisation below)
template <typename DF, int NX, bool kShared>
struct Rk4State {
  DF x_[NX], acc_[NX];
  __device__ __forceinline__ explicit Rk4State(void*) {}
  __device__ __forceinline__ DF x(int i) const { return x_[i]; }
  __device__ __forceinline__ DF acc(int i) const { return acc_[i]; }
  __device__ __forceinline__ void set_x(int i, const DF& v) { x_[i] = v; }
  __device__ __forceinline__ void set_acc(int i, const DF& v) { acc_[i] = v; }
};
// x and acc in the thread's column of the block's shared memory: value c of
// x[i] at ((i * W + c) * kBlock), of acc[i] at (((NX + i) * W + c) *
// kBlock) past the thread's first word, W = 1 + D.  The column is
// volatile: without it the compiler forwards each stored value to its
// next load and keeps it in a register, the very pressure this layout
// exists to remove.
template <typename T, int D, int NX>
struct Rk4State<nmpc::Dual<T, D>, NX, true> {
  using DF = nmpc::Dual<T, D>;
  static constexpr int W = 1 + D;
  volatile T* col;
  __device__ __forceinline__ explicit Rk4State(T* base)
      : col(base + threadIdx.x) {}
  __device__ __forceinline__ DF get(int e) const {
    DF r;
    r.v = col[e * W * kBlock];
#pragma unroll
    for (int c = 0; c < D; ++c) r.d[c] = col[(e * W + 1 + c) * kBlock];
    return r;
  }
  __device__ __forceinline__ void put(int e, const DF& v) {
    col[e * W * kBlock] = v.v;
#pragma unroll
    for (int c = 0; c < D; ++c) col[(e * W + 1 + c) * kBlock] = v.d[c];
  }
  __device__ __forceinline__ DF x(int i) const { return get(i); }
  __device__ __forceinline__ DF acc(int i) const { return get(NX + i); }
  __device__ __forceinline__ void set_x(int i, const DF& v) { put(i, v); }
  __device__ __forceinline__ void set_acc(int i, const DF& v) {
    put(NX + i, v);
  }
};

// shared-memory values per thread of form M's RK4 columns under team TM
template <typename M, typename TM>
__host__ __device__ constexpr size_t rk4_values() {
  return TM::kShared ? 2 * M::NX * (1 + team_width<M, TM>()) : 0;
}

template <typename T, typename M, typename TM>
__global__ void __launch_bounds__(kBlock)
linearize_lanes_kernel(const T* __restrict__ xs, const T* __restrict__ ub,
                       const T* __restrict__ prm, T* __restrict__ xn,
                       T* __restrict__ J, T* __restrict__ hbar,
                       T* __restrict__ C, const T* __restrict__ kap,
                       int M_tab, T track_length, int N, int L, T half_h,
                       T h, T sixth_h, int steps) {
  constexpr int NX = M::NX, NU = M::NU, NXU = M::NX + M::NU;
  constexpr int D = team_width<M, TM>(), G = team_size<M, TM>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);

  // the curvature table, staged once per block by all its threads
  const T* table = kap;
  if constexpr (reads_track<M>::value) {
    T* const tab_sm = sm + rk4_values<M, TM>() * kBlock;
    for (int i = threadIdx.x; i < M_tab; i += kBlock) tab_sm[i] = kap[i];
    __syncthreads();
    table = tab_sm;
  }
  // the kernel's last barrier is behind us: mask the threads past the end
  const size_t gid = static_cast<size_t>(blockIdx.x) * kBlock +
                     threadIdx.x;
  if (gid >= static_cast<size_t>(N) * L * G) return;
  const int l = static_cast<int>(gid % L);
  const int g = static_cast<int>((gid / L) % G);
  const int s = static_cast<int>(gid / (static_cast<size_t>(L) * G));
  // entry of row i at stage s of an (rows, N, L) plane
  auto plane = [=](int i) -> size_t {
    return (static_cast<size_t>(i) * N + s) * L + l;
  };

  // the parameters; a size-1 dummy (never read) for a form with none
  T p[M::NP > 0 ? M::NP : 1] = {};
#pragma unroll
  for (int i = 0; i < M::NP; ++i) p[i] = prm[static_cast<size_t>(i) * L + l];

  const nmpc::Curvature<T> tab{table, M_tab, track_length};

  // ---- RK4 rollout with the tangents f_dep[g D, (g + 1) D) ----
  using DF = nmpc::Dual<T, D>;
  Rk4State<DF, NX, TM::kShared> st(sm);
  DF u[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = DF(ub[plane(i)]);
  {
    DF x0[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x0[i] = DF(xs[plane(i)]);
#pragma unroll
    for (int q = 0; q < M::N_FDEP; ++q) {
      const int k = M::f_dep(q);
      const T seed = q / D == g ? T(1) : T(0);
      if (k < NX)
        x0[k].d[q % D] = seed;
      else
        u[k - NX].d[q % D] = seed;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) st.set_x(i, x0[i]);
  }
  for (int step = 0; step < steps; ++step) {
    // acc = k1 + 2 k2 + 2 k3 + k4, summed left to right as the reference
    DF k[NX], tmp[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = st.x(i);
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      st.set_acc(i, k[i]);
      tmp[i] = st.x(i) + half_h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      st.set_acc(i, st.acc(i) + T(2) * k[i]);
      tmp[i] = st.x(i) + half_h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      st.set_acc(i, st.acc(i) + T(2) * k[i]);
      tmp[i] = st.x(i) + h * k[i];
    }
    eval_f<M>(tmp, u, p, tab, k);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      st.set_x(i, st.x(i) + sixth_h * (st.acc(i) + k[i]));
  }
  // xn's row i to thread i % G; J's column c of f_dep position q to the
  // chunk's thread q / D, a constant column to thread c % G
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const DF xi = st.x(i);
    if (i % G == g) xn[plane(i)] = xi.v;
#pragma unroll
    for (int c = 0; c < NXU; ++c) {
      const int pos = f_pos<M>(c);
      const size_t at = ((static_cast<size_t>(s) * NX + i) * NXU + c) * L + l;
      if (pos >= 0) {
        if (pos / D == g) J[at] = xi.d[pos % D];
      } else if (c % G == g) {
        J[at] = c == i ? T(1) : T(0);
      }
    }
  }

  // ---- constraint rows with the |h_dep| tangents, on thread G - 1 ----
  if constexpr (M::NH > 0) {
    auto c_at = [=](int r, int c) -> size_t {
      return ((static_cast<size_t>(s) * M::NH + r) * NX + c) * L + l;
    };
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      if (h_pos<M>(c) < 0 && c % G == g) {
#pragma unroll
        for (int r = 0; r < M::NH; ++r) C[c_at(r, c)] = T(0);
      }
    }
    if (g == G - 1) {
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
        for (int j = 0; j < M::N_HDEP; ++j)
          C[c_at(r, M::h_dep(j))] = hv[r].d[j];
      }
    }
  }
}

// Launches form M's kernel in type T with team TM; returns
// cudaGetLastError(), the error of raising the kernel's shared-memory
// limit, or -3 if the RK4 columns and the curvature table do not fit a
// block's shared memory.
template <typename T, typename M, typename TM>
int launch(int N, int L, double dt_step, int steps, const void* xs,
           const void* ub, const void* prm, void* xn, void* J, void* hbar,
           void* C, const void* kap, int M_tab, double track_length,
           cudaStream_t stream) {
  const size_t threads =
      static_cast<size_t>(N) * L * team_size<M, TM>();
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  const size_t smem =
      sizeof(T) * (rk4_values<M, TM>() * kBlock +
                   (reads_track<M>::value ? static_cast<size_t>(M_tab) : 0));
  if (smem > kMaxShared) return -3;
  const auto kernel = linearize_lanes_kernel<T, M, TM>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the reference scales by Python floats computed in double, then rounds
  // them to the working type: 0.5*h, h and h/6
  kernel<<<grid, kBlock, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(ub),
      static_cast<const T*>(prm), static_cast<T*>(xn), static_cast<T*>(J),
      static_cast<T*>(hbar), static_cast<T*>(C), static_cast<const T*>(kap),
      M_tab, static_cast<T>(track_length), N, L,
      static_cast<T>(0.5 * dt_step), static_cast<T>(dt_step),
      static_cast<T>(dt_step / 6.0), steps);
  return static_cast<int>(cudaGetLastError());
}

// form M with team TF in float and TD in double
template <typename M, typename TF, typename TD>
int entry(int is_double, int N, int L, double dt_step, int steps,
          const void* xs, const void* ub, const void* prm, void* xn, void* J,
          void* hbar, void* C, const void* kap, int M_tab,
          double track_length, void* stream) {
  if (N < 1 || L < 1 || steps < 1) return -2;
  if (reads_track<M>::value && (M_tab < 1 || !(track_length > 0.0)))
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double, M, Chosen<TD>>(N, L, dt_step, steps, xs, ub, prm,
                                         xn, J, hbar, C, kap, M_tab,
                                         track_length, st);
  return launch<float, M, Chosen<TF>>(N, L, dt_step, steps, xs, ub, prm, xn,
                                      J, hbar, C, kap, M_tab, track_length,
                                      st);
}

}  // namespace

// One C entry per model form, nmpc_linearize_<model>(is_double, N, L,
// dt_step, steps, xs, ubar, params, xn, J, hbar, C, stream), with
// dt_step = dt / integrator_steps and the form's team TF in float, TD in
// double.  Each returns cudaGetLastError() after the launch (0 =
// success), -2 for an empty problem (or an empty table) or -3 for a
// table too large for shared memory.  A form that reads a curvature
// table has the entry nmpc_linearize_<model>(..., hbar, C, table, M,
// track_length, stream), the table a (M,) array of the working type.
#define NMPC_LINEARIZE_ENTRY(NAME, FORM, TF, TD)                            \
  extern "C" int nmpc_linearize_##NAME(                                     \
      int is_double, int N, int L, double dt_step, int steps,              \
      const void* xs, const void* ub, const void* prm, void* xn, void* J,  \
      void* hbar, void* C, void* stream) {                                  \
    return entry<nmpc::FORM, TF, TD>(is_double, N, L, dt_step, steps, xs,  \
                                     ub, prm, xn, J, hbar, C, nullptr, 0,  \
                                     0.0, stream);                          \
  }
#define NMPC_LINEARIZE_TRACK_ENTRY(NAME, FORM, TF, TD)                      \
  extern "C" int nmpc_linearize_##NAME(                                     \
      int is_double, int N, int L, double dt_step, int steps,              \
      const void* xs, const void* ub, const void* prm, void* xn, void* J,  \
      void* hbar, void* C, const void* kap, int M_tab,                     \
      double track_length, void* stream) {                                 \
    return entry<nmpc::FORM, TF, TD>(is_double, N, L, dt_step, steps, xs,  \
                                     ub, prm, xn, J, hbar, C, kap, M_tab,  \
                                     track_length, stream);                 \
  }
