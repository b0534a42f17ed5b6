// Fused whole-IPM solve (K3) for sm_90a.
//
// Replaces mpc_collisionavoidance_tpu/kernels/ipm_pallas.py:
// fused_ipm_lanes.  Same algorithm as the plain version
// ops/ipm_lanes.py::fused_ipm_lanes_plain, per lane: `iters` fixed-sigma
// path-following iterations, each with
//   gap = sum(lambda t) / n_total,  mu = sigma gap;
//   g-family values and residuals r = g - t for up to ten families
//     control box lo/hi, state box lo/hi (stage 0 masked), hard h rows
//     lo/hi, soft rows sl/su and their slack bounds bsl/bsu;
//   soft-row elimination (beta, k, abar, qtil) and the modified Hessians
//     Rbar = Rc + diag(a_ulo + a_uhi),
//     Qbar = Qc + diag(xmask (a_xlo + a_xhi)) + Ch' diag(wH) Ch
//            + Cs' diag(wS) Cs;
//   the Newton step through K1's Riccati recursion (riccati_team.cuh);
//   slack/dual steps, per-lane fraction-to-boundary over all t and lambda,
//   the freeze rule keep = (gap <= gap_floor) | !finite(alpha, Ddx, Ddu),
//   and the step.
// then gap and eq_res = max |A dx + B du + c - dx'|, |dx0 - dx_0| of the
// final iterate.  The status is computed by the caller from (dx, du, gap,
// eq_res), as for the plain version.  The stage-0 state-box mask is built
// here (s > 0), as the TPU kernel does; the LaneQP's xmask is that mask.
// Minimum and maximum propagate NaN (min_nan / max_nan), as torch's do.
//
// Layouts (lane axis L minor-most): the LaneQP tensors as
// ops/ipm_lanes.py documents them, the static blocks Qc (nx, nx),
// QN (nx, nx), Sc (nu, nx), Rc (nu, nu), zl/Zl/zu/Zu/lsh/ush (nS,).
// Outputs dx (N+1, nx, L) and du (N, nu, L), written once at the end.
//
// Design.  One warp per lane and one lane per block (32 threads, grid L).
// - The lane's iterates (dx, du, sl, su, t, lambda) and per-iteration
//   vectors (the Hessian weight w and gradient term d of every row unit,
//   the Newton step Ddx, Ddu) live in shared memory for the whole solve;
//   the residuals, Dt, Dlambda, Dsl, Dsu and the soft-elimination scalars
//   are recomputed where they are needed instead of stored.  The one
//   global scratch is per lane and contiguous: the Newton step's cb, K, k
//   of every stage (N (nx + nu nx + nu) values, L2-resident), written by
//   the backward sweep and staged back by the forward rollout, as K1 does.
// - The two sequential passes run riccati_team.cuh's warp step.  Before
//   each backward stage the warp builds the stage's modified Hessians and
//   gradients (Qbar row r by the threads of row r, cb and qxb row r by one
//   part each, Rbar, S, qub spread over the warp) into the stage's tile,
//   next to its A, B, Ch/Cs rows, c, qx, qu, which a ring of kRing tiles
//   brings in with cp.async kRing - 1 stages ahead; the forward rollout
//   reuses the ring's bytes for A, B (transposed) and the scratch's cb, K,
//   k, as K1's does.  With one lane per block the copies are element
//   copies (4 or 8 bytes): a 16-byte copy would need 4 lanes of one entry
//   in one block, and 4 lanes' shared memory (4 x 51 KB in float32) would
//   leave the same 4 lanes per SM with a block-wide barrier per stage and
//   no room in float64.  There is no ragged block: every block is a lane.
// - The stage-independent passes spread the (stage, row unit) pairs over
//   the warp's threads (a unit is a box or h row pair, or a soft row's
//   four rows, which share its slack): the residuals and weights (pass 1),
//   the slack/dual steps and fraction-to-boundary (pass 4), the update of
//   t, lambda, sl, su (pass 5), then dx, du elementwise; the epilogue's
//   dynamics residuals over (stage, state) pairs.  The per-lane
//   reductions (gap, the step's minimum, the finiteness test, eq_res) are
//   warp butterflies of shuffles, lane 0's result taken by every thread.
//   Sums are taken in another order than the plain version's: gap agrees
//   to a few ulp (float64 ~1e-16 relative; float32 ~1e-7, inside the
//   gap-floor ball the float32 checks allow); minima and maxima are exact.
//
// Shared memory per lane (= per block) at the main paths' N, and blocks
// per SM (the H100's 228 KB per SM, 1 KB reserved per block):
//   flagship (8, 1, 1, 0, 0, 8), N=100: 13,098 values: float 52,392 B,
//                                4 per SM; double 104,784 B, 2 per SM;
//   hull (14, 2, 2, 5, 4, 0), N=100: 12,446 values: float 49,784 B, 4 per
//                                SM; double 99,568 B, 2 per SM;
//   usv_pf (14, 2, 2, 5, 0, 0), N=100: 9,878 values: float 39,512 B, 5 per
//                                SM; double 79,024 B, 2 per SM;
//   usv_low_level (8, 2, 2, 5, 0, 0), N=100: 7,148 values: float 28,592 B,
//                                7 per SM; double 57,184 B, 4 per SM (at
//                                usv_position_control's N=20: 2,188);
//   usv_acados (5, 2, 2, 5, 0, 0), N=20: 1,573 values: float 6,292 B,
//                                31 per SM; double 12,584 B, 17 per SM;
//   usv_guidance_ca (9, 1, 1, 1, 8, 0), N=100: 9,270 values: float
//                                37,080 B, 6 per SM; double 74,160 B, 3;
//   usv_guidance (10, 1, 1, 3, 0, 0), N=100: 5,870 values: float
//                                23,480 B, 9 per SM; double 46,960 B, 4;
//   usv_guidance2 (12, 1, 1, 1, 0, 0), N=100: 5,562 values: float
//                                22,248 B, 10 per SM; double 44,496 B, 5;
//   usv_guidance3 (11, 1, 1, 1, 0, 0), N=100: 5,106 values: float
//                                20,424 B, 10 per SM; double 40,848 B, 5;
//   usv_guidance4 (4, 1, 1, 0, 0, 0), N=100: 1,874 values: float 7,496 B,
//                                27 per SM; double 14,992 B, 14;
//   usv_guidance5 (5, 1, 1, 1, 0, 0), N=100: 2,790 values: float
//                                11,160 B, 19 per SM; double 22,320 B, 10;
//   race_cars (6, 2, 2, 1, 3, 2), N=50: 4,500 values: float 18,000 B,
//                                12 per SM; double 36,000 B, 6;
//   race_cars_dev (6, 2, 2, 0, 0, 6), N=50: 5,742 values: float
//                                22,968 B, 9 per SM; double 45,936 B, 4.
// So at L=512 float32 runs in one wave (528 resident lanes or more),
// float64 in two (one from usv_low_level down, for the guidance family
// but usv_guidance_ca, and for the race car).  A horizon whose layout
// exceeds the 227 KB opt-in is refused (-3).  A structure with neither
// hard nor soft rows (nHh = nS = 0) has box rows only: its tiles carry no
// row block and its row units are the box pairs; usv_guidance4's
// (4, 1, 1, 0, 0, 0) has no state box either, so its one row unit per
// stage is the control pair, and xb_lo / xb_hi (N, 0, L) are never read.
//
// Registers.  A lane's warp keeps little in registers (its row of P, the
// step's small per-lane values), but what the compiler hoists out of the
// stage loops adds up: the shared-memory layout's 22 offsets, and the
// addresses of unrolled stage copies.  Two things keep every instance
// under the 255-register cap without spills: the layout is computed on the
// host and passed in the argument block (`FusedArgs::lay`), so the kernel
// reads the offsets from the constant bank, and the copy loops
// (`stage_lane`, the forward tile's scratch) are not unrolled.  Without
// them the double instances of the structures with no h rows spilled
// (usv_pf 28 / 72 bytes at 255 registers, usv_acados 16 / 36), though the
// hull's, with more code, did not.  Double division's slow path is a call,
// and values live across its call sites (the gap, loop-entry predicates)
// are saved to local memory when the allocator runs out of registers it
// may keep across a call; how many it keeps depends on the register target
// it picks, which a minimum of blocks per SM in the launch bounds changes
// (any minimum, 1 to 8, gives the same target).  Without one, the double
// instances of usv_guidance and usv_guidance5 spill 28 / 52 and 28 / 52
// bytes at 128 and 96 registers, and race_cars' (6, 2, 2, 1, 3, 2) 4 / 8
// bytes at 128; with one, usv_guidance's and usv_guidance5's take 198
// and 150 and spill nothing.  A minimum on every instance moves usv_pf's
// double instance to 255 registers and 16 / 24 bytes of spills instead.
// So those three instances, and only they, promise one block
// (`MinBlocks`).
//
// What bounds it on the H100: the lane's dependent chain.  12 iterations
// each walk 100 backward and 100 forward stages of the warp step (K1's
// latency chain, 0.20 / 0.39 ms per sweep at (8, 1) / (14, 2)) plus the
// tile build; the stage-parallel passes add a few microseconds each.  The
// bytes and FLOPs of the whole solve (chip_smoke.ipm_work) are 2-3 orders
// of magnitude below that time.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "riccati_team.cuh"

namespace nmpc {
namespace ipm {

constexpr int kWarp = 32;    // the threads of a block: one lane's warp
constexpr int kRing = 3;     // backward stage tiles in the ring
constexpr int kMaxIdx = 16;  // room for idxbu / idxbx in the argument block
constexpr size_t kMaxShared = 232448;  // the per-block opt-in of sm_90

// offsets (in values) of a block's shared memory; computed on the host and
// passed in the argument block, so the kernel reads them from the constant
// bank instead of holding them in registers
struct Layout {
  int ring, team, Qc, QN, Sc, Rc, zl, Zl, zu, Zu, lsh, ush, dx, du, sl, su,
      t, lam, w, d, Ddx, Ddu, total;
};

template <typename T>
struct FusedArgs {
  // lane tensors
  const T *A, *B, *c, *qx, *qu, *dx0;
  const T *ub_lo, *ub_hi, *xb_lo, *xb_hi;
  const T *Ch, *hh_lo, *hh_hi;
  const T *Cs, *hofs, *slh, *suh;
  // static blocks
  const T *Qc, *QN, *Sc, *Rc, *zl, *Zl, *zu, *Zu, *lsh, *ush;
  // outputs and the per-lane scratch (cb, K, k of every stage)
  T *dx, *du, *gap_o, *eq_o, *scratch;
  int idxbu[kMaxIdx], idxbx[kMaxIdx];
  int N, L, iters;
  T tau, sigma, mu0, gap_floor;
  Layout lay;  // set by launch()
};

// minimum / maximum that propagate a NaN in either argument, as
// torch.minimum / torch.maximum do
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (b != b || b < a) ? b : a;
}
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (b != b || b > a) ? b : a;
}

// idx[j] for a runtime j < n, by compile-time reads of the argument block
// (a dynamic index into a kernel parameter would copy it to local memory)
template <int n>
__device__ __forceinline__ int pick_idx(const int (&idx)[kMaxIdx], int j) {
  int out = 0;
#pragma unroll
  for (int k = 0; k < n; ++k)
    if (k == j) out = idx[k];
  return out;
}

// warp butterflies; every thread returns lane 0's result, so that all
// threads take the same decisions
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}
template <typename T>
__device__ __forceinline__ T warp_min_nan(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}
template <typename T>
__device__ __forceinline__ T warp_max_nan(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}

// family rows of one stage: [ulo | uhi | xlo | xhi | hlo | hhi | ssl | ssu
// | bsl | bsu], the order of the plain version's family tuple
template <int NBU, int NBX, int NHH, int NS>
struct Rows {
  static constexpr int ULO = 0, UHI = NBU, XLO = 2 * NBU, XHI = XLO + NBX,
                       HLO = XHI + NBX, HHI = HLO + NHH, SSL = HHI + NHH,
                       SSU = SSL + NS, BSL = SSU + NS, BSU = BSL + NS,
                       NR = BSU + NS;
};

// row units of one stage: control box pairs, state box pairs, h row pairs,
// soft rows (sl, su, bsl, bsu); unit UH + k goes with row k of [Ch; Cs]
template <int NBU, int NBX, int NHH, int NS>
struct Units {
  static constexpr int UB = 0, UX = NBU, UH = UX + NBX, US = UH + NHH,
                       NUNIT = US + NS;
};

// one backward stage's tile: K1's BackTile (c, Qt, S, R, qx, qu built by
// the warp), then the stage's rows [Ch; Cs] and its lane inputs c, qx, qu
template <int NX, int NU, int NC>
struct StageTile {
  using BT = BackTile<NX, NU>;
  static constexpr int C = BT::size, cl = C + NC * NX, qxl = cl + NX,
                       qul = qxl + NX, size = qul + NU;
};

// values per stage in the per-lane scratch: the forward tile's c, K, k
template <int NX, int NU>
__host__ __device__ constexpr int scratch_per_stage() {
  return FwdTile<NX, NU>::size - FwdTile<NX, NU>::c;
}

// offsets (in values) of a block's shared memory for horizon N
template <int NX, int NU, int NBU, int NBX, int NHH, int NS>
struct SharedLayout : Layout {
  static constexpr int NR = Rows<NBU, NBX, NHH, NS>::NR;
  static constexpr int NUNIT = Units<NBU, NBX, NHH, NS>::NUNIT;
  using Tile = StageTile<NX, NU, NHH + NS>;
  __host__ __device__ explicit SharedLayout(int N) {
    int o = 0;
    ring = o; o += kRing * Tile::size;
    team = o; o += TeamScratch<NX, NU>::size;
    Qc = o; o += NX * NX;
    QN = o; o += NX * NX;
    Sc = o; o += NU * NX;
    Rc = o; o += NU * NU;
    zl = o; o += NS;
    Zl = o; o += NS;
    zu = o; o += NS;
    Zu = o; o += NS;
    lsh = o; o += NS;
    ush = o; o += NS;
    dx = o; o += (N + 1) * NX;
    du = o; o += N * NU;
    sl = o; o += N * NS;
    su = o; o += N * NS;
    t = o; o += N * NR;
    lam = o; o += N * NR;
    w = o; o += N * NUNIT;
    d = o; o += N * NUNIT;
    Ddx = o; o += (N + 1) * NX;
    Ddu = o; o += N * NU;
    total = o;
  }
};

// element copies of the ROWS x COLS entries of one stage of a lane-minor
// tensor (`src` at this lane's entry 0 of the stage) into `dst`,
// transposed if TR, by the warp's threads
template <typename T, int ROWS, int COLS, bool TR>
__device__ __forceinline__ void stage_lane(T* dst, const T* src, size_t L,
                                           int t) {
  // not unrolled: unrolled, the copies' addresses crowd out registers
#pragma unroll 1
  for (int e = t; e < ROWS * COLS; e += kWarp) {
    const int slot = TR ? (e % COLS) * ROWS + e / COLS : e;
    cp_async<sizeof(T)>(dst + slot, src + e * L, true);
  }
}

// Blocks per SM that an instance's launch bounds promise ptxas (0: no
// promise), specialised below the instance list.  See "Registers" above.
template <typename T, int NX, int NU, int NBU, int NBX, int NHH, int NS>
struct MinBlocks {
  static constexpr int value = 0;
};

template <typename T, int NX, int NU, int NBU, int NBX, int NHH, int NS>
__global__ void __launch_bounds__(
    kWarp, (MinBlocks<T, NX, NU, NBU, NBX, NHH, NS>::value))
fused_ipm_kernel(const FusedArgs<T> a) {
  using R = Rows<NBU, NBX, NHH, NS>;
  using U = Units<NBU, NBX, NHH, NS>;
  using SL = SharedLayout<NX, NU, NBU, NBX, NHH, NS>;
  using Tile = typename SL::Tile;
  using BT = BackTile<NX, NU>;
  using FT = FwdTile<NX, NU>;
  using TM = Team<NX>;
  constexpr int NR = R::NR, NUNIT = U::NUNIT, NC = NHH + NS;
  constexpr int FW = scratch_per_stage<NX, NU>();
  // forward tiles in the ring's bytes
  constexpr int FRING = kRing * Tile::size / FT::size;
  static_assert(kRing >= 2 && FRING >= 2, "the rings need two tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  const int N = a.N, t = threadIdx.x, l = blockIdx.x;
  const size_t L = static_cast<size_t>(a.L);
  const Layout& lay = a.lay;
  T* const ring = sm + lay.ring;
  T* const team = sm + lay.team;
  T* const Qc = sm + lay.Qc;
  T* const QN = sm + lay.QN;
  T* const Sc = sm + lay.Sc;
  T* const Rc = sm + lay.Rc;
  T* const zl = sm + lay.zl;
  T* const Zl = sm + lay.Zl;
  T* const zu = sm + lay.zu;
  T* const Zu = sm + lay.Zu;
  T* const lsh = sm + lay.lsh;
  T* const ush = sm + lay.ush;
  T* const dx = sm + lay.dx;
  T* const du = sm + lay.du;
  T* const sl = sm + lay.sl;
  T* const su = sm + lay.su;
  T* const tt = sm + lay.t;
  T* const ll = sm + lay.lam;
  T* const unit_w = sm + lay.w;
  T* const unit_d = sm + lay.d;
  T* const Ddx = sm + lay.Ddx;
  T* const Ddu = sm + lay.Ddu;
  // this lane's cb, K, k: FW values per stage
  T* const chunk = a.scratch + static_cast<size_t>(l) * N * FW;
  // this lane's entry (s, i) of an (., n, L) tensor; (s, i, j) of an
  // (., m, n, L) one
  auto at2 = [&](int s, int i, int n) -> size_t {
    return (static_cast<size_t>(s) * n + i) * L + l;
  };
  auto at3 = [&](int s, int i, int j, int m, int n) -> size_t {
    return ((static_cast<size_t>(s) * m + i) * n + j) * L + l;
  };
  const T zero = T(0), one = T(1), t_min = T(0.1), s_margin = T(0.1);
  const T sigma = a.sigma, tau = a.tau;
  const T n_total = T(N * NR > 0 ? N * NR : 1);

  // ---- static blocks, initial iterate dx = 0, du = 0 ----
  for (int e = t; e < NX * NX; e += kWarp) {
    Qc[e] = a.Qc[e];
    QN[e] = a.QN[e];
  }
  for (int e = t; e < NU * NX; e += kWarp) Sc[e] = a.Sc[e];
  for (int e = t; e < NU * NU; e += kWarp) Rc[e] = a.Rc[e];
  for (int e = t; e < NS; e += kWarp) {
    zl[e] = a.zl[e];
    Zl[e] = a.Zl[e];
    zu[e] = a.zu[e];
    Zu[e] = a.Zu[e];
    lsh[e] = a.lsh[e];
    ush[e] = a.ush[e];
  }
  for (int e = t; e < (N + 1) * NX; e += kWarp) dx[e] = zero;
  for (int e = t; e < N * NU; e += kWarp) du[e] = zero;
  __syncthreads();

  // One row unit q of stage s at the current iterate.  mode 0: the initial
  // sl, su, t, lambda (acc += lambda t); 1: the Hessian weight w and
  // gradient term d; 2: the fraction-to-boundary minimum of the Newton step
  // (acc = min); 3: the step of t, lambda, sl, su by alpha (acc += the new
  // lambda t).  Modes 2 and 3 recompute the residuals, the soft
  // elimination and the slack/dual steps from the same inputs, so both
  // see the same values.
  auto unit = [&](int s, int q, int mode, T mu, T alpha, T& acc) {
    const T xm = s > 0 ? one : zero;
    const T* x = dx + s * NX;
    const T* u = du + s * NU;
    const T* Dx = Ddx + s * NX;
    const T* Du = Ddu + s * NU;
    T* const tr = tt + s * NR;
    T* const lr = ll + s * NR;
    int row[4];
    T g[4], dg[4];
    int n = 2;
    T Dsl = zero, Dsu = zero;
    int ks = -1;  // soft row index
    if (q < U::UX) {
      const int j = q - U::UB, idx = pick_idx<NBU>(a.idxbu, j);
      const T us = u[idx];
      row[0] = R::ULO + j;
      row[1] = R::UHI + j;
      g[0] = us - a.ub_lo[at2(s, j, NBU)];
      g[1] = -us - a.ub_hi[at2(s, j, NBU)];
      dg[0] = Du[idx];
      dg[1] = -Du[idx];
    } else if (q < U::UH) {
      const int j = q - U::UX, idx = pick_idx<NBX>(a.idxbx, j);
      const T xs = x[idx];
      row[0] = R::XLO + j;
      row[1] = R::XHI + j;
      g[0] = xm * xs - a.xb_lo[at2(s, j, NBX)];
      g[1] = -xm * xs - a.xb_hi[at2(s, j, NBX)];
      dg[0] = xm * Dx[idx];
      dg[1] = -xm * Dx[idx];
    } else if (q < U::US) {
      const int k = q - U::UH;
      T hv = zero, Dhv = zero;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T ch = a.Ch[at3(s, k, i, NHH, NX)];
        hv += ch * x[i];
        if (mode >= 2) Dhv += ch * Dx[i];
      }
      row[0] = R::HLO + k;
      row[1] = R::HHI + k;
      g[0] = hv - a.hh_lo[at2(s, k, NHH)];
      g[1] = -hv - a.hh_hi[at2(s, k, NHH)];
      dg[0] = Dhv;
      dg[1] = -Dhv;
    } else {
      const int k = q - U::US;
      ks = k;
      n = 4;
      T acc_x = zero, acc_d = zero;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T cs = a.Cs[at3(s, k, i, NS, NX)];
        acc_x += cs * x[i];
        if (mode >= 2) acc_d += cs * Dx[i];
      }
      const T gv = a.hofs[at2(s, k, NS)] + acc_x;
      const T slh = a.slh[at2(s, k, NS)], suh = a.suh[at2(s, k, NS)];
      if (mode == 0) {
        sl[s * NS + k] = max_nan(slh - gv, lsh[k]) + s_margin;
        su[s * NS + k] = max_nan(gv - suh, ush[k]) + s_margin;
      }
      const T slv = sl[s * NS + k], suv = su[s * NS + k];
      row[0] = R::SSL + k;
      row[1] = R::SSU + k;
      row[2] = R::BSL + k;
      row[3] = R::BSU + k;
      g[0] = (gv - slh + slv);
      g[1] = (suh - gv + suv);
      g[2] = slv - lsh[k];
      g[3] = suv - ush[k];
      if (mode >= 1) {
        T tv[4], lv[4], rv[4], av[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          tv[m] = tr[row[m]];
          lv[m] = lr[row[m]];
          rv[m] = g[m] - tv[m];
          av[m] = lv[m] / tv[m];
        }
        const T beta_l = Zl[k] + av[0] + av[2];
        const T beta_u = Zu[k] + av[1] + av[3];
        const T k_l = mu / tv[0] + mu / tv[2] - zl[k] - Zl[k] * slv -
                      av[0] * rv[0] - av[2] * rv[2];
        const T k_u = mu / tv[1] + mu / tv[3] - zu[k] - Zu[k] * suv -
                      av[1] * rv[1] - av[3] * rv[3];
        if (mode == 1) {
          const T abar_l = av[0] * (Zl[k] + av[2]) / beta_l;
          const T abar_u = av[1] * (Zu[k] + av[3]) / beta_u;
          const T qtl = mu / tv[0] - av[0] * rv[0] - av[0] * k_l / beta_l;
          const T qtu = mu / tv[1] - av[1] * rv[1] - av[1] * k_u / beta_u;
          unit_w[s * NUNIT + q] = abar_l + abar_u;
          unit_d[s * NUNIT + q] = qtl - qtu;
          return;
        }
        Dsl = (k_l - av[0] * acc_d) / beta_l;
        Dsu = (k_u + av[1] * acc_d) / beta_u;
        dg[0] = acc_d + Dsl;
        dg[1] = -acc_d + Dsu;
        dg[2] = Dsl;
        dg[3] = Dsu;
      }
    }
    if (mode == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= n) break;
        const T t0 = max_nan(g[m], t_min);
        const T l0 = a.mu0 / t0;
        tr[row[m]] = t0;
        lr[row[m]] = l0;
        acc += l0 * t0;
      }
      return;
    }
    if (mode == 1) {
      // a box or h pair: weight a_lo + a_hi, gradient term v_lo - v_hi
      T v[2], av[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const T tv = tr[row[m]], lv = lr[row[m]];
        av[m] = lv / tv;
        v[m] = mu / tv - av[m] * (g[m] - tv);
      }
      const T sc = (q >= U::UX && q < U::UH) ? xm : one;
      unit_w[s * NUNIT + q] = sc * (av[0] + av[1]);
      unit_d[s * NUNIT + q] = sc * (v[0] - v[1]);
      return;
    }
    const T inf = static_cast<T>(INFINITY);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= n) break;
      const T tv = tr[row[m]], lv = lr[row[m]];
      const T Dt = dg[m] + (g[m] - tv);
      const T Dl = (mu - lv * tv) / tv - (lv / tv) * Dt;
      if (mode == 2) {
        const T qt = Dt < zero ? -tv / Dt : inf;
        const T ql = Dl < zero ? -lv / Dl : inf;
        acc = min_nan(acc, tau * qt);
        acc = min_nan(acc, tau * ql);
      } else {
        const T tn = tv + alpha * Dt, ln = lv + alpha * Dl;
        tr[row[m]] = tn;
        lr[row[m]] = ln;
        acc += ln * tn;
      }
    }
    if (mode == 3 && ks >= 0) {
      sl[s * NS + ks] += alpha * Dsl;
      su[s * NS + ks] += alpha * Dsu;
    }
  };

  // ---- initial slacks, t = max(g, t_min), lambda = mu0 / t ----
  T gap;
  {
    T acc = zero;
    for (int i = t; i < N * NUNIT; i += kWarp)
      unit(i / NUNIT, i % NUNIT, 0, zero, zero, acc);
    gap = warp_sum(acc) / n_total;
  }
  __syncthreads();

  // stage copies of the backward and the forward tiles
  auto stage_back = [&](T* tile, int s) {
    stage_lane<T, NX, NX, false>(tile + BT::A, a.A + at3(s, 0, 0, NX, NX),
                                 L, t);
    stage_lane<T, NX, NU, false>(tile + BT::B, a.B + at3(s, 0, 0, NX, NU),
                                 L, t);
    stage_lane<T, NHH, NX, false>(tile + Tile::C,
                                  a.Ch + at3(s, 0, 0, NHH, NX), L, t);
    stage_lane<T, NS, NX, false>(tile + Tile::C + NHH * NX,
                                 a.Cs + at3(s, 0, 0, NS, NX), L, t);
    stage_lane<T, NX, 1, false>(tile + Tile::cl, a.c + at2(s, 0, NX), L, t);
    stage_lane<T, NX, 1, false>(tile + Tile::qxl, a.qx + at2(s, 0, NX), L,
                                t);
    stage_lane<T, NU, 1, false>(tile + Tile::qul, a.qu + at2(s, 0, NU), L,
                                t);
  };
  auto stage_fwd = [&](T* tile, int s) {
    stage_lane<T, NX, NX, true>(tile + FT::At, a.A + at3(s, 0, 0, NX, NX),
                                L, t);
    stage_lane<T, NX, NU, true>(tile + FT::Bt, a.B + at3(s, 0, 0, NX, NU),
                                L, t);
#pragma unroll 1
    for (int e = t; e < FW; e += kWarp)
      cp_async<sizeof(T)>(tile + FT::c + e,
                          chunk + static_cast<size_t>(s) * FW + e, true);
  };

  // thread t's row r of P and its column part (riccati_team.cuh)
  const int r = t % TM::ROWS, part = t / TM::ROWS, j0 = part * TM::CW;
  const bool row = r < NX;

  // The stage's c = cb, Qt = Qbar', S, R = Rbar, qx = qxb, qu = qub into
  // its tile, cb also into the scratch for the forward rollout.
  auto build = [&](T* tile, int s) {
    const T* x = dx + s * NX;
    const T* u = du + s * NU;
    const T* xn = dx + (s + 1) * NX;
    const T* ws = unit_w + s * NUNIT;
    const T* ds = unit_d + s * NUNIT;
    if (row) {
      // row r of Qbar, this part's columns; Q(r, j) at Qt + j * NX + r
#pragma unroll
      for (int jj = 0; jj < TM::CW; ++jj) {
        const int j = j0 + jj;
        if (j < NX) {
          T q = Qc[r * NX + j];
#pragma unroll
          for (int b = 0; b < NBX; ++b)
            if (r == j && a.idxbx[b] == r) q = q + ws[U::UX + b];
          if (NC > 0) {
            T gm = zero;
#pragma unroll
            for (int k = 0; k < NC; ++k)
              gm += tile[Tile::C + k * NX + r] * ws[U::UH + k] *
                    tile[Tile::C + k * NX + j];
            q = q + gm;
          }
          tile[BT::Qt + j * NX + r] = q;
        }
      }
      if (part == 0) {
        // dynamics residual cb = A x + B u + c - x_next
        T ax = zero;
#pragma unroll
        for (int j = 0; j < NX; ++j) ax += tile[BT::A + r * NX + j] * x[j];
        T bu = zero;
#pragma unroll
        for (int v = 0; v < NU; ++v) bu += tile[BT::B + r * NU + v] * u[v];
        const T cb = ax + bu + tile[Tile::cl + r] - xn[r];
        tile[BT::c + r] = cb;
        chunk[static_cast<size_t>(s) * FW + r] = cb;
      }
      if (part == TM::SPLIT - 1) {
        // qxb = qx + Qc x + Sc' u - box terms - [Ch; Cs]' d
        T acc = zero;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Qc[r * NX + j] * x[j];
        T acc2 = zero;
#pragma unroll
        for (int v = 0; v < NU; ++v) acc2 += Sc[v * NX + r] * u[v];
        T gq = tile[Tile::qxl + r] + acc + acc2;
#pragma unroll
        for (int b = 0; b < NBX; ++b)
          if (a.idxbx[b] == r) gq = gq - ds[U::UX + b];
        if (NC > 0) {
          T gc = zero;
#pragma unroll
          for (int k = 0; k < NC; ++k)
            gc += tile[Tile::C + k * NX + r] * ds[U::UH + k];
          gq = gq - gc;
        }
        tile[BT::qx + r] = gq;
      }
    }
    // S = Sc, Rbar, qub = qu + Sc x + Rc u - box terms
    for (int e = t; e < NU * NX + NU * NU + NU; e += kWarp) {
      if (e < NU * NX) {
        tile[BT::S + e] = Sc[e];
      } else if (e < NU * NX + NU * NU) {
        const int e2 = e - NU * NX, v = e2 / NU, v2 = e2 % NU;
        T rb = Rc[e2];
#pragma unroll
        for (int j = 0; j < NBU; ++j)
          if (v == v2 && a.idxbu[j] == v) rb = rb + ws[U::UB + j];
        tile[BT::R + e2] = rb;
      } else {
        const int v = e - NU * NX - NU * NU;
        T acc = zero;
#pragma unroll
        for (int i = 0; i < NX; ++i) acc += Sc[v * NX + i] * x[i];
        T acc2 = zero;
#pragma unroll
        for (int v2 = 0; v2 < NU; ++v2) acc2 += Rc[v * NU + v2] * u[v2];
        T gq = tile[Tile::qul + v] + acc + acc2;
#pragma unroll
        for (int j = 0; j < NBU; ++j)
          if (a.idxbu[j] == v) gq = gq - ds[U::UB + j];
        tile[BT::qu + v] = gq;
      }
    }
  };

  // ---------------- main iteration loop ----------------
  for (int it = 0; it < a.iters; ++it) {
    const T mu = sigma * gap;

    // ---- pass 1: weights and gradient terms of every row unit ----
    {
      T unused = zero;
      for (int i = t; i < N * NUNIT; i += kWarp)
        unit(i / NUNIT, i % NUNIT, 1, mu, zero, unused);
    }
    __syncthreads();

    // ---- pass 2: backward Riccati with the modified Hessians ----
    T Pi[NX], pi = zero;
#pragma unroll
    for (int j = 0; j < NX; ++j) Pi[j] = row ? QN[r * NX + j] : zero;
    if (row && part == TM::SPLIT - 1) {
      T acc = zero;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += QN[r * NX + j] * dx[N * NX + j];
      pi = a.qx[at2(N, r, NX)] + acc;
    }
#pragma unroll
    for (int n = 0; n < kRing - 1; ++n) {
      if (n < N) stage_back(ring + n * Tile::size, N - 1 - n);
      cp_async_commit();
    }
    for (int n = 0; n < N; ++n) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // tile n landed; the warp is done with tile n-1
      const int ahead = n + kRing - 1;
      if (ahead < N)
        stage_back(ring + (ahead % kRing) * Tile::size, N - 1 - ahead);
      cp_async_commit();
      const int s = N - 1 - n;
      T* const tile = ring + (n % kRing) * Tile::size;
      build(tile, s);
      __syncwarp();
      T Kt[NU], kff[NU];
      backward_stage<T, NX, NU, 1>(t, tile, team, Pi, pi, Kt, kff);
      T* const cs = chunk + static_cast<size_t>(s) * FW;
      if (row && part == 0) {
#pragma unroll
        for (int v = 0; v < NU; ++v) cs[FT::K - FT::c + v * NX + r] = Kt[v];
      }
      if (t == 0) {
#pragma unroll
        for (int v = 0; v < NU; ++v) cs[FT::k - FT::c + v] = kff[v];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // cb, K, k of every stage written; the ring is free

    // ---- pass 3: forward rollout of the Newton step ----
    int fin = 1;
    {
      T xv = zero;
      if (t < NX) {
        xv = a.dx0[static_cast<size_t>(t) * L + l] - dx[t];
        fin = isfinite(xv);
      }
#pragma unroll
      for (int n = 0; n < FRING - 1; ++n) {
        if (n < N) stage_fwd(ring + n * FT::size, n);
        cp_async_commit();
      }
      for (int n = 0; n < N; ++n) {
        cp_async_wait<FRING - 2>();
        __syncthreads();
        const int ahead = n + FRING - 1;
        if (ahead < N) stage_fwd(ring + (ahead % FRING) * FT::size, ahead);
        cp_async_commit();
        if (t < NX) Ddx[n * NX + t] = xv;
        T uv[NU];
        xv = forward_stage<T, NX, NU, 1>(t, ring + (n % FRING) * FT::size,
                                         xv, uv);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
          fin = fin && isfinite(uv[v]);
          if (t == 0) Ddu[n * NU + v] = uv[v];
        }
        if (t < NX) fin = fin && isfinite(xv);
      }
      if (t < NX) Ddx[N * NX + t] = xv;
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- pass 4: fraction-to-boundary; the freeze rule ----
    T alpha = one;
    for (int i = t; i < N * NUNIT; i += kWarp)
      unit(i / NUNIT, i % NUNIT, 2, mu, zero, alpha);
    alpha = warp_min_nan(alpha);
    const int fin_all = warp_min_nan(fin);
    const bool keep = (gap <= a.gap_floor) || !(fin_all && isfinite(alpha));
    if (keep) alpha = zero;

    // ---- pass 5: the step (t, lambda, sl, su by unit; then dx, du) ----
    {
      T acc = zero;
      for (int i = t; i < N * NUNIT; i += kWarp)
        unit(i / NUNIT, i % NUNIT, 3, mu, alpha, acc);
      gap = warp_sum(acc) / n_total;
    }
    __syncthreads();
    for (int e = t; e < (N + 1) * NX; e += kWarp) dx[e] += alpha * Ddx[e];
    for (int e = t; e < N * NU; e += kWarp) du[e] += alpha * Ddu[e];
    __syncthreads();
  }

  // ---------------- epilogue: eq_res, outputs ----------------
  T eq = zero;
  for (int i = t; i < N * NX; i += kWarp) {
    const int s = i / NX, q = i % NX;
    T ax = zero;
#pragma unroll
    for (int j = 0; j < NX; ++j)
      ax += a.A[at3(s, q, j, NX, NX)] * dx[s * NX + j];
    T bu = zero;
#pragma unroll
    for (int v = 0; v < NU; ++v)
      bu += a.B[at3(s, q, v, NX, NU)] * du[s * NU + v];
    const T cbv = ax + bu + a.c[at2(s, q, NX)] - dx[(s + 1) * NX + q];
    eq = max_nan(eq, cbv < zero ? -cbv : cbv);
  }
  if (t < NX) {
    const T d0 = a.dx0[static_cast<size_t>(t) * L + l] - dx[t];
    eq = max_nan(eq, d0 < zero ? -d0 : d0);
  }
  eq = warp_max_nan(eq);
  if (t == 0) {
    a.gap_o[l] = gap;
    a.eq_o[l] = eq;
  }
  for (int e = t; e < (N + 1) * NX; e += kWarp)
    a.dx[at2(e / NX, e % NX, NX)] = dx[e];
  for (int e = t; e < N * NU; e += kWarp)
    a.du[at2(e / NU, e % NU, NU)] = du[e];
}

// Launches the instance on `stream`; returns cudaGetLastError(), the error
// of raising the kernel's shared-memory limit, or -3 if the horizon's
// layout does not fit a block's shared memory.  Each instance is compiled
// in its own translation unit (ipm_lanes_<structure>_<type>.cu), declared
// here and defined there.
template <typename T, int NX, int NU, int NBU, int NBX, int NHH, int NS>
int launch(const FusedArgs<T>& args, cudaStream_t stream) {
  FusedArgs<T> a = args;
  a.lay = SharedLayout<NX, NU, NBU, NBX, NHH, NS>(args.N);
  const size_t smem = sizeof(T) * a.lay.total;
  if (smem > kMaxShared) return -3;
  const auto kernel = fused_ipm_kernel<T, NX, NU, NBU, NBX, NHH, NS>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.L, kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated structures (nx, nu, nbu, nbx, nHh, nS)
#define NMPC_FLAGSHIP 8, 1, 1, 0, 0, 8   // usv_guidance_ca1
#define NMPC_HULL 14, 2, 2, 5, 4, 0      // usv_pf_ca
#define NMPC_PF 14, 2, 2, 5, 0, 0        // usv_pf
#define NMPC_LOW_LEVEL 8, 2, 2, 5, 0, 0  // usv_low_level, usv_position_control
#define NMPC_ACADOS 5, 2, 2, 5, 0, 0     // usv_acados
#define NMPC_GUIDANCE_CA 9, 1, 1, 1, 8, 0  // usv_guidance_ca
#define NMPC_GUIDANCE 10, 1, 1, 3, 0, 0    // usv_guidance
#define NMPC_GUIDANCE2 12, 1, 1, 1, 0, 0   // usv_guidance2
#define NMPC_GUIDANCE3 11, 1, 1, 1, 0, 0   // usv_guidance3
#define NMPC_GUIDANCE4 4, 1, 1, 0, 0, 0    // usv_guidance4
#define NMPC_GUIDANCE5 5, 1, 1, 1, 0, 0    // usv_guidance5
#define NMPC_RACE 6, 2, 2, 1, 3, 2         // race_cars
#define NMPC_RACE_DEV 6, 2, 2, 0, 0, 6     // race_cars_dev
#define NMPC_K3_STRUCTURES(X)                                               \
  X(NMPC_FLAGSHIP) X(NMPC_HULL) X(NMPC_PF) X(NMPC_LOW_LEVEL) X(NMPC_ACADOS) \
  X(NMPC_GUIDANCE_CA) X(NMPC_GUIDANCE) X(NMPC_GUIDANCE2) X(NMPC_GUIDANCE3)  \
  X(NMPC_GUIDANCE4) X(NMPC_GUIDANCE5) X(NMPC_RACE) X(NMPC_RACE_DEV)
#define NMPC_DECLARE_INSTANCE(S)                                          \
  extern template int launch<float, S>(const FusedArgs<float>&,          \
                                       cudaStream_t);                     \
  extern template int launch<double, S>(const FusedArgs<double>&,        \
                                        cudaStream_t);
NMPC_K3_STRUCTURES(NMPC_DECLARE_INSTANCE)
#undef NMPC_DECLARE_INSTANCE

// the double instances of usv_guidance, usv_guidance5 and race_cars
// promise one block per SM (see "Registers" above)
template <>
struct MinBlocks<double, NMPC_GUIDANCE> {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<double, NMPC_GUIDANCE5> {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<double, NMPC_RACE> {
  static constexpr int value = 1;
};

}  // namespace ipm
}  // namespace nmpc
