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
//   the Newton step through an inlined Riccati sweep (K1's recursion);
//   slack/dual steps, per-lane fraction-to-boundary over all t and lambda,
//   the freeze rule keep = (gap <= gap_floor) | !finite(alpha, Ddx, Ddu),
//   and the step.
// then gap and eq_res = max |A dx + B du + c - dx'|, |dx0 - dx_0| of the
// final iterate.  The status is computed by the caller from (dx, du, gap,
// eq_res), as for the plain version.  The stage-0 state-box mask is built
// here (s > 0), as the TPU kernel does; the LaneQP's xmask is that mask.
//
// Layouts (lane axis L minor-most): the LaneQP tensors as
// ops/ipm_lanes.py documents them, the static blocks Qc (nx, nx),
// QN (nx, nx), Sc (nu, nx), Rc (nu, nu), zl/Zl/zu/Zu/lsh/ush (nS,).
// Outputs dx (N+1, nx, L) and du (N, nu, L) double as the primal iterate.
//
// Design: one thread per lane runs the whole solve; every per-lane
// reduction (gap, fraction-to-boundary minimum, finiteness, eq_res) stays
// inside the thread.  The iterates and per-iteration vectors live in one
// global scratch the wrapper allocates, lane-minor (slot * L + lane), so
// the 32 threads of a warp touch 32 neighbouring addresses:
//   Ddx, Ddu, sl, su, Dsl, Dsu; t, lambda, Dt and r for the family rows of
//   every stage; the modified gradients qxb, qub, the dynamics residual
//   cb; K, k; the Hessian weights wu, wx, wH, wS and the soft-elimination
//   scalars k_l, k_u, beta_l, beta_u.
// At N=100: 24,416 values per lane for the flagship (34 family rows per
// stage) and 17,528 for the hull (22 rows); `nmpc_fused_ipm_scratch`
// gives the count.  That is 50 / 36 MB at L=512 in float32, twice that in
// float64, read and written several times per iteration (in part
// L2-resident: the H100 has 50 MB of L2).
// The static blocks are staged in shared memory once per block.  Empty
// families generate no code (template row counts of 0).
//
// What bounds it on the H100: latency and occupancy, as for K1.  Each
// thread walks N stages five times per iteration (family pass, backward
// and forward sweep, step pass, update), every pass a dependent chain; at
// L=512 only 16 blocks of 32 threads exist, so 16 of 132 SMs hold one
// warp each.  Register pressure: the inlined Riccati holds P, PA and their
// temporaries (~2 nx^2 values), above the 255-register cap at nx=14 and in
// float64 at nx=8, so those instances spill to local memory.  Accepted
// for bring-up; a later PR can split a lane's matrix work across a warp,
// keep the family vectors in shared memory, or batch more lanes per SM.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace nmpc {
namespace ipm {

constexpr int kBlock = 32;   // one warp per block: spread lanes over SMs
constexpr int kMaxIdx = 16;  // room for idxbu / idxbx in the argument block

template <typename T>
struct FusedArgs {
  // lane tensors
  const T *A, *B, *c, *qx, *qu, *dx0;
  const T *ub_lo, *ub_hi, *xb_lo, *xb_hi;
  const T *Ch, *hh_lo, *hh_hi;
  const T *Cs, *hofs, *slh, *suh;
  // static blocks
  const T *Qc, *QN, *Sc, *Rc, *zl, *Zl, *zu, *Zu, *lsh, *ush;
  // outputs (dx, du are the primal iterate) and scratch
  T *dx, *du, *gap_o, *eq_o, *scratch;
  int idxbu[kMaxIdx], idxbx[kMaxIdx];
  int N, L, iters;
  T tau, sigma, mu0, gap_floor;
};

__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return ::sqrt(a); }

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

// v[idx] and v[idx] += d for a runtime index (idxbu / idxbx) without
// dynamic indexing, so that v stays in registers
template <typename T, int n>
__device__ __forceinline__ T pick(const T (&v)[n], int idx) {
  T out = T(0);
#pragma unroll
  for (int k = 0; k < n; ++k)
    if (k == idx) out = v[k];
  return out;
}
template <typename T, int n>
__device__ __forceinline__ void add_at(T (&v)[n], int idx, T d) {
#pragma unroll
  for (int k = 0; k < n; ++k)
    if (k == idx) v[k] += d;
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

// scratch slots per lane (each slot holds L values, lane-minor)
template <int NX, int NU, int NBU, int NBX, int NHH, int NS>
struct Layout {
  static constexpr int NR = Rows<NBU, NBX, NHH, NS>::NR;
  size_t Ddx, Ddu, sl, su, Dsl, Dsu, t, lam, Dt, res, qxb, qub, cb, K, kf,
      wu, wx, wH, wS, kl, ku, bl, bu, total;
  __host__ __device__ explicit Layout(int N) {
    const size_t n = static_cast<size_t>(N);
    size_t o = 0;
    Ddx = o; o += (n + 1) * NX;
    Ddu = o; o += n * NU;
    sl = o; o += n * NS;
    su = o; o += n * NS;
    Dsl = o; o += n * NS;
    Dsu = o; o += n * NS;
    t = o; o += n * NR;
    lam = o; o += n * NR;
    Dt = o; o += n * NR;
    res = o; o += n * NR;
    qxb = o; o += (n + 1) * NX;
    qub = o; o += n * NU;
    cb = o; o += n * NX;
    K = o; o += n * NU * NX;
    kf = o; o += n * NU;
    wu = o; o += n * NBU;
    wx = o; o += n * NBX;
    wH = o; o += n * NHH;
    wS = o; o += n * NS;
    kl = o; o += n * NS;
    ku = o; o += n * NS;
    bl = o; o += n * NS;
    bu = o; o += n * NS;
    total = o;
  }
};

template <typename T, int NX, int NU, int NBU, int NBX, int NHH, int NS>
__global__ void __launch_bounds__(kBlock)
fused_ipm_kernel(const FusedArgs<T> a) {
  using R = Rows<NBU, NBX, NHH, NS>;
  constexpr int NR = R::NR;
  // array extents of empty families
  constexpr int NRA = NR > 0 ? NR : 1, NSA = NS > 0 ? NS : 1,
                NHA = NHH > 0 ? NHH : 1, NBXA = NBX > 0 ? NBX : 1;

  // ---- static blocks -> shared memory (before the lane bound) ----
  __shared__ T sQc[NX * NX], sQN[NX * NX], sSc[NU * NX], sRc[NU * NU];
  __shared__ T szl[NSA], sZl[NSA], szu[NSA], sZu[NSA], slsh[NSA], sush[NSA];
  for (int i = threadIdx.x; i < NX * NX; i += blockDim.x) {
    sQc[i] = a.Qc[i];
    sQN[i] = a.QN[i];
  }
  for (int i = threadIdx.x; i < NU * NX; i += blockDim.x) sSc[i] = a.Sc[i];
  for (int i = threadIdx.x; i < NU * NU; i += blockDim.x) sRc[i] = a.Rc[i];
  for (int i = threadIdx.x; i < NS; i += blockDim.x) {
    szl[i] = a.zl[i];
    sZl[i] = a.Zl[i];
    szu[i] = a.zu[i];
    sZu[i] = a.Zu[i];
    slsh[i] = a.lsh[i];
    sush[i] = a.ush[i];
  }
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= a.L) return;
  const int N = a.N;
  const size_t L = static_cast<size_t>(a.L);
  const Layout<NX, NU, NBU, NBX, NHH, NS> lay(N);
  T* const scr = a.scratch + l;
  // scratch slot
  auto S = [&](size_t slot) -> T& { return scr[slot * L]; };
  // entry (s, i) of an (N, n, L) tensor; (s, i, j) of an (N, m, n, L) one
  auto at2 = [&](int s, int i, int n) -> size_t {
    return (static_cast<size_t>(s) * n + i) * L + l;
  };
  auto at3 = [&](int s, int i, int j, int m, int n) -> size_t {
    return ((static_cast<size_t>(s) * m + i) * n + j) * L + l;
  };
  const T zero = T(0), one = T(1), t_min = T(0.1), s_margin = T(0.1);
  const T mu0 = a.mu0, sigma = a.sigma, tau = a.tau;
  const T n_total = T(N * NR > 0 ? N * NR : 1);

  // g-family values of stage s at the primal point (x, u, sl, su)
  auto g_rows = [&](int s, const T (&x)[NX], const T (&u)[NU],
                    const T (&slv)[NSA], const T (&suv)[NSA], T (&g)[NRA],
                    T (&hv)[NHA], T (&gv)[NSA]) {
    const T xm = s > 0 ? one : zero;
#pragma unroll
    for (int j = 0; j < NBU; ++j) {
      const T us = pick(u, a.idxbu[j]);
      g[R::ULO + j] = us - a.ub_lo[at2(s, j, NBU)];
      g[R::UHI + j] = -us - a.ub_hi[at2(s, j, NBU)];
    }
#pragma unroll
    for (int j = 0; j < NBX; ++j) {
      const T xs = pick(x, a.idxbx[j]);
      g[R::XLO + j] = xm * xs - a.xb_lo[at2(s, j, NBX)];
      g[R::XHI + j] = -xm * xs - a.xb_hi[at2(s, j, NBX)];
    }
#pragma unroll
    for (int r = 0; r < NHH; ++r) {
      T acc = zero;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += a.Ch[at3(s, r, k, NHH, NX)] * x[k];
      hv[r] = acc;
      g[R::HLO + r] = acc - a.hh_lo[at2(s, r, NHH)];
      g[R::HHI + r] = -acc - a.hh_hi[at2(s, r, NHH)];
    }
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      T acc = zero;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += a.Cs[at3(s, r, k, NS, NX)] * x[k];
      gv[r] = a.hofs[at2(s, r, NS)] + acc;
      g[R::SSL + r] = (gv[r] - a.slh[at2(s, r, NS)] + slv[r]);
      g[R::SSU + r] = (a.suh[at2(s, r, NS)] - gv[r] + suv[r]);
      g[R::BSL + r] = slv[r] - slsh[r];
      g[R::BSU + r] = suv[r] - sush[r];
    }
  };

  // ---------------- initialization: dx = 0, du = 0 ----------------
  for (int s = 0; s <= N; ++s)
#pragma unroll
    for (int i = 0; i < NX; ++i) a.dx[at2(s, i, NX)] = zero;
  for (int s = 0; s < N; ++s) {
#pragma unroll
    for (int u = 0; u < NU; ++u) a.du[at2(s, u, NU)] = zero;
    T x[NX], u[NU], slv[NSA], suv[NSA], g[NRA], hv[NHA],
        gv[NSA];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = zero;
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = zero;
    // gv0 = hofs + Cs 0
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      T acc = zero;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += a.Cs[at3(s, r, k, NS, NX)] * zero;
      const T gv0 = a.hofs[at2(s, r, NS)] + acc;
      slv[r] = max_nan(a.slh[at2(s, r, NS)] - gv0, slsh[r]) + s_margin;
      suv[r] = max_nan(gv0 - a.suh[at2(s, r, NS)], sush[r]) + s_margin;
      S(lay.sl + static_cast<size_t>(s) * NS + r) = slv[r];
      S(lay.su + static_cast<size_t>(s) * NS + r) = suv[r];
    }
    g_rows(s, x, u, slv, suv, g, hv, gv);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T t0 = max_nan(g[r], t_min);
      S(lay.t + static_cast<size_t>(s) * NR + r) = t0;
      S(lay.lam + static_cast<size_t>(s) * NR + r) = mu0 / t0;
    }
  }

  auto gap_now = [&]() -> T {
    T acc = zero;
    for (int s = 0; s < N; ++s)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const size_t o = static_cast<size_t>(s) * NR + r;
        acc += S(lay.lam + o) * S(lay.t + o);
      }
    return acc / n_total;
  };

  // ---------------- main iteration loop ----------------
  for (int it = 0; it < a.iters; ++it) {
    const T gap = gap_now();
    const T mu = sigma * gap;

    // ---- pass 1: residuals, weights, modified gradients, cb ----
    for (int s = 0; s < N; ++s) {
      const T xm = s > 0 ? one : zero;
      T x[NX], u[NU], slv[NSA], suv[NSA], g[NRA], hv[NHA],
          gv[NSA], tt[NRA], ll[NRA],
          rr[NRA], aa[NRA];
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = a.dx[at2(s, i, NX)];
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = a.du[at2(s, i, NU)];
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        slv[r] = S(lay.sl + static_cast<size_t>(s) * NS + r);
        suv[r] = S(lay.su + static_cast<size_t>(s) * NS + r);
      }
      g_rows(s, x, u, slv, suv, g, hv, gv);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const size_t o = static_cast<size_t>(s) * NR + r;
        tt[r] = S(lay.t + o);
        ll[r] = S(lay.lam + o);
        rr[r] = g[r] - tt[r];
        aa[r] = ll[r] / tt[r];
        S(lay.res + o) = rr[r];
      }

      // gradient base: qx + Qc x + Sc' u, qu + Sc x + Rc u
      T qxs[NX], qus[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = zero;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += sQc[i * NX + j] * x[j];
        T acc2 = zero;
#pragma unroll
        for (int v = 0; v < NU; ++v) acc2 += sSc[v * NX + i] * u[v];
        qxs[i] = a.qx[at2(s, i, NX)] + acc + acc2;
      }
#pragma unroll
      for (int v = 0; v < NU; ++v) {
        T acc = zero;
#pragma unroll
        for (int i = 0; i < NX; ++i) acc += sSc[v * NX + i] * x[i];
        T acc2 = zero;
#pragma unroll
        for (int w = 0; w < NU; ++w) acc2 += sRc[v * NU + w] * u[w];
        qus[v] = a.qu[at2(s, v, NU)] + acc + acc2;
      }

      // control box: Rbar diagonal weight and gradient term
#pragma unroll
      for (int j = 0; j < NBU; ++j) {
        const int lo = R::ULO + j, hi = R::UHI + j;
        S(lay.wu + static_cast<size_t>(s) * NBU + j) = aa[lo] + aa[hi];
        const T vec = (mu / tt[lo] - aa[lo] * rr[lo]) -
                      (mu / tt[hi] - aa[hi] * rr[hi]);
        add_at(qus, a.idxbu[j], -vec);
      }
      // state box (stage 0 masked)
#pragma unroll
      for (int j = 0; j < NBX; ++j) {
        const int lo = R::XLO + j, hi = R::XHI + j;
        S(lay.wx + static_cast<size_t>(s) * NBX + j) = xm * (aa[lo] + aa[hi]);
        const T vec = xm * ((mu / tt[lo] - aa[lo] * rr[lo]) -
                            (mu / tt[hi] - aa[hi] * rr[hi]));
        add_at(qxs, a.idxbx[j], -vec);
      }
      // hard h rows: gram weight, - Ch' v_lo + Ch' v_hi
      if (NHH > 0) {
        T vlo[NHA], vhi[NHA];
#pragma unroll
        for (int r = 0; r < NHH; ++r) {
          const int lo = R::HLO + r, hi = R::HHI + r;
          S(lay.wH + static_cast<size_t>(s) * NHH + r) = aa[lo] + aa[hi];
          vlo[r] = mu / tt[lo] - aa[lo] * rr[lo];
          vhi[r] = mu / tt[hi] - aa[hi] * rr[hi];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T tlo = zero, thi = zero;
#pragma unroll
          for (int r = 0; r < NHH; ++r) {
            const T ch = a.Ch[at3(s, r, i, NHH, NX)];
            tlo += ch * vlo[r];
            thi += ch * vhi[r];
          }
          qxs[i] = qxs[i] - tlo + thi;
        }
      }
      // soft rows: elimination scalars, gram weight, - Cs' qtil_l + Cs'
      // qtil_u
      if (NS > 0) {
        T qtl[NSA], qtu[NSA];
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          const int isl = R::SSL + r, isu = R::SSU + r, ibl = R::BSL + r,
                    ibu = R::BSU + r;
          const T beta_l = sZl[r] + aa[isl] + aa[ibl];
          const T beta_u = sZu[r] + aa[isu] + aa[ibu];
          const T abar_l = aa[isl] * (sZl[r] + aa[ibl]) / beta_l;
          const T abar_u = aa[isu] * (sZu[r] + aa[ibu]) / beta_u;
          const T k_l = mu / tt[isl] + mu / tt[ibl] - szl[r] -
                        sZl[r] * slv[r] - aa[isl] * rr[isl] -
                        aa[ibl] * rr[ibl];
          const T k_u = mu / tt[isu] + mu / tt[ibu] - szu[r] -
                        sZu[r] * suv[r] - aa[isu] * rr[isu] -
                        aa[ibu] * rr[ibu];
          qtl[r] = mu / tt[isl] - aa[isl] * rr[isl] - aa[isl] * k_l / beta_l;
          qtu[r] = mu / tt[isu] - aa[isu] * rr[isu] - aa[isu] * k_u / beta_u;
          const size_t o = static_cast<size_t>(s) * NS + r;
          S(lay.wS + o) = abar_l + abar_u;
          S(lay.kl + o) = k_l;
          S(lay.ku + o) = k_u;
          S(lay.bl + o) = beta_l;
          S(lay.bu + o) = beta_u;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T tl = zero, tu = zero;
#pragma unroll
          for (int r = 0; r < NS; ++r) {
            const T cs = a.Cs[at3(s, r, i, NS, NX)];
            tl += cs * qtl[r];
            tu += cs * qtu[r];
          }
          qxs[i] = qxs[i] - tl + tu;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
        S(lay.qxb + static_cast<size_t>(s) * NX + i) = qxs[i];
#pragma unroll
      for (int v = 0; v < NU; ++v)
        S(lay.qub + static_cast<size_t>(s) * NU + v) = qus[v];

      // dynamics residual cb = A x + B u + c - x_next
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T ax = zero;
#pragma unroll
        for (int j = 0; j < NX; ++j) ax += a.A[at3(s, i, j, NX, NX)] * x[j];
        T bu = zero;
#pragma unroll
        for (int v = 0; v < NU; ++v) bu += a.B[at3(s, i, v, NX, NU)] * u[v];
        S(lay.cb + static_cast<size_t>(s) * NX + i) =
            ax + bu + a.c[at2(s, i, NX)] - a.dx[at2(s + 1, i, NX)];
      }
    }
    // terminal gradient and the initial-state residual
    {
      T xN[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xN[i] = a.dx[at2(N, i, NX)];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = zero;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += sQN[i * NX + j] * xN[j];
        S(lay.qxb + static_cast<size_t>(N) * NX + i) =
            a.qx[at2(N, i, NX)] + acc;
        S(lay.Ddx + i) = a.dx0[static_cast<size_t>(i) * L + l] -
                         a.dx[at2(0, i, NX)];
      }
    }

    // ---- pass 2: backward Riccati with the modified Hessians ----
    {
      T P[NX][NX], p[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = sQN[i * NX + j];
        p[i] = S(lay.qxb + static_cast<size_t>(N) * NX + i);
      }
      for (int s = N - 1; s >= 0; --s) {
        T Bs[NX][NU], cs[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int v = 0; v < NU; ++v) Bs[i][v] = a.B[at3(s, i, v, NX, NU)];
          cs[i] = S(lay.cb + static_cast<size_t>(s) * NX + i);
        }
        // PA = P A, one column of A at a time
        T PA[NX][NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T acol[NX];
#pragma unroll
          for (int k = 0; k < NX; ++k) acol[k] = a.A[at3(s, k, j, NX, NX)];
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            T acc = zero;
#pragma unroll
            for (int k = 0; k < NX; ++k) acc += P[i][k] * acol[k];
            PA[i][j] = acc;
          }
        }
        T PB[NX][NU], Pc_p[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int v = 0; v < NU; ++v) {
            T acc = zero;
#pragma unroll
            for (int k = 0; k < NX; ++k) acc += P[i][k] * Bs[k][v];
            PB[i][v] = acc;
          }
          T acc = zero;
#pragma unroll
          for (int k = 0; k < NX; ++k) acc += P[i][k] * cs[k];
          Pc_p[i] = acc + p[i];
        }

        // Huu = Rbar + B'PB, Hux = Sc + B'PA, hu = qub + B'(Pc + p)
        T Huu[NU][NU], Hux[NU][NX], hu[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) {
#pragma unroll
          for (int w = 0; w < NU; ++w) {
            T acc = zero;
#pragma unroll
            for (int k = 0; k < NX; ++k) acc += Bs[k][v] * PB[k][w];
            T rb = sRc[v * NU + w];
#pragma unroll
            for (int j = 0; j < NBU; ++j)
              if (v == w && a.idxbu[j] == v)
                rb = rb + S(lay.wu + static_cast<size_t>(s) * NBU + j);
            Huu[v][w] = rb + acc;
          }
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T acc = zero;
#pragma unroll
            for (int k = 0; k < NX; ++k) acc += Bs[k][v] * PA[k][j];
            Hux[v][j] = sSc[v * NX + j] + acc;
          }
          T acc = zero;
#pragma unroll
          for (int k = 0; k < NX; ++k) acc += Bs[k][v] * Pc_p[k];
          hu[v] = S(lay.qub + static_cast<size_t>(s) * NU + v) + acc;
        }

        // unrolled Cholesky Huu = Lf Lf' (nu <= 2)
        T Lf[NU][NU];
#pragma unroll
        for (int r = 0; r < NU; ++r)
#pragma unroll
          for (int cc = 0; cc <= r; ++cc) {
            T acc = Huu[r][cc];
#pragma unroll
            for (int q = 0; q < cc; ++q) acc -= Lf[r][q] * Lf[cc][q];
            Lf[r][cc] = (r == cc) ? root(acc) : acc / Lf[cc][cc];
          }
        auto solve_neg = [&](T (&xv)[NU]) {
          T y[NU];
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            T acc = -xv[r];
#pragma unroll
            for (int q = 0; q < r; ++q) acc -= Lf[r][q] * y[q];
            y[r] = acc / Lf[r][r];
          }
#pragma unroll
          for (int r = NU - 1; r >= 0; --r) {
            T acc = y[r];
#pragma unroll
            for (int q = r + 1; q < NU; ++q) acc -= Lf[q][r] * xv[q];
            xv[r] = acc / Lf[r][r];
          }
        };
        T Kg[NU][NX], kff[NU];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T col[NU];
#pragma unroll
          for (int v = 0; v < NU; ++v) col[v] = Hux[v][j];
          solve_neg(col);
#pragma unroll
          for (int v = 0; v < NU; ++v) Kg[v][j] = col[v];
        }
#pragma unroll
        for (int v = 0; v < NU; ++v) kff[v] = hu[v];
        solve_neg(kff);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
#pragma unroll
          for (int j = 0; j < NX; ++j)
            S(lay.K + (static_cast<size_t>(s) * NU + v) * NX + j) = Kg[v][j];
          S(lay.kf + static_cast<size_t>(s) * NU + v) = kff[v];
        }

        // row weights of the stage's Hessian grams
        T wh[NHA], ws[NSA], wxs[NBXA];
#pragma unroll
        for (int r = 0; r < NHH; ++r)
          wh[r] = S(lay.wH + static_cast<size_t>(s) * NHH + r);
#pragma unroll
        for (int r = 0; r < NS; ++r)
          ws[r] = S(lay.wS + static_cast<size_t>(s) * NS + r);
#pragma unroll
        for (int j = 0; j < NBX; ++j)
          wxs[j] = S(lay.wx + static_cast<size_t>(s) * NBX + j);

        // P <- sym(Qbar + A'PA + Hux'K), p <- qxb + A'(Pc + p) + Hux'k
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T acol[NX];
#pragma unroll
          for (int k = 0; k < NX; ++k) acol[k] = a.A[at3(s, k, i, NX, NX)];
          T chi[NHA], csi[NSA];
#pragma unroll
          for (int r = 0; r < NHH; ++r)
            chi[r] = a.Ch[at3(s, r, i, NHH, NX)] * wh[r];
#pragma unroll
          for (int r = 0; r < NS; ++r)
            csi[r] = a.Cs[at3(s, r, i, NS, NX)] * ws[r];
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T q = sQc[i * NX + j];
#pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (i == j && a.idxbx[b] == i) q = q + wxs[b];
            if (NHH > 0) {
              T gh = zero;
#pragma unroll
              for (int r = 0; r < NHH; ++r)
                gh += chi[r] * a.Ch[at3(s, r, j, NHH, NX)];
              q = q + gh;
            }
            if (NS > 0) {
              T gs = zero;
#pragma unroll
              for (int r = 0; r < NS; ++r)
                gs += csi[r] * a.Cs[at3(s, r, j, NS, NX)];
              q = q + gs;
            }
            T apa = zero;
#pragma unroll
            for (int k = 0; k < NX; ++k) apa += acol[k] * PA[k][j];
            T hk = zero;
#pragma unroll
            for (int v = 0; v < NU; ++v) hk += Hux[v][i] * Kg[v][j];
            P[i][j] = q + apa + hk;
          }
          T ac = zero;
#pragma unroll
          for (int k = 0; k < NX; ++k) ac += acol[k] * Pc_p[k];
          T hkf = zero;
#pragma unroll
          for (int v = 0; v < NU; ++v) hkf += Hux[v][i] * kff[v];
          p[i] = S(lay.qxb + static_cast<size_t>(s) * NX + i) + ac + hkf;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = i + 1; j < NX; ++j) {
            const T v = T(0.5) * (P[i][j] + P[j][i]);
            P[i][j] = v;
            P[j][i] = v;
          }
      }
    }

    // ---- pass 3: forward rollout of the Newton step ----
    bool fin = true;
    {
      T xv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xv[i] = S(lay.Ddx + i);
        fin = fin && isfinite(xv[i]);
      }
      for (int s = 0; s < N; ++s) {
        T uv[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) {
          T acc = zero;
#pragma unroll
          for (int j = 0; j < NX; ++j)
            acc += S(lay.K + (static_cast<size_t>(s) * NU + v) * NX + j) *
                   xv[j];
          uv[v] = acc + S(lay.kf + static_cast<size_t>(s) * NU + v);
          S(lay.Ddu + static_cast<size_t>(s) * NU + v) = uv[v];
          fin = fin && isfinite(uv[v]);
        }
        T xn[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T ax = zero;
#pragma unroll
          for (int j = 0; j < NX; ++j) ax += a.A[at3(s, i, j, NX, NX)] * xv[j];
          T bu = zero;
#pragma unroll
          for (int v = 0; v < NU; ++v) bu += a.B[at3(s, i, v, NX, NU)] * uv[v];
          xn[i] = ax + bu + S(lay.cb + static_cast<size_t>(s) * NX + i);
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          xv[i] = xn[i];
          S(lay.Ddx + static_cast<size_t>(s + 1) * NX + i) = xn[i];
          fin = fin && isfinite(xn[i]);
        }
      }
    }

    // ---- pass 4: slack/dual steps and fraction-to-boundary ----
    T alpha = one;
    for (int s = 0; s < N; ++s) {
      const T xm = s > 0 ? one : zero;
      T dxs[NX], dus[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
        dxs[i] = S(lay.Ddx + static_cast<size_t>(s) * NX + i);
#pragma unroll
      for (int v = 0; v < NU; ++v)
        dus[v] = S(lay.Ddu + static_cast<size_t>(s) * NU + v);
      T rr[NRA], Dt[NRA];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        rr[r] = S(lay.res + static_cast<size_t>(s) * NR + r);
#pragma unroll
      for (int j = 0; j < NBU; ++j) {
        const T us = pick(dus, a.idxbu[j]);
        Dt[R::ULO + j] = us + rr[R::ULO + j];
        Dt[R::UHI + j] = -us + rr[R::UHI + j];
      }
#pragma unroll
      for (int j = 0; j < NBX; ++j) {
        const T xs = pick(dxs, a.idxbx[j]);
        Dt[R::XLO + j] = xm * xs + rr[R::XLO + j];
        Dt[R::XHI + j] = -xm * xs + rr[R::XHI + j];
      }
#pragma unroll
      for (int r = 0; r < NHH; ++r) {
        T acc = zero;
#pragma unroll
        for (int k = 0; k < NX; ++k)
          acc += a.Ch[at3(s, r, k, NHH, NX)] * dxs[k];
        Dt[R::HLO + r] = acc + rr[R::HLO + r];
        Dt[R::HHI + r] = -acc + rr[R::HHI + r];
      }
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        T acc = zero;
#pragma unroll
        for (int k = 0; k < NX; ++k)
          acc += a.Cs[at3(s, r, k, NS, NX)] * dxs[k];
        const size_t o = static_cast<size_t>(s) * NS + r;
        const size_t ot = static_cast<size_t>(s) * NR;
        const T a_sl =
            S(lay.lam + ot + R::SSL + r) / S(lay.t + ot + R::SSL + r);
        const T a_su =
            S(lay.lam + ot + R::SSU + r) / S(lay.t + ot + R::SSU + r);
        const T Dsl = (S(lay.kl + o) - a_sl * acc) / S(lay.bl + o);
        const T Dsu = (S(lay.ku + o) + a_su * acc) / S(lay.bu + o);
        S(lay.Dsl + o) = Dsl;
        S(lay.Dsu + o) = Dsu;
        Dt[R::SSL + r] = acc + Dsl + rr[R::SSL + r];
        Dt[R::SSU + r] = -acc + Dsu + rr[R::SSU + r];
        Dt[R::BSL + r] = Dsl + rr[R::BSL + r];
        Dt[R::BSU + r] = Dsu + rr[R::BSU + r];
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const size_t o = static_cast<size_t>(s) * NR + r;
        const T tv = S(lay.t + o), lv = S(lay.lam + o);
        const T Dl = (mu - lv * tv) / tv - (lv / tv) * Dt[r];
        S(lay.Dt + o) = Dt[r];
        const T inf = static_cast<T>(INFINITY);
        const T qt = Dt[r] < zero ? -tv / Dt[r] : inf;
        const T ql = Dl < zero ? -lv / Dl : inf;
        alpha = min_nan(alpha, tau * qt);
        alpha = min_nan(alpha, tau * ql);
      }
    }
    const bool keep = (gap <= a.gap_floor) || !(fin && isfinite(alpha));
    if (keep) alpha = zero;

    // ---- pass 5: apply the step ----
    for (int s = 0; s <= N; ++s)
#pragma unroll
      for (int i = 0; i < NX; ++i)
        a.dx[at2(s, i, NX)] +=
            alpha * S(lay.Ddx + static_cast<size_t>(s) * NX + i);
    for (int s = 0; s < N; ++s) {
#pragma unroll
      for (int v = 0; v < NU; ++v)
        a.du[at2(s, v, NU)] +=
            alpha * S(lay.Ddu + static_cast<size_t>(s) * NU + v);
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        const size_t o = static_cast<size_t>(s) * NS + r;
        S(lay.sl + o) += alpha * S(lay.Dsl + o);
        S(lay.su + o) += alpha * S(lay.Dsu + o);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const size_t o = static_cast<size_t>(s) * NR + r;
        const T tv = S(lay.t + o), lv = S(lay.lam + o), Dt = S(lay.Dt + o);
        const T Dl = (mu - lv * tv) / tv - (lv / tv) * Dt;
        S(lay.t + o) = tv + alpha * Dt;
        S(lay.lam + o) = lv + alpha * Dl;
      }
    }
  }

  // ---------------- epilogue: gap and eq_res ----------------
  a.gap_o[l] = gap_now();
  T eq = zero;
  for (int s = 0; s < N; ++s) {
    T x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = a.dx[at2(s, i, NX)];
#pragma unroll
    for (int v = 0; v < NU; ++v) u[v] = a.du[at2(s, v, NU)];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T ax = zero;
#pragma unroll
      for (int j = 0; j < NX; ++j) ax += a.A[at3(s, i, j, NX, NX)] * x[j];
      T bu = zero;
#pragma unroll
      for (int v = 0; v < NU; ++v) bu += a.B[at3(s, i, v, NX, NU)] * u[v];
      const T cbv = ax + bu + a.c[at2(s, i, NX)] - a.dx[at2(s + 1, i, NX)];
      eq = max_nan(eq, cbv < zero ? -cbv : cbv);
    }
  }
  T eq0 = zero;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const T d = a.dx0[static_cast<size_t>(i) * L + l] - a.dx[at2(0, i, NX)];
    eq0 = max_nan(eq0, d < zero ? -d : d);
  }
  a.eq_o[l] = max_nan(eq, eq0);
}

// Launches the instance on `stream`; returns cudaGetLastError().  Each
// instance is compiled in its own translation unit
// (ipm_lanes_<structure>_<type>.cu), declared here and defined there.
template <typename T, int NX, int NU, int NBU, int NBX, int NHH, int NS>
int launch(const FusedArgs<T>& args, cudaStream_t stream) {
  const int grid = (args.L + kBlock - 1) / kBlock;
  fused_ipm_kernel<T, NX, NU, NBU, NBX, NHH, NS>
      <<<grid, kBlock, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated structures (nx, nu, nbu, nbx, nHh, nS)
#define NMPC_FLAGSHIP 8, 1, 1, 0, 0, 8  // usv_guidance_ca1
#define NMPC_HULL 14, 2, 2, 5, 4, 0     // usv_pf_ca
extern template int launch<float, NMPC_FLAGSHIP>(const FusedArgs<float>&,
                                                 cudaStream_t);
extern template int launch<double, NMPC_FLAGSHIP>(const FusedArgs<double>&,
                                                  cudaStream_t);
extern template int launch<float, NMPC_HULL>(const FusedArgs<float>&,
                                             cudaStream_t);
extern template int launch<double, NMPC_HULL>(const FusedArgs<double>&,
                                              cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
