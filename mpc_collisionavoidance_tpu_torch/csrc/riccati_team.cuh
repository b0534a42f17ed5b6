// One lane's Riccati stage step, split across a team of threads: the
// building block of K1 (csrc/riccati_lanes.cu) and of the Newton step of
// K3, the fused IPM (csrc/ipm_lanes.cuh), with the cp.async helpers both
// use.
//
// A lane's team is one warp: ROWS row slots (8 for nx <= 8, 16 for
// nx <= 16) times SPLIT = 32 / ROWS column parts.  Thread t has row
// r = t % ROWS and part t / ROWS.  For its row (r < NX) it holds all of
// row r of P in registers and computes its part's columns of PA and of the
// new P: ~2 nx^2 / SPLIT FMAs per stage of the lane's ~2 nx^3.
// Every part of row r computes column r of Hux and K (part 0 keeps K);
// every thread computes the small per-lane values (Huu, hu, its Cholesky,
// k), which saves broadcasts.  Threads with r >= NX only take part in the
// syncs.  __syncwarp() orders the phases inside a stage.
//
// Every per-lane array lives in shared memory as a lane column of a block
// that holds G lanes: entry e of lane g at e * G + g, so one entry of the
// block's lanes is one contiguous copy.  Threads that read one entry get
// it as a broadcast, and threads that read column r of a matrix for their
// own row r hit banks G apart.  Where they would read entry (r, j) for
// their own r, the matrix is stored transposed (Q in the backward tile, A
// and B in the forward tile), or its rows are padded to NX + 1 (PA and the
// new P), so those reads spread over the banks too.
//
// The math is the reference's (mpc_collisionavoidance_tpu/kernels/
// riccati_pallas.py `_kernel`), per lane:
//   PA = P A, PB = P B, Pc_p = P c + p
//   Huu = R + B'PB, Hux = S + B'PA, hu = qu + B'Pc_p
//   Huu = Lf Lf' (unrolled Cholesky), K = -Huu^-1 Hux, k = -Huu^-1 hu
//   P <- sym(Q + A'PA + Hux'K),  p <- qx + A'Pc_p + Hux'k
//   forward: du = K dx + k,  dx' = A dx + B du + c.

#pragma once

#include <cuda_runtime.h>

namespace nmpc {

__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return ::sqrt(a); }

// cp.async of BYTES (4, 8 or 16) from global to shared memory; when
// `valid` is false nothing is read and the destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's team, one warp: ROWS row slots times SPLIT column parts; part
// h owns the columns h * CW .. h * CW + CW - 1 of its row.
template <int NX>
struct Team {
  static_assert(NX <= 16, "a warp holds at most 16 rows of P");
  static constexpr int ROWS = NX <= 8 ? 8 : 16;
  static constexpr int SPLIT = 32 / ROWS;
  static constexpr int CW = (NX + SPLIT - 1) / SPLIT;
};

// Entries of one stage's backward tile, per lane: A, B, c, Q transposed
// (Q(i, j) at Qt + j * NX + i), S, R, qx, qu.
template <int NX, int NU>
struct BackTile {
  static constexpr int A = 0, B = A + NX * NX, c = B + NX * NU,
                       Qt = c + NX, S = Qt + NX * NX, R = S + NU * NX,
                       qx = R + NU * NU, qu = qx + NX, size = qu + NU;
};

// Entries of one stage's forward tile, per lane: A and B transposed
// (A(i, j) at At + j * NX + i, B(i, u) at Bt + u * NX + i), c, K, k.
template <int NX, int NU>
struct FwdTile {
  static constexpr int At = 0, Bt = At + NX * NX, c = Bt + NX * NU,
                       K = c + NX, k = K + NU * NX, size = k + NU;
};

// A team's scratch, per lane: PA and the new P with rows of RS entries,
// PB, P c + p, K.
template <int NX, int NU>
struct TeamScratch {
  static constexpr int RS = NX + 1;
  static constexpr int PA = 0, Pn = PA + NX * RS, PB = Pn + NX * RS,
                       Pcp = PB + NX * NU, K = Pcp + NX, size = K + NU * NX;
};

// entry e of a lane column in a block of G lanes
template <int G, typename T>
__device__ __forceinline__ T& at(T* col, int e) {
  return col[e * G];
}

// Huu = Lf Lf' (unrolled; nu <= 2 in the models) and x <- -Huu^-1 x.  The
// diagonal's reciprocals are taken once and the solves multiply by them:
// the divisions sat on every stage's dependent chain.
template <typename T, int NU>
struct Chol {
  T Lf[NU][NU], inv[NU];

  __device__ __forceinline__ explicit Chol(const T (&H)[NU][NU]) {
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int cc = 0; cc <= r; ++cc) {
        T acc = H[r][cc];
#pragma unroll
        for (int t = 0; t < cc; ++t) acc -= Lf[r][t] * Lf[cc][t];
        if (r == cc) {
          Lf[r][r] = root(acc);
          inv[r] = T(1) / Lf[r][r];
        } else {
          Lf[r][cc] = acc * inv[cc];
        }
      }
  }

  __device__ __forceinline__ void solve_neg(T (&x)[NU]) const {
    T y[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T acc = -x[r];
#pragma unroll
      for (int t = 0; t < r; ++t) acc -= Lf[r][t] * y[t];
      y[r] = acc * inv[r];
    }
#pragma unroll
    for (int r = NU - 1; r >= 0; --r) {
      T acc = y[r];
#pragma unroll
      for (int t = r + 1; t < NU; ++t) acc -= Lf[t][r] * x[t];
      x[r] = acc * inv[r];
    }
  }
};

// Backward step of one stage for one lane, by thread t of its team (row
// r = t % ROWS).  `tile` is the stage's BackTile and `scr` the team's
// TeamScratch (lane columns).  On entry Pi holds row r of P (r < NX) and,
// in the last part (which computes P c + p), pi entry r of p; on exit the
// next ones, Kt column r of K (r < NX) and kff all of k.
template <typename T, int NX, int NU, int G>
__device__ __forceinline__ void backward_stage(int t, const T* tile, T* scr,
                                               T (&Pi)[NX], T& pi,
                                               T (&Kt)[NU], T (&kff)[NU]) {
  using BT = BackTile<NX, NU>;
  using TS = TeamScratch<NX, NU>;
  using TM = Team<NX>;
  constexpr int RS = TS::RS, CW = TM::CW;
  const int r = t % TM::ROWS, part = t / TM::ROWS, j0 = part * CW;
  const bool row = r < NX;

  // row r of PA (this part's columns), PB (part 0), Pc_p (the last part)
  if (row) {
    T acc[CW];
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) acc[jj] = T(0);
#pragma unroll
    for (int k = 0; k < NX; ++k)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj)
        if (j0 + jj < NX)
          acc[jj] += Pi[k] * at<G>(tile, BT::A + k * NX + j0 + jj);
#pragma unroll
    for (int jj = 0; jj < CW; ++jj)
      if (j0 + jj < NX) at<G>(scr, TS::PA + r * RS + j0 + jj) = acc[jj];
    if (part == 0) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        T a = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k)
          a += Pi[k] * at<G>(tile, BT::B + k * NU + u);
        at<G>(scr, TS::PB + r * NU + u) = a;
      }
    }
    if (part == TM::SPLIT - 1) {
      T a = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) a += Pi[k] * at<G>(tile, BT::c + k);
      at<G>(scr, TS::Pcp + r) = a + pi;
    }
  }
  __syncwarp();

  // Huu, hu, the Cholesky and k in every thread; column r of Hux and K in
  // every part of row r (part 0 stores K)
  T H[NU][NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int v = 0; v < NU; ++v) {
      T a = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k)
        a += at<G>(tile, BT::B + k * NU + u) * at<G>(scr, TS::PB + k * NU + v);
      H[u][v] = at<G>(tile, BT::R + u * NU + v) + a;
    }
    T a = T(0);
#pragma unroll
    for (int k = 0; k < NX; ++k)
      a += at<G>(tile, BT::B + k * NU + u) * at<G>(scr, TS::Pcp + k);
    kff[u] = at<G>(tile, BT::qu + u) + a;
  }
  const Chol<T, NU> chol(H);
  chol.solve_neg(kff);
  T Hux[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) Hux[u] = T(0);
  if (row) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      T a = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k)
        a += at<G>(tile, BT::B + k * NU + u) * at<G>(scr, TS::PA + k * RS + r);
      Hux[u] = at<G>(tile, BT::S + u * NX + r) + a;
      Kt[u] = Hux[u];
    }
    chol.solve_neg(Kt);
    if (part == 0) {
#pragma unroll
      for (int u = 0; u < NU; ++u) at<G>(scr, TS::K + u * NX + r) = Kt[u];
    }
  }
  __syncwarp();

  // row r of Q + A'PA + Hux'K (this part's columns; column r of A in
  // registers), entry r of p (the last part)
  if (row) {
    T a[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) a[k] = at<G>(tile, BT::A + k * NX + r);
    T Pn[CW];
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) Pn[jj] = T(0);
#pragma unroll
    for (int k = 0; k < NX; ++k)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj)
        if (j0 + jj < NX)
          Pn[jj] += a[k] * at<G>(scr, TS::PA + k * RS + j0 + jj);
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) {
      const int j = j0 + jj;
      if (j < NX) {
        T hk = T(0);
#pragma unroll
        for (int u = 0; u < NU; ++u)
          hk += Hux[u] * at<G>(scr, TS::K + u * NX + j);
        at<G>(scr, TS::Pn + r * RS + j) =
            at<G>(tile, BT::Qt + j * NX + r) + Pn[jj] + hk;
      }
    }
    if (part == TM::SPLIT - 1) {
      T ac = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) ac += a[k] * at<G>(scr, TS::Pcp + k);
      T hkf = T(0);
#pragma unroll
      for (int u = 0; u < NU; ++u) hkf += Hux[u] * kff[u];
      pi = at<G>(tile, BT::qx + r) + ac + hkf;
    }
  }
  __syncwarp();

  // P <- 0.5 (Pn + Pn'), all of row r in every part
  if (row) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Pi[j] = T(0.5) * (at<G>(scr, TS::Pn + r * RS + j) +
                        at<G>(scr, TS::Pn + j * RS + r));
  }
}

// Forward step of one stage for one lane, by thread t of its warp (every
// thread must call it: the warp gathers dx by shuffles).  `x`
// is entry t of dx (t < NX); returns entry t of the next dx and sets du in
// every thread.
template <typename T, int NX, int NU, int G>
__device__ __forceinline__ T forward_stage(int t, const T* tile, T x,
                                           T (&du)[NU]) {
  using FT = FwdTile<NX, NU>;
  T xs[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) xs[j] = __shfl_sync(0xffffffffu, x, j);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    T a = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) a += at<G>(tile, FT::K + u * NX + j) * xs[j];
    du[u] = a + at<G>(tile, FT::k + u);
  }
  if (t >= NX) return T(0);
  T ax = T(0);
#pragma unroll
  for (int j = 0; j < NX; ++j) ax += at<G>(tile, FT::At + j * NX + t) * xs[j];
  T bu = T(0);
#pragma unroll
  for (int u = 0; u < NU; ++u) bu += at<G>(tile, FT::Bt + u * NX + t) * du[u];
  return ax + bu + at<G>(tile, FT::c + t);
}

}  // namespace nmpc
