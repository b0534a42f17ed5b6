// Lane-batched Riccati LQR sweep (K1) for sm_90a.
//
// Replaces mpc_collisionavoidance_tpu/kernels/riccati_pallas.py:
// lqr_solve_lanes_pallas (body `_kernel`).  Same math, per lane:
//   backward, from P = Q_N, p = qx_N, for s = N-1 .. 0:
//     PA = P A, PB = P B, Pc_p = P c + p
//     Huu = R + B'PB, Hux = S + B'PA, hu = qu + B'Pc_p
//     Huu = L L' (unrolled Cholesky), K = -Huu^-1 Hux, k = -Huu^-1 hu
//     P <- sym(Q + A'PA + Hux'K),  p <- qx + A'Pc_p + Hux'k
//   forward, from dx0:  du = K dx + k,  dx' = A dx + B du + c.
// The symmetrization 0.5 (P + P') and the Cholesky are the reference's,
// so float64 results agree with the plain sweep to round-off.
//
// Layout: every tensor is (stage, rows, cols, L) with the lane axis L
// minor-most, so the 32 threads of a warp (32 neighbouring lanes) read 32
// neighbouring addresses of each matrix entry.
//
// Design: one thread per lane; the stage loop runs inside the thread (it
// takes the place of the TPU kernel's sequential fori_loop).  P and p live
// in registers (local memory where they spill); K and k go to a global
// scratch the wrapper allocates, and are read back by the same thread in
// the forward pass.  Lanes are bounds-masked: no edge padding.
//
// What bounds it on the H100: not arithmetic (~2.5 kFLOP per lane and stage
// at nx=8) and not bandwidth (the flagship LQR is ~33 MB in float32 at
// L=512, read once from HBM; the forward pass re-reads A, B, c from L2)
// but latency and occupancy.  At L=512 only 16 blocks of 32 threads exist,
// so 16 of the 132
// SMs hold one warp each, and each warp walks 100 dependent stages.
// Register pressure: P, PA and their temporaries are ~2 nx^2 values per
// thread (~600 32-bit registers for nx=14, or float64 at nx=8), above the
// 255-register cap, so those instances spill to local memory (L1-cached).
// Both are accepted for bring-up; a later PR can split a lane's matrix
// work across a warp or a cluster, and batch more lanes per SM.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 32;  // one warp per block: spread lanes over SMs

__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return ::sqrt(a); }

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kBlock)
riccati_lanes_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ c, const T* __restrict__ Q,
                     const T* __restrict__ S, const T* __restrict__ R,
                     const T* __restrict__ qx, const T* __restrict__ qu,
                     const T* __restrict__ dx0, T* __restrict__ dx,
                     T* __restrict__ du, T* __restrict__ Ks,
                     T* __restrict__ ks, int N, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  // entry (i, j) of stage s of an (N, m, n, L) tensor
  auto at = [=](int s, int i, int j, int m, int n) -> size_t {
    return ((static_cast<size_t>(s) * m + i) * n + j) * L + l;
  };

  T P[NX][NX], p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = Q[at(N, i, j, NX, NX)];
    p[i] = qx[at(N, i, 0, NX, 1)];
  }

  for (int s = N - 1; s >= 0; --s) {
    T Bs[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int u = 0; u < NU; ++u) Bs[i][u] = B[at(s, i, u, NX, NU)];

    // PA = P A, one column of A at a time
    T PA[NX][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T a[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) a[k] = A[at(s, k, j, NX, NX)];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc += P[i][k] * a[k];
        PA[i][j] = acc;
      }
    }
    T PB[NX][NU], Pc_p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc += P[i][k] * Bs[k][u];
        PB[i][u] = acc;
      }
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += P[i][k] * c[at(s, k, 0, NX, 1)];
      Pc_p[i] = acc + p[i];
    }

    T Huu[NU][NU], Hux[NU][NX], hu[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int v = 0; v < NU; ++v) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc += Bs[k][u] * PB[k][v];
        Huu[u][v] = R[at(s, u, v, NU, NU)] + acc;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc += Bs[k][u] * PA[k][j];
        Hux[u][j] = S[at(s, u, j, NU, NX)] + acc;
      }
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += Bs[k][u] * Pc_p[k];
      hu[u] = qu[at(s, u, 0, NU, 1)] + acc;
    }

    // unrolled Cholesky Huu = Lf Lf' (nu <= 2)
    T Lf[NU][NU];
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int cc = 0; cc <= r; ++cc) {
        T acc = Huu[r][cc];
#pragma unroll
        for (int t = 0; t < cc; ++t) acc -= Lf[r][t] * Lf[cc][t];
        Lf[r][cc] = (r == cc) ? root(acc) : acc / Lf[cc][cc];
      }
    // x = -(Lf Lf')^-1 rhs, in place
    auto solve_neg = [&](T (&x)[NU]) {
      T y[NU];
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        T acc = -x[r];
#pragma unroll
        for (int t = 0; t < r; ++t) acc -= Lf[r][t] * y[t];
        y[r] = acc / Lf[r][r];
      }
#pragma unroll
      for (int r = NU - 1; r >= 0; --r) {
        T acc = y[r];
#pragma unroll
        for (int t = r + 1; t < NU; ++t) acc -= Lf[t][r] * x[t];
        x[r] = acc / Lf[r][r];
      }
    };
    T K[NU][NX], kff[NU];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T col[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) col[u] = Hux[u][j];
      solve_neg(col);
#pragma unroll
      for (int u = 0; u < NU; ++u) K[u][j] = col[u];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) kff[u] = hu[u];
    solve_neg(kff);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Ks[at(s, u, j, NU, NX)] = K[u][j];
      ks[at(s, u, 0, NU, 1)] = kff[u];
    }

    // P <- Q + A'PA + Hux'K, p <- qx + A'Pc_p + Hux'k (row i uses column
    // i of A); P is dead once PA, PB and Pc_p exist, so it is overwritten
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) a[k] = A[at(s, k, i, NX, NX)];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T apa = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) apa += a[k] * PA[k][j];
        T hk = T(0);
#pragma unroll
        for (int u = 0; u < NU; ++u) hk += Hux[u][i] * K[u][j];
        P[i][j] = Q[at(s, i, j, NX, NX)] + apa + hk;
      }
      T ac = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) ac += a[k] * Pc_p[k];
      T hkf = T(0);
#pragma unroll
      for (int u = 0; u < NU; ++u) hkf += Hux[u][i] * kff[u];
      p[i] = qx[at(s, i, 0, NX, 1)] + ac + hkf;
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

  // forward rollout
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = dx0[at(0, i, 0, 1, 1)];
  for (int s = 0; s < N; ++s) {
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[at(s, i, 0, NX, 1)] = x[i];
    T uu[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Ks[at(s, u, j, NU, NX)] * x[j];
      uu[u] = acc + ks[at(s, u, 0, NU, 1)];
      du[at(s, u, 0, NU, 1)] = uu[u];
    }
    T xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T ax = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) ax += A[at(s, i, j, NX, NX)] * x[j];
      T bu = T(0);
#pragma unroll
      for (int u = 0; u < NU; ++u) bu += B[at(s, i, u, NX, NU)] * uu[u];
      xn[i] = ax + bu + c[at(s, i, 0, NX, 1)];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[at(N, i, 0, NX, 1)] = x[i];
}

template <typename T, int NX, int NU>
int launch(const void* A, const void* B, const void* c, const void* Q,
           const void* S, const void* R, const void* qx, const void* qu,
           const void* dx0, void* dx, void* du, void* K, void* k, int N,
           int L, cudaStream_t stream) {
  const int grid = (L + kBlock - 1) / kBlock;
  riccati_lanes_kernel<T, NX, NU><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(c), static_cast<const T*>(Q),
      static_cast<const T*>(S), static_cast<const T*>(R),
      static_cast<const T*>(qx), static_cast<const T*>(qu),
      static_cast<const T*>(dx0), static_cast<T*>(dx), static_cast<T*>(du),
      static_cast<T*>(K), static_cast<T*>(k), N, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int nx, int nu, const void* A, const void* B, const void* c,
             const void* Q, const void* S, const void* R, const void* qx,
             const void* qu, const void* dx0, void* dx, void* du, void* K,
             void* k, int N, int L, cudaStream_t stream) {
  if (nx == 8 && nu == 1)
    return launch<T, 8, 1>(A, B, c, Q, S, R, qx, qu, dx0, dx, du, K, k, N,
                           L, stream);
  if (nx == 14 && nu == 2)
    return launch<T, 14, 2>(A, B, c, Q, S, R, qx, qu, dx0, dx, du, K, k, N,
                            L, stream);
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success), -1 for an
// (nx, nu) with no instance, -2 for an empty problem.
extern "C" int nmpc_riccati_lanes(int is_double, int nx, int nu, int N,
                                  int L, const void* A, const void* B,
                                  const void* c, const void* Q, const void* S,
                                  const void* R, const void* qx,
                                  const void* qu, const void* dx0, void* dx,
                                  void* du, void* K, void* k, void* stream) {
  if (N < 1 || L < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return dispatch<double>(nx, nu, A, B, c, Q, S, R, qx, qu, dx0, dx, du, K,
                            k, N, L, st);
  return dispatch<float>(nx, nu, A, B, c, Q, S, R, qx, qu, dx0, dx, du, K, k,
                         N, L, st);
}
