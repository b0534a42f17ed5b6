// K1's design for few lanes: one CTA per lane, one matrix entry per thread.
// riccati_lanes.cuh launches it, and says when (its `launch`); the warp
// design there serves every other case.
//
// A lane's 2N stages are a dependent chain, but one backward stage is a few
// hundred independent dot products of length nx.  The warp design gives a
// lane 32 threads, so each walks ~2 nx / SPLIT of them in sequence; here a
// lane gets a whole CTA, THREADS = nx^2 + nx nu + nx rounded up to a warp
// (256 at (14, 2), 96 at (8, 1)), and a backward stage is three phases
// with a block barrier after each:
//   1. thread (i, j) computes entry (i, j) of PA = P A; the next nx nu
//      threads PB = P B, the next nx Pc_p = P c + p;
//   2. thread r < nx computes column r of Hux = S + B'PA and of
//      K = -Huu^-1 Hux, thread nx hu = qu + B'Pc_p and k = -Huu^-1 hu; each
//      of them forms Huu = R + B'PB and its unrolled Cholesky itself (Chol,
//      riccati_team.cuh: nu <= 2 only), as the warp team's threads do;
//   3. thread (i, j), i <= j, computes Pn(i, j) and Pn(j, i) of
//      Pn = Q + A'PA + Hux'K and stores 0.5 (Pn(i, j) + Pn(j, i)) at both
//      places, which saves the barrier a separate 0.5 (Pn + Pn') would
//      take; thread nx (nx + 1) / 2 + i entry i of p = qx + A'Pc_p + Hux'k;
//      the next nu nx + nu threads store K and k to the wrapper's global
//      scratch, as in the warp design.
// The math and its precision are the reference's, as in the warp design;
// only the order of a few sums differs.  P, p and the phases' outputs live
// in shared memory, row-major, one lane's each.  The forward rollout
// (du = K dx + k, dx' = A dx + B du + c: nx + nu dot products a stage)
// runs on warp 0 alone, with __syncwarp() between stages and dx gathered by
// shuffles; the other warps leave after the backward pass.
//
// Stage tiles: a ring of kRing backward tiles in shared memory, filled by
// cp.async kRing - 1 stages ahead of the math; the forward rollout reuses
// its bytes for FRING smaller tiles.  A lane's entries lie L apart, so at
// L = 1 every field of a stage is contiguous: it is copied in 16-byte
// pieces where its address and length allow, else in 8-byte pieces, else
// by element.  Each field starts on 16 bytes in the tile.  Which pieces a
// thread copies is worked out once per launch (Share).  In the backward
// pass the threads past warp 0 copy, and issue a stage's copies while warp
// 0 alone runs phase 2; warp 0 copies the forward tiles itself.  Copies
// and the math touch this lane alone, so a lane's result does not depend
// on the others.
//
// Registers: the Cholesky's square roots and reciprocals have slow paths
// that ptxas calls as subroutines, and with more values kept live through
// phase 2 some instances spilled (4-24 bytes at 56-80 registers, ptxas'
// report on the H100's build; chip_smoke.py's NO_SPILL wants 0 in every
// one).  So the backward pass keeps its copy pieces in shared memory and
// reads them back at each issue, and phase 2 stores nothing to global
// memory; the forward pass keeps its pieces in registers, which is faster
// and spills nothing.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "riccati_team.cuh"

namespace nmpc {
namespace k1 {
namespace cta {

constexpr int kRing = 4;  // backward tiles in the ring

// n entries of T rounded up to 16 bytes
template <typename T>
constexpr int pad(int n) {
  constexpr int V = 16 / sizeof(T);
  return (n + V - 1) / V * V;
}

template <typename T, int NX, int NU>
struct Shape {
  static constexpr int PH1 = NX * NX + NX * NU + NX;  // phase 1's entries
  static constexpr int TRI = NX * (NX + 1) / 2;       // P's upper triangle
  static constexpr int THREADS = (PH1 + kWarpSize - 1) / kWarpSize *
                                 kWarpSize;
  // a backward tile: A, B, c, Q, S, R, qx, qu (as stored, row-major)
  static constexpr int A = 0, B = A + pad<T>(NX * NX),
                       c = B + pad<T>(NX * NU), Q = c + pad<T>(NX),
                       S = Q + pad<T>(NX * NX), R = S + pad<T>(NU * NX),
                       qx = R + pad<T>(NU * NU), qu = qx + pad<T>(NX),
                       BACK = qu + pad<T>(NU);
  static constexpr int BACK_E = 2 * NX * NX + 2 * NX * NU + 2 * NX +
                                NU * NU + NU;  // entries copied
  // a forward tile: A, B, c, K, k
  static constexpr int fA = 0, fB = fA + pad<T>(NX * NX),
                       fc = fB + pad<T>(NX * NU), fK = fc + pad<T>(NX),
                       fk = fK + pad<T>(NU * NX), FWD = fk + pad<T>(NU);
  static constexpr int FWD_E = NX * NX + 2 * NX * NU + NX + NU;
  static constexpr int FRING = kRing * BACK / FWD;
  // the lane's state after the ring: P, p, PA, PB, Pc_p, Hux, K, k
  static constexpr int P = kRing * BACK, p = P + NX * NX, PA = p + NX,
                       PB = PA + NX * NX, Pcp = PB + NX * NU,
                       Hx = Pcp + NX, K = Hx + NU * NX, kf = K + NU * NX,
                       END = kf + NU;
  // each thread's pieces of a tile's copies (Piece): the backward tile's
  // BACK_P per copying thread (those from C0 on), the forward tile's FWD_P
  // per thread of warp 0, after the state
  static constexpr int C0 = THREADS > kWarpSize ? kWarpSize : 0;
  static constexpr int BACK_P = (BACK_E + THREADS - C0 - 1) / (THREADS - C0),
                       FWD_P = (FWD_E + kWarpSize - 1) / kWarpSize;
  static constexpr size_t DESC = (END * sizeof(T) + 15) / 16 * 16,
                          BYTES = DESC + 16 * size_t((THREADS - C0) * BACK_P) +
                                  16 * size_t(kWarpSize * FWD_P);
  static_assert(TRI + NX + NU * NX + NU <= THREADS && NX < THREADS,
                "phases 2 and 3 take at most phase 1's threads");
  static_assert(FRING >= 2, "the forward ring needs two tiles");
};

template <typename T, int NX, int NU>
constexpr size_t shared_bytes() {
  return Shape<T, NX, NU>::BYTES;
}

// One piece of a tile's copy: bytes() bytes at src + s step (stage s) to
// byte dst() of the tile; bytes() = 0: none
struct alignas(16) Piece {
  const char* src;
  unsigned step;
  int dst_bytes;  // dst | bytes << 16
  __device__ __forceinline__ int dst() const { return dst_bytes & 0xffff; }
  __device__ __forceinline__ int bytes() const { return dst_bytes >> 16; }
};

// One thread's share of a tile's copies, worked out once per launch: the
// tile's fields are cut into pieces (at L = 1 16 bytes where a field's
// address and length allow, else 8, else one element; one element L apart
// for L > 1), numbered across the fields, and piece g goes to thread
// g % NT as its piece g / NT (tid < 0: none), kept in shared memory
// (`area`, piece q of thread t at q NT + t) and read back at each issue;
// with KEEP, in registers too, and issued from there.
template <typename T, int NT, int P, bool KEEP = false>
struct Share {
  const Piece* mine;
  Piece own[KEEP ? P : 1];  // with KEEP, the pieces in registers as well

  // the F fields: lane l's entry 0 at stage 0 (`base`), entries per stage
  // (`E`), offset in the tile (`off`, entries)
  template <int F>
  __device__ __forceinline__ Share(Piece* area, const T* const (&base)[F],
                                   const int (&E)[F], const int (&off)[F],
                                   int L, int tid)
      : mine(area + tid) {
    if (tid < 0) return;  // a thread that copies nothing
    int width[F], count[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const unsigned b = E[f] * sizeof(T);
      const auto at = reinterpret_cast<std::uintptr_t>(base[f]) | b;
      width[f] = L > 1 ? int(sizeof(T))
                       : at % 16 == 0 ? 16 : at % 8 == 0 ? 8 : int(sizeof(T));
      count[f] = L > 1 ? E[f] : int(b) / width[f];
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      int g = tid + q * NT;
      Piece pc{nullptr, 0, 0};
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (g >= 0 && g < count[f]) {
          const size_t gap = L > 1 ? sizeof(T) * size_t(L) : width[f];
          pc.src = reinterpret_cast<const char*>(base[f]) + g * gap;
          pc.step = E[f] * sizeof(T) * unsigned(L);
          pc.dst_bytes = (off[f] * int(sizeof(T)) + g * width[f]) |
                         width[f] << 16;
        }
        g -= count[f];
      }
      area[q * NT + tid] = pc;
      if constexpr (KEEP) own[q] = pc;
    }
  }

  // stage s's pieces into `tile`
  __device__ __forceinline__ void issue(T* tile, int s) const {
    char* t = reinterpret_cast<char*>(tile);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const Piece pc = KEEP ? own[q] : mine[q * NT];
      const char* g = pc.src + static_cast<size_t>(s) * pc.step;
      if (pc.bytes() == 16)
        cp_async<16>(t + pc.dst(), g, true);
      else if (pc.bytes() == 8)
        cp_async<8>(t + pc.dst(), g, true);
      else if (pc.bytes() == 4)
        cp_async<4>(t + pc.dst(), g, true);
    }
  }
};

}  // namespace cta

// One lane per CTA (blockIdx.x), Shape::THREADS threads; arguments as the
// warp design's riccati_lanes_kernel.
template <typename T, int NX, int NU>
__global__ void __launch_bounds__(cta::Shape<T, NX, NU>::THREADS)
riccati_lanes_kernel_cta(const T* __restrict__ A, const T* __restrict__ B,
                         const T* __restrict__ c, const T* __restrict__ Q,
                         const T* __restrict__ S, const T* __restrict__ R,
                         const T* __restrict__ qx, const T* __restrict__ qu,
                         const T* __restrict__ dx0, T* __restrict__ dx,
                         T* __restrict__ du, T* Ks, T* ks, int N, int L) {
  using SH = cta::Shape<T, NX, NU>;
  constexpr int NT = SH::THREADS, RING = cta::kRing, FRING = SH::FRING;
  static_assert(NU <= 2, "Huu and its factor in every thread's registers");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, l = blockIdx.x;
  const size_t Ls = L;
  // entry (i, j) of stage s of an (., m, n, L) tensor, this lane
  auto idx = [=](int s, int i, int j, int m, int n) -> size_t {
    return ((static_cast<size_t>(s) * m + i) * n + j) * Ls + l;
  };

  // phase 3's entry (i3, j3) of P's upper triangle, row by row; past it,
  // entry i3 of p
  int i3 = 0, j3 = tid;
  while (i3 < NX && j3 >= NX - i3) {
    j3 -= NX - i3;
    ++i3;
  }
  if (i3 < NX)
    j3 += i3;
  else
    i3 = j3;

  // P = Q_N, p = qx_N
  if (tid < NX * NX)
    sm[SH::P + tid] = Q[idx(N, tid / NX, tid % NX, NX, NX)];
  else if (tid < NX * NX + NX)
    sm[SH::p + tid - NX * NX] = qx[idx(N, tid - NX * NX, 0, NX, 1)];

  // backward: step n works on stage N-1-n in ring slot n % RING
  // The threads past warp 0 (all, in a one-warp CTA) copy the tiles, and
  // issue them while warp 0 alone runs phase 2
  constexpr int C0 = SH::C0, NC = NT - C0;
  cta::Piece* desc = reinterpret_cast<cta::Piece*>(smem + SH::DESC);
  const cta::Share<T, NC, SH::BACK_P> back(
      desc, {A + l, B + l, c + l, Q + l, S + l, R + l, qx + l, qu + l},
      {NX * NX, NX * NU, NX, NX * NX, NU * NX, NU * NU, NX, NU},
      {SH::A, SH::B, SH::c, SH::Q, SH::S, SH::R, SH::qx, SH::qu}, L,
      tid >= C0 ? tid - C0 : -NC * SH::BACK_P);
#pragma unroll
  for (int n = 0; n < RING - 1; ++n) {
    if (n < N && tid >= C0) back.issue(sm + n * SH::BACK, N - 1 - n);
    cp_async_commit();
  }
  for (int n = 0; n < N; ++n) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // tile n landed; P and p of the stage before written
    const T* tile = sm + (n % RING) * SH::BACK;
    const int s = N - 1 - n;

    // 1. PA, PB, Pc_p: row i of P times column `col` of A, B or c
    if (tid < SH::PH1) {
      int i, col, ld, out;
      const T* m;
      T add = T(0);
      if (tid < NX * NX) {
        i = tid / NX, col = tid % NX, ld = NX, m = tile + SH::A;
        out = SH::PA + tid;
      } else if (tid < NX * NX + NX * NU) {
        const int e = tid - NX * NX;
        i = e / NU, col = e % NU, ld = NU, m = tile + SH::B;
        out = SH::PB + e;
      } else {
        i = tid - NX * NX - NX * NU, col = 0, ld = 1, m = tile + SH::c;
        out = SH::Pcp + i;
        add = sm[SH::p + i];
      }
      T a = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k)
        a += sm[SH::P + i * NX + k] * m[k * ld + col];
      sm[out] = a + add;
    }
    __syncthreads();

    // 2. Huu and its factor in each of threads 0 .. nx; column r of Hux
    // and K, or k.  Meanwhile the copy threads issue stage n+RING-1's tile
    // into the slot stage n-1 used.
    const int ahead = n + RING - 1;
    if (ahead < N && tid >= C0)
      back.issue(sm + (ahead % RING) * SH::BACK, N - 1 - ahead);
    cp_async_commit();
    if (tid <= NX) {
      T H[NU][NU];
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int v = 0; v < NU; ++v) {
          T a = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k)
            a += tile[SH::B + k * NU + u] * sm[SH::PB + k * NU + v];
          H[u][v] = tile[SH::R + u * NU + v] + a;
        }
      const Chol<T, NU> chol(H);
      T x[NU];
      if (tid < NX) {
        const int r = tid;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          T a = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k)
            a += tile[SH::B + k * NU + u] * sm[SH::PA + k * NX + r];
          x[u] = tile[SH::S + u * NX + r] + a;
          sm[SH::Hx + u * NX + r] = x[u];
        }
        chol.solve_neg(x);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          sm[SH::K + u * NX + r] = x[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          T a = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k)
            a += tile[SH::B + k * NU + u] * sm[SH::Pcp + k];
          x[u] = tile[SH::qu + u] + a;
        }
        chol.solve_neg(x);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          sm[SH::kf + u] = x[u];
        }
      }
    }
    __syncthreads();

    // 3. P <- sym(Q + A'PA + Hux'K) on the upper triangle, both places;
    // p <- qx + A'Pc_p + Hux'k
    if (tid < SH::TRI) {
      const int i = i3, j = j3;
      T a = T(0), b = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        a += tile[SH::A + k * NX + i] * sm[SH::PA + k * NX + j];
        b += tile[SH::A + k * NX + j] * sm[SH::PA + k * NX + i];
      }
      T ha = T(0), hb = T(0);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        ha += sm[SH::Hx + u * NX + i] * sm[SH::K + u * NX + j];
        hb += sm[SH::Hx + u * NX + j] * sm[SH::K + u * NX + i];
      }
      const T v = T(0.5) * ((tile[SH::Q + i * NX + j] + a + ha) +
                            (tile[SH::Q + j * NX + i] + b + hb));
      sm[SH::P + i * NX + j] = v;
      sm[SH::P + j * NX + i] = v;
    } else if (tid < SH::TRI + NX) {
      const int i = i3;
      T a = T(0), h = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k)
        a += tile[SH::A + k * NX + i] * sm[SH::Pcp + k];
#pragma unroll
      for (int u = 0; u < NU; ++u)
        h += sm[SH::Hx + u * NX + i] * sm[SH::kf + u];
      sm[SH::p + i] = tile[SH::qx + i] + a + h;
    } else if (tid < SH::TRI + NX + NU * NX) {
      const int e = tid - SH::TRI - NX;  // K(u, r) to the scratch
      Ks[idx(s, e / NX, e % NX, NU, NX)] = sm[SH::K + e];
    } else if (tid < SH::TRI + NX + NU * NX + NU) {
      const int u = tid - SH::TRI - NX - NU * NX;
      ks[idx(s, u, 0, NU, 1)] = sm[SH::kf + u];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last stage done with the ring; K and k written
  if (tid >= kWarpSize) return;

  // forward, warp 0: stage n in ring slot n % FRING; thread t < nx holds
  // entry t of dx
  const int t = tid;
  T x = t < NX ? dx0[idx(0, t, 0, 1, 1)] : T(0);
  const cta::Share<T, kWarpSize, SH::FWD_P, true> fwd(
      desc + NC * SH::BACK_P, {A + l, B + l, c + l, Ks + l, ks + l},
      {NX * NX, NX * NU, NX, NU * NX, NU},
      {SH::fA, SH::fB, SH::fc, SH::fK, SH::fk}, L, t);
#pragma unroll
  for (int n = 0; n < FRING - 1; ++n) {
    if (n < N) fwd.issue(sm + n * SH::FWD, n);
    cp_async_commit();
  }
  for (int n = 0; n < N; ++n) {
    cp_async_wait<FRING - 2>();
    __syncwarp();  // tile n landed; every thread done with tile n-1
    const int ahead = n + FRING - 1;
    if (ahead < N) fwd.issue(sm + (ahead % FRING) * SH::FWD, ahead);
    cp_async_commit();
    const T* tile = sm + (n % FRING) * SH::FWD;
    if (t < NX) dx[idx(n, t, 0, NX, 1)] = x;
    T xs[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) xs[j] = __shfl_sync(0xffffffffu, x, j);
    T u[NU];
#pragma unroll
    for (int v = 0; v < NU; ++v) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) a += tile[SH::fK + v * NX + j] * xs[j];
      u[v] = a + tile[SH::fk + v];
    }
    if (t == 0) {
#pragma unroll
      for (int v = 0; v < NU; ++v) du[idx(n, v, 0, NU, 1)] = u[v];
    }
    if (t < NX) {
      T ax = T(0), bu = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) ax += tile[SH::fA + t * NX + j] * xs[j];
#pragma unroll
      for (int v = 0; v < NU; ++v) bu += tile[SH::fB + t * NU + v] * u[v];
      x = ax + bu + tile[SH::fc + t];
    }
  }
  if (t < NX) dx[idx(N, t, 0, NX, 1)] = x;
}

}  // namespace k1
}  // namespace nmpc
