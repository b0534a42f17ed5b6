// C entries of the lane-batched Riccati LQR sweep (K1) for sm_90a.  The
// kernels, their design notes and the rule that picks one are in
// riccati_lanes.cuh; its instances are compiled in
// riccati_lanes_<nx>x<nu>_{float,double}.cu.

#include <cuda_runtime.h>

#include "riccati_lanes.cuh"

namespace {

using nmpc::k1::cta_lanes;
using nmpc::k1::launch;

template <typename T>
int dispatch(int design, int nx, int nu, const void* A, const void* B,
             const void* c, const void* Q, const void* S, const void* R,
             const void* qx, const void* qu, const void* dx0, void* dx,
             void* du, void* K, void* k, int N, int L, cudaStream_t stream) {
#define NMPC_K1_CASE(NX, NU)                                                \
  if (nx == NX && nu == NU)                                                 \
    return launch<T, NX, NU>(design, A, B, c, Q, S, R, qx, qu, dx0, dx, du, \
                             K, k, N, L, stream);
  NMPC_K1_SHAPES(NMPC_K1_CASE)
#undef NMPC_K1_CASE
  return -1;
}

int entry(int design, int is_double, int nx, int nu, int N, int L,
          const void* A, const void* B, const void* c, const void* Q,
          const void* S, const void* R, const void* qx, const void* qu,
          const void* dx0, void* dx, void* du, void* K, void* k,
          void* stream) {
  if (N < 1 || L < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return dispatch<double>(design, nx, nu, A, B, c, Q, S, R, qx, qu, dx0,
                            dx, du, K, k, N, L, st);
  return dispatch<float>(design, nx, nu, A, B, c, Q, S, R, qx, qu, dx0, dx,
                         du, K, k, N, L, st);
}

}  // namespace

// Launches the design the rule picks.  Returns cudaGetLastError() after
// the launch (0 = success; or the error of raising the kernel's
// shared-memory limit or of the rule's occupancy query), -1 for an
// (nx, nu) with no instance, -2 for an empty problem.
extern "C" int nmpc_riccati_lanes(int is_double, int nx, int nu, int N,
                                  int L, const void* A, const void* B,
                                  const void* c, const void* Q, const void* S,
                                  const void* R, const void* qx,
                                  const void* qu, const void* dx0, void* dx,
                                  void* du, void* K, void* k, void* stream) {
  return entry(nmpc::k1::kRule, is_double, nx, nu, N, L, A, B, c, Q, S, R,
               qx, qu, dx0, dx, du, K, k, stream);
}

// The same in the design given (0 the warp's, 1 the CTA's) whatever the
// rule would pick, for the tests and the timings that hold the two designs
// side by side; -3 for a design the instance has not.
extern "C" int nmpc_riccati_lanes_as(int design, int is_double, int nx,
                                     int nu, int N, int L, const void* A,
                                     const void* B, const void* c,
                                     const void* Q, const void* S,
                                     const void* R, const void* qx,
                                     const void* qu, const void* dx0,
                                     void* dx, void* du, void* K, void* k,
                                     void* stream) {
  if (design != nmpc::k1::kWarpDesign && design != nmpc::k1::kCtaDesign)
    return -3;
  return entry(design, is_double, nx, nu, N, L, A, B, c, Q, S, R, qx, qu,
               dx0, dx, du, K, k, stream);
}

// The most lanes the rule gives the CTA design on the current device (0
// for an instance without it) in *lanes.  Returns 0, a CUDA error, or -1
// for an (nx, nu) with no instance.
extern "C" int nmpc_riccati_lanes_cta_lanes(int is_double, int nx, int nu,
                                            int* lanes) {
#define NMPC_K1_CASE(NX, NU)                                        \
  if (nx == NX && nu == NU)                                         \
    return is_double ? cta_lanes<double, NX, NU>(lanes)             \
                     : cta_lanes<float, NX, NU>(lanes);
  NMPC_K1_SHAPES(NMPC_K1_CASE)
#undef NMPC_K1_CASE
  return -1;
}
