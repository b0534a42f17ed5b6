// C entry of the lane-batched Riccati LQR sweep (K1) for sm_90a.  The
// kernel and its design notes are in riccati_lanes.cuh; its instances are
// compiled in riccati_lanes_<nx>x<nu>_{float,double}.cu.

#include <cuda_runtime.h>

#include "riccati_lanes.cuh"

namespace {

using nmpc::k1::launch;

template <typename T>
int dispatch(int nx, int nu, const void* A, const void* B, const void* c,
             const void* Q, const void* S, const void* R, const void* qx,
             const void* qu, const void* dx0, void* dx, void* du, void* K,
             void* k, int N, int L, cudaStream_t stream) {
#define NMPC_K1_CASE(NX, NU)                                             \
  if (nx == NX && nu == NU)                                              \
    return launch<T, NX, NU>(A, B, c, Q, S, R, qx, qu, dx0, dx, du, K, k, \
                             N, L, stream);
  NMPC_K1_SHAPES(NMPC_K1_CASE)
#undef NMPC_K1_CASE
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success; or the error
// of raising the kernel's shared-memory limit), -1 for an (nx, nu) with no
// instance, -2 for an empty problem.
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
