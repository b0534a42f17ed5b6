// CUDA form of the 10-state guidance model usv_guidance (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_guidance;
// reference scripts/usv_guidance/usv_model.py:60-115).
//
// x = (nedx, nedy, psi, sinpsi, cospsi, u, v, ye, ak, psid), U = psiddot;
// a first-order heading response psi' = (psid - psi) / T1, T1 = 1.0.  No
// parameters (the kernel passes its size-1 dummy) and no constraint rows.
// f is a template over the scalar type S (float, double or a Dual of
// either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidance {
  static constexpr int NX = 10, NU = 1, NP = 0, NH = 0;
  static constexpr int N_FDEP = 6;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {2, 5, 6, 8, 9, 10};
    return t[j];
  }

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[2];
    S xned_dot, yned_dot;
    Guidance::ned_rates(x[5], x[6], psi, xned_dot, yned_dot);
    const S psi_rate = (x[9] - psi) / T(1.0);  // T1 = 1.0
    xdot[0] = xned_dot;
    xdot[1] = yned_dot;
    xdot[2] = psi_rate;
    xdot[3] = m_cos(psi) * psi_rate;
    xdot[4] = -m_sin(psi) * psi_rate;
    xdot[5] = S(T(0));
    xdot[6] = S(T(0));
    xdot[7] = Guidance::cross_track_rate(xned_dot, yned_dot, x[8]);
    xdot[8] = S(T(0));
    xdot[9] = uc[0];
  }
};

}  // namespace nmpc
