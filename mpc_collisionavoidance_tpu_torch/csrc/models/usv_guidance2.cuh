// CUDA form of the 12-state guidance model usv_guidance2 (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_guidance2;
// reference scripts/usv_guidance2/usv_model.py).
//
// x = (nedx, nedy, psi, sinpsi, cospsi, u, v, r, ye, ak, psid, rd),
// U = rddot; a yaw-rate loop r' = (rd - r) / T1, T1 = 0.4.  No parameters
// (the kernel passes its size-1 dummy) and no constraint rows.  f is a
// template over the scalar type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidance2 {
  static constexpr int NX = 12, NU = 1, NP = 0, NH = 0;
  static constexpr int N_FDEP = 7;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {2, 5, 6, 7, 9, 11, 12};
    return t[j];
  }

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[2];
    const S& r = x[7];
    S sp, cp, xned_dot, yned_dot;
    m_sincos(psi, sp, cp);
    Guidance::ned_rates(x[5], x[6], sp, cp, xned_dot, yned_dot);
    xdot[0] = xned_dot;
    xdot[1] = yned_dot;
    xdot[2] = r;
    xdot[3] = cp * r;
    xdot[4] = -sp * r;
    xdot[5] = S(T(0));
    xdot[6] = S(T(0));
    xdot[7] = (x[11] - r) / T(0.4);  // T1 = 0.4
    xdot[8] = Guidance::cross_track_rate(xned_dot, yned_dot, x[9]);
    xdot[9] = S(T(0));
    xdot[10] = x[11];
    xdot[11] = uc[0];
  }
};

}  // namespace nmpc
