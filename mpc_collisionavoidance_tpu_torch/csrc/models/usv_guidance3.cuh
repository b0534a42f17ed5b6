// CUDA form of the 11-state guidance model usv_guidance3 (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_guidance3;
// reference scripts/usv_guidance3/usv_model.py).
//
// x = (nedx, nedy, psi, sinpsi, cospsi, u, v, r, ye, ak, rd), U = rddot;
// the (sin, cos) embedding rotates with the course angle chi = psi + beta,
// beta the crab angle (native atan2); r' = (rd - r) / T1, T1 = 1.0.  No
// parameters (the kernel passes its size-1 dummy) and no constraint rows.
// f is a template over the scalar type S (float, double or a Dual of
// either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidance3 {
  static constexpr int NX = 11, NU = 1, NP = 0, NH = 0;
  static constexpr int N_FDEP = 7;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {2, 5, 6, 7, 9, 10, 11};
    return t[j];
  }

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[2];
    const S& r = x[7];
    const S chi = psi + Guidance::crab(x[5], x[6]);
    S xned_dot, yned_dot;
    Guidance::ned_rates(x[5], x[6], psi, xned_dot, yned_dot);
    xdot[0] = xned_dot;
    xdot[1] = yned_dot;
    xdot[2] = r;
    S sc, cc;
    m_sincos(chi, sc, cc);
    xdot[3] = cc * r;
    xdot[4] = -sc * r;
    xdot[5] = S(T(0));
    xdot[6] = S(T(0));
    xdot[7] = (x[10] - r) / T(1.0);  // T1 = 1.0
    xdot[8] = Guidance::cross_track_rate(xned_dot, yned_dot, x[9]);
    xdot[9] = S(T(0));
    xdot[10] = uc[0];
  }
};

}  // namespace nmpc
