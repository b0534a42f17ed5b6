// CUDA form of the hard-row guidance model usv_guidance_ca (the torch form
// is mpc_collisionavoidance_tpu_torch/models/variants.py::usv_guidance_ca;
// reference scripts/usv_guidance_ca/usv_model.py).
//
// x = (u, v, ye, chie, psied, xned, yned, psi, psieddot),
// U = psieddotdot, p = (ox1, oy1, ..., ox8, oy8); T1 = 1.0.  The flagship's
// kinematics one derivative up (psied is driven by the state psieddot),
// with its 8 obstacle-distance rows, here hard.  f and h are templates over
// the scalar type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidanceCa {
  static constexpr int NX = 9, NU = 1, NP = 16, NH = 8;
  static constexpr int N_FDEP = 7, N_HDEP = 2;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 1, 3, 4, 7, 8, 9};
    return t[j];
  }
  __host__ __device__ static constexpr int h_dep(int j) {
    const int t[N_HDEP] = {5, 6};
    return t[j];
  }

  // continuous dynamics xdot = f(x, u, p) (f reads no parameter)
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&u)[NU],
                                           const scalar_t<S> (&)[NP],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S psie = x[3] - Guidance::crab(x[0], x[1]);
    const S psie_rate = (x[4] - psie) / T(1.0);  // T1 = 1.0
    xdot[0] = S(T(0));
    xdot[1] = S(T(0));
    S se, ce;
    m_sincos(psie, se, ce);
    xdot[2] = x[0] * se + x[1] * ce;
    xdot[3] = psie_rate;
    xdot[4] = x[8];
    Guidance::ned_rates(x[0], x[1], x[7], xdot[5], xdot[6]);
    xdot[7] = psie_rate;
    xdot[8] = u[0];
  }

  // obstacle distances h(x, p)
  template <typename S>
  __device__ __forceinline__ static void h(const S (&x)[NX],
                                           const scalar_t<S> (&p)[NP],
                                           S (&out)[NH]) {
    Guidance::obstacle_distances<NH>(x[5], x[6], p, out);
  }
};

}  // namespace nmpc
