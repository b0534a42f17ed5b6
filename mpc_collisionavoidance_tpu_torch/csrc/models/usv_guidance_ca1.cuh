// CUDA form of the flagship model usv_guidance_ca1 (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_guidance_ca1;
// reference scripts/usv_guidance_ca1/usv_model.py:117-140).
//
// x = (u, v, ye, chie, psied, xned, yned, psi), U = psied_dot,
// p = (ox1, oy1, ..., ox8, oy8).  f and h are templates over the scalar
// type S (float, double or a Dual of either), built only from the
// operators and m_* functions of dual.cuh and the shared kinematics of
// guidance.cuh.  The crab angle uses the native atan2.
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidanceCa1 {
  static constexpr int NX = 8, NU = 1, NP = 16, NH = 8;
  // coordinates of (x, u) that f reads, and of x that h reads
  static constexpr int N_FDEP = 6, N_HDEP = 2;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 1, 3, 4, 7, 8};
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
    xdot[4] = u[0];
    Guidance::ned_rates(x[0], x[1], x[7], xdot[5], xdot[6]);
    xdot[7] = psie_rate;
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
