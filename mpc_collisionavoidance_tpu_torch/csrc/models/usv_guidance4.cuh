// CUDA form of the 4-state error-kinematics model usv_guidance4 (the torch
// form is mpc_collisionavoidance_tpu_torch/models/variants.py::
// usv_guidance4; reference scripts/usv_guidance4/usv_model.py).
//
// x = (u, v, ye, chie), U = psied, the desired heading error itself:
// chie' = (psied - psie) / T1, T1 = 0.2, psie = chie - beta (native
// atan2).  No parameters (the kernel passes its size-1 dummy), no
// constraint rows and no state box.  f is a template over the scalar type
// S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidance4 {
  static constexpr int NX = 4, NU = 1, NP = 0, NH = 0;
  static constexpr int N_FDEP = 4;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 1, 3, 4};
    return t[j];
  }

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S psie = x[3] - Guidance::crab(x[0], x[1]);
    xdot[0] = S(T(0));
    xdot[1] = S(T(0));
    xdot[2] = x[0] * m_sin(psie) + x[1] * m_cos(psie);
    xdot[3] = (uc[0] - psie) / T(0.2);  // T1 = 0.2
  }
};

}  // namespace nmpc
