// CUDA form of the 5-state error-kinematics model usv_guidance5 (the torch
// form is mpc_collisionavoidance_tpu_torch/models/variants.py::
// usv_guidance5; reference scripts/usv_guidance5/usv_model.py).
//
// x = (u, v, ye, chie, psied), U = psieddot: usv_guidance4 with the
// desired heading error a rate-limited state, chie' = (psied - psie) / T1,
// T1 = 1.0.  No parameters (the kernel passes its size-1 dummy) and no
// constraint rows.  f is a template over the scalar type S (float, double
// or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/guidance.cuh"

namespace nmpc {

struct UsvGuidance5 {
  static constexpr int NX = 5, NU = 1, NP = 0, NH = 0;
  static constexpr int N_FDEP = 5;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 1, 3, 4, 5};
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
    xdot[3] = (x[4] - psie) / T(1.0);  // T1 = 1.0
    xdot[4] = uc[0];
  }
};

}  // namespace nmpc
