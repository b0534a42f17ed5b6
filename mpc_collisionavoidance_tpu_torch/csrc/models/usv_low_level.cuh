// CUDA form of the 8-state inner-loop model usv_low_level (the torch form
// is mpc_collisionavoidance_tpu_torch/models/variants.py::usv_low_level
// with models/hydro.py; reference scripts/usv_low_level/usv_model.py).
//
// x = (psi, sinpsi, cospsi, u, v, r, Tport, Tstbd), U = (UTportdot,
// UTstbddot); c = 0.78, and Tstbd integrates UTstbddot / c.  No parameters
// (the kernel passes its size-1 dummy) and no constraint rows.  f is a
// template over the scalar type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/hydro.cuh"

namespace nmpc {

struct UsvLowLevel {
  static constexpr int NX = 8, NU = 2, NP = 0, NH = 0;
  static constexpr int N_FDEP = 8;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 3, 4, 5, 6, 7, 8, 9};
    return t[j];
  }
  static constexpr double C_THRUST = 0.78;

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[0];
    const S& r = x[5];
    S tu, tr;
    Hydro::thrust_map(x[6], x[7], C_THRUST, tu, tr);
    Hydro::uvr_dot(x[3], x[4], r, tu, tr, xdot[3], xdot[4], xdot[5]);
    xdot[0] = r;
    S sp, cp;
    m_sincos(psi, sp, cp);
    xdot[1] = cp * r;
    xdot[2] = -sp * r;
    xdot[6] = uc[0];
    xdot[7] = uc[1] / T(C_THRUST);
  }
};

}  // namespace nmpc
