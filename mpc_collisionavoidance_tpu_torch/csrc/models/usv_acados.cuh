// CUDA form of the 5-state velocity/thrust model usv_acados (the torch form
// is mpc_collisionavoidance_tpu_torch/models/variants.py::usv_acados with
// models/hydro.py; reference scripts/usv_acados/usv_model.py).
//
// x = (u, v, r, Tport, Tstbd), U = (UTportdot, UTstbddot); c = 0.78.  No
// parameters (the kernel passes its size-1 dummy) and no constraint rows.
// f is a template over the scalar type S (float, double or a Dual of
// either).
#pragma once

#include "dual.cuh"
#include "models/hydro.cuh"

namespace nmpc {

struct UsvAcados {
  static constexpr int NX = 5, NU = 2, NP = 0, NH = 0;
  static constexpr int N_FDEP = 7;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 1, 2, 3, 4, 5, 6};
    return t[j];
  }
  static constexpr double C_THRUST = 0.78;

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    S tu, tr;
    Hydro::thrust_map(x[3], x[4], C_THRUST, tu, tr);
    Hydro::uvr_dot(x[0], x[1], x[2], tu, tr, xdot[0], xdot[1], xdot[2]);
    xdot[3] = uc[0];
    xdot[4] = uc[1];
  }
};

}  // namespace nmpc
