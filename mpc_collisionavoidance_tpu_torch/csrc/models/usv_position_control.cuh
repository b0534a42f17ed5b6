// CUDA form of the 8-state NED position-control model usv_position_control
// (the torch form is mpc_collisionavoidance_tpu_torch/models/variants.py::
// usv_position_control with models/hydro.py; reference
// scripts/usv_position_control/usv_model.py).
//
// x = (x, y, psi, u, v, r, Tport, Tstbd), U = (UTportdot, UTstbddot);
// c = 0.78, and both thrusts integrate their rates directly (no / c on
// starboard, per the reference).  No parameters (the kernel passes its
// size-1 dummy) and no constraint rows.  f is a template over the scalar
// type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/hydro.cuh"

namespace nmpc {

struct UsvPositionControl {
  static constexpr int NX = 8, NU = 2, NP = 0, NH = 0;
  static constexpr int N_FDEP = 8;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {2, 3, 4, 5, 6, 7, 8, 9};
    return t[j];
  }
  static constexpr double C_THRUST = 0.78;

  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    const S& psi = x[2];
    const S& u = x[3];
    const S& v = x[4];
    S tu, tr;
    Hydro::thrust_map(x[6], x[7], C_THRUST, tu, tr);
    Hydro::uvr_dot(u, v, x[5], tu, tr, xdot[3], xdot[4], xdot[5]);
    const S sp = m_sin(psi), cp = m_cos(psi);
    xdot[0] = u * cp - v * sp;
    xdot[1] = u * sp + v * cp;
    xdot[2] = x[5];
    xdot[6] = uc[0];
    xdot[7] = uc[1];
  }
};

}  // namespace nmpc
