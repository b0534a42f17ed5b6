// CUDA form of the 14-state path-following hull usv_pf, and the dynamics
// it shares with usv_pf_ca (the torch forms are
// mpc_collisionavoidance_tpu_torch/models/variants.py::_pf_dynamics and
// usv_pf with models/hydro.py; reference scripts/usv_pf/usv_model.py and
// scripts/usv_pf_ca/usv_model.py:137-160).
//
// x = (psi, sinpsi, cospsi, u, v, r, ye, x1, y1, ak, nedx, nedy, Tport,
// Tstbd), U = (UTportdot, UTstbddot).  usv_pf has neither parameters nor
// constraint rows.  f is a template over the scalar type S (float, double
// or a Dual of either), built only from the operators and m_* functions of
// dual.cuh; the hydrodynamics are hydro.cuh's with c = 1.0.  The crab
// angle uses the native atan2.
#pragma once

#include "dual.cuh"
#include "models/hydro.cuh"

namespace nmpc {

// the shared dynamics (the JAX package's _pf_dynamics with c = 1.0)
struct PfDynamics {
  static constexpr int NX = 14, NU = 2;
  static constexpr int N_FDEP = 9;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 3, 4, 5, 9, 12, 13, 14, 15};
    return t[j];
  }
  static constexpr double C_THRUST = 1.0;

  template <typename S>
  __device__ __forceinline__ static void dynamics(const S (&x)[NX],
                                                  const S (&uc)[NU],
                                                  S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[0];
    const S& u = x[3];
    const S& v = x[4];
    const S& r = x[5];
    const S& ak = x[9];
    S tu, tr, u_dot, v_dot, r_dot;
    Hydro::thrust_map(x[12], x[13], C_THRUST, tu, tr);
    Hydro::uvr_dot(u, v, r, tu, tr, u_dot, v_dot, r_dot);
    const S beta = m_atan2(v, u + T(0.001));
    const S chi = psi + beta;
    S sp, cp, sc, cc, sa, ca;
    m_sincos(psi, sp, cp);
    m_sincos(chi, sc, cc);
    m_sincos(ak, sa, ca);
    const S xned_dot = u * cp - v * sp;
    const S yned_dot = u * sp + v * cp;
    xdot[0] = r;
    xdot[1] = cc * r;
    xdot[2] = -sc * r;
    xdot[3] = u_dot;
    xdot[4] = v_dot;
    xdot[5] = r_dot;
    xdot[6] = -xned_dot * sa + yned_dot * ca;
    xdot[7] = S(T(0));
    xdot[8] = S(T(0));
    xdot[9] = S(T(0));
    xdot[10] = xned_dot;
    xdot[11] = yned_dot;
    xdot[12] = uc[0];
    xdot[13] = uc[1] / T(C_THRUST);
  }
};

// no parameters (the kernel passes its size-1 dummy) and no rows
struct UsvPf : PfDynamics {
  static constexpr int NP = 0, NH = 0;
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[1],
                                           S (&xdot)[NX]) {
    dynamics(x, uc, xdot);
  }
};

}  // namespace nmpc
