// CUDA form of the hull family's 3-DOF hydrodynamics (surge, sway, yaw):
// the text of mpc_collisionavoidance_tpu_torch/models/hydro.py (reference
// scripts/usv_pf_ca/usv_model.py:61-77,137-151), shared by the model forms
// usv_pf_ca, usv_pf, usv_low_level, usv_acados and usv_position_control.
//
// Templates over the scalar type S (float, double or a Dual of either),
// built only from the operators and m_* functions of dual.cuh.  Two kinks
// follow JAX's derivative rules, as the torch form does:
//   |x|          m_abs: derivative +1 at 0 (x >= 0 ? dx : -dx);
//   surge drag   a branch-free select on the value, u > 1.25, whose
//                constants carry no tangent (the one-sided derivative of
//                jnp.where at the switch).
// Every constant is folded in double and rounded once to the working type,
// as the Python forms' float constants are.
#pragma once

#include "dual.cuh"

namespace nmpc {

struct Hydro {
  // added-mass / damping / geometry (reference usv_model.py:61-76)
  static constexpr double X_U_DOT = -2.25, Y_V_DOT = -23.13,
                          Y_R_DOT = -1.31, N_V_DOT = -16.41,
                          N_R_DOT = -2.79, YVV = -99.99, YVR = -5.49,
                          NRV = -8.8, NRR = -3.49, MASS = 30.0, IZ = 4.1,
                          BEAM = 0.41;
  // sway-drag scalar factor (reference usv_model.py:139)
  static constexpr double YV_FACTOR = 1.1 + 0.0045 * (1.01 / 0.09) -
                                      0.1 * (0.27 / 0.09) +
                                      0.016 * ((0.27 / 0.09) * (0.27 / 0.09));

  // Tu = Tport + c Tstbd, Tr = (Tport - c Tstbd) B / 2 (usv_model.py:141-142)
  template <typename S>
  __device__ __forceinline__ static void thrust_map(const S& tport,
                                                    const S& tstbd, double c,
                                                    S& tu, S& tr) {
    using T = scalar_t<S>;
    tu = tport + T(c) * tstbd;
    tr = (tport - T(c) * tstbd) * T(BEAM) / T(2.0);
  }

  // body-frame accelerations (udot, vdot, rdot), with the reference's
  // sign groupings (usv_model.py:137-151)
  template <typename S>
  __device__ __forceinline__ static void uvr_dot(const S& u, const S& v,
                                                 const S& r, const S& tu,
                                                 const S& tr, S& u_dot,
                                                 S& v_dot, S& r_dot) {
    using T = scalar_t<S>;
    const bool fast = value_of(u) > T(1.25);
    const T xu = fast ? T(64.55) : T(-25.0);
    const T xuu = fast ? T(-70.92) : T(0.0);
    const S yv = T(0.5) * (T(-40.0 * 1000.0) * m_abs(v)) * T(YV_FACTOR);
    const S nr = T(-0.52) * m_sqrt(u * u + v * v);
    u_dot = (tu - T(-MASS + 2.0 * Y_V_DOT) * v -
             T(Y_R_DOT + N_V_DOT) * r * r - ((-xu) * u - xuu * m_abs(u) * u)) /
            T(MASS - X_U_DOT);
    v_dot = (T(-(MASS - X_U_DOT)) * u * r -
             (-yv - T(YVV) * m_abs(v) - T(YVR) * m_abs(r)) * v) /
            T(MASS - Y_V_DOT);
    r_dot = (tr -
             (T(-2.0 * Y_V_DOT) * u * v - T(Y_R_DOT + N_V_DOT) * r * u +
              T(X_U_DOT) * u * r) -
             (-nr * r - T(NRV) * m_abs(v) * r - T(NRR) * m_abs(r) * r)) /
            T(IZ - N_R_DOT);
  }
};

}  // namespace nmpc
