// CUDA form of the 14-state hull usv_pf_ca (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_pf_ca with
// models/hydro.py; reference scripts/usv_pf_ca/usv_model.py:61-168).
//
// x = (psi, sinpsi, cospsi, u, v, r, ye, x1, y1, ak, nedx, nedy, Tport,
// Tstbd), U = (UTportdot, UTstbddot), p = (ox1, oy1, ..., ox4, oy4).
// f and h are templates over the scalar type S (float, double or a Dual of
// either), built only from the operators and m_* functions of dual.cuh.
// Two kinks follow JAX's derivative rules, as the torch form does:
//   |x|          m_abs: derivative +1 at 0 (x >= 0 ? dx : -dx);
//   surge drag   a branch-free select on the value, u > 1.25, whose
//                constants carry no tangent (the one-sided derivative of
//                jnp.where at the switch).
// The crab angle uses the native atan2.
#pragma once

#include "dual.cuh"

namespace nmpc {

struct UsvPfCa {
  static constexpr int NX = 14, NU = 2, NP = 8, NH = 4;
  static constexpr int N_FDEP = 9, N_HDEP = 2;
  __host__ __device__ static constexpr int f_dep(int j) {
    const int t[N_FDEP] = {0, 3, 4, 5, 9, 12, 13, 14, 15};
    return t[j];
  }
  __host__ __device__ static constexpr int h_dep(int j) {
    const int t[N_HDEP] = {10, 11};
    return t[j];
  }

  // hydrodynamic constants (reference scripts/usv_pf_ca/usv_model.py:61-76)
  static constexpr double X_U_DOT = -2.25, Y_V_DOT = -23.13,
                          Y_R_DOT = -1.31, N_V_DOT = -16.41,
                          N_R_DOT = -2.79, YVV = -99.99, YVR = -5.49,
                          NRV = -8.8, NRR = -3.49, MASS = 30.0, IZ = 4.1,
                          BEAM = 0.41, C_THRUST = 1.0;
  static constexpr double YV_FACTOR = 1.1 + 0.0045 * (1.01 / 0.09) -
                                      0.1 * (0.27 / 0.09) +
                                      0.016 * ((0.27 / 0.09) * (0.27 / 0.09));

  // continuous dynamics xdot = f(x, u, p) (f reads no parameter)
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[NP],
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S& psi = x[0];
    const S& u = x[3];
    const S& v = x[4];
    const S& r = x[5];
    const S& ak = x[9];
    // thrust map: Tu = Tport + c Tstbd, Tr = (Tport - c Tstbd) B / 2
    const S tu = x[12] + T(C_THRUST) * x[13];
    const S tr = (x[12] - T(C_THRUST) * x[13]) * T(BEAM) / T(2.0);
    // uvr_dot (reference usv_model.py:137-151, the reference's groupings)
    const bool fast = value_of(u) > T(1.25);
    const T xu = fast ? T(64.55) : T(-25.0);
    const T xuu = fast ? T(-70.92) : T(0.0);
    const S yv = T(0.5) * (T(-40.0 * 1000.0) * m_abs(v)) * T(YV_FACTOR);
    const S nr = T(-0.52) * m_sqrt(u * u + v * v);
    const S u_dot = (tu - T(-MASS + 2.0 * Y_V_DOT) * v -
                     T(Y_R_DOT + N_V_DOT) * r * r -
                     ((-xu) * u - xuu * m_abs(u) * u)) /
                    T(MASS - X_U_DOT);
    const S v_dot = (T(-(MASS - X_U_DOT)) * u * r -
                     (-yv - T(YVV) * m_abs(v) - T(YVR) * m_abs(r)) * v) /
                    T(MASS - Y_V_DOT);
    const S r_dot =
        (tr -
         (T(-2.0 * Y_V_DOT) * u * v - T(Y_R_DOT + N_V_DOT) * r * u +
          T(X_U_DOT) * u * r) -
         (-nr * r - T(NRV) * m_abs(v) * r - T(NRR) * m_abs(r) * r)) /
        T(IZ - N_R_DOT);

    const S beta = m_atan2(v, u + T(0.001));
    const S chi = psi + beta;
    const S sp = m_sin(psi), cp = m_cos(psi);
    const S xned_dot = u * cp - v * sp;
    const S yned_dot = u * sp + v * cp;
    xdot[0] = r;
    xdot[1] = m_cos(chi) * r;
    xdot[2] = -m_sin(chi) * r;
    xdot[3] = u_dot;
    xdot[4] = v_dot;
    xdot[5] = r_dot;
    xdot[6] = -xned_dot * m_sin(ak) + yned_dot * m_cos(ak);
    xdot[7] = S(T(0));
    xdot[8] = S(T(0));
    xdot[9] = S(T(0));
    xdot[10] = xned_dot;
    xdot[11] = yned_dot;
    xdot[12] = uc[0];
    xdot[13] = uc[1] / T(C_THRUST);
  }

  // obstacle distances h(x, p)
  template <typename S>
  __device__ __forceinline__ static void h(const S (&x)[NX],
                                           const scalar_t<S> (&p)[NP],
                                           S (&out)[NH]) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const S dx = x[10] - p[2 * i];
      const S dy = x[11] - p[2 * i + 1];
      out[i] = m_sqrt(dx * dx + dy * dy);
    }
  }
};

}  // namespace nmpc
