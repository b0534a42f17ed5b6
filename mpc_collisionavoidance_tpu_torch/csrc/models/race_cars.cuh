// CUDA forms of the race car race_cars (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::race_cars;
// reference scripts/race_cars/bycicle_model.py:60-167), on the straight
// track and on a curved one.
//
// x = (s, n, alpha, v, D, delta), U = (derD, derDelta), no parameters.
// The Frenet-frame spatial bicycle model, with m = 0.043, C1 = 0.5,
// C2 = 15.5, Cm1 = 0.28, Cm2 = 0.05, Cr0 = 0.011, Cr2 = 0.006:
//   Fxd   = (Cm1 - Cm2 v) D - Cr2 v v - Cr0 tanh(5 v),
//   sdota = v cos(alpha + C1 delta) / (1 - kappa(s) n),
//   x'    = (sdota, v sin(alpha + C1 delta), v C2 delta - kappa(s) sdota,
//            Fxd / m cos(C1 delta), derD, derDelta),
// and the rows h = (a_long, a_lat, n, D, delta) with a_long = Fxd / m,
// a_lat = C2 v v delta + Fxd sin(C1 delta) / m.
//
// RaceCars<false> is the straight track, kappa = 0: f never reads s or n
// (f_dep 2..7) and reads no table; the division by 1 - 0 n and the
// subtraction of 0 sdota are left out, which changes no value and no
// tangent.  RaceCars<true> reads the curvature table the kernel passes
// it (models/track.cuh): f reads all of (x, u) (f_dep 0..7).  The kernel
// picks the form's f by kTrack.  f and h are templates over the scalar
// type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/track.cuh"

namespace nmpc {

template <bool CURVED>
struct RaceCars {
  static constexpr int NX = 6, NU = 2, NP = 0, NH = 5;
  static constexpr bool kTrack = CURVED;
  static constexpr int N_FDEP = CURVED ? 8 : 6, N_HDEP = 4;
  __host__ __device__ static constexpr int f_dep(int j) {
    return CURVED ? j : j + 2;
  }
  __host__ __device__ static constexpr int h_dep(int j) {
    const int t[N_HDEP] = {1, 3, 4, 5};
    return t[j];
  }

  // the drive force Fxd(v, D)
  template <typename S>
  __device__ __forceinline__ static S drive(const S& v, const S& D) {
    using T = scalar_t<S>;
    return (T(0.28) - T(0.05) * v) * D - T(0.006) * v * v -
           T(0.011) * m_tanh(T(5) * v);
  }

  // continuous dynamics xdot = f(x, u) on the track of `tab` (read only
  // by the curved form)
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&u)[NU],
                                           const scalar_t<S> (&)[1],
                                           const Curvature<scalar_t<S>>& tab,
                                           S (&xdot)[NX]) {
    using T = scalar_t<S>;
    const S ang = x[2] + T(0.5) * x[5];  // alpha + C1 delta
    S sdota = x[3] * m_cos(ang);
    S alpha_dot = x[3] * T(15.5) * x[5];
    if constexpr (CURVED) {
      const S kap = curvature(tab, x[0]);
      sdota = sdota / (T(1) - kap * x[1]);
      alpha_dot = alpha_dot - kap * sdota;
    }
    xdot[0] = sdota;
    xdot[1] = x[3] * m_sin(ang);
    xdot[2] = alpha_dot;
    xdot[3] = drive(x[3], x[4]) / T(0.043) * m_cos(T(0.5) * x[5]);
    xdot[4] = u[0];
    xdot[5] = u[1];
  }
  // f with no table: the straight form's (the kernel calls the curved
  // form's with its table)
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&u)[NU],
                                           const scalar_t<S> (&p)[1],
                                           S (&xdot)[NX]) {
    f(x, u, p, Curvature<scalar_t<S>>{nullptr, 0, scalar_t<S>(0)}, xdot);
  }

  // the accelerations and the boxed states h(x)
  template <typename S>
  __device__ __forceinline__ static void h(const S (&x)[NX],
                                           const scalar_t<S> (&)[1],
                                           S (&out)[NH]) {
    using T = scalar_t<S>;
    const S Fxd = drive(x[3], x[4]);
    out[0] = Fxd / T(0.043);
    out[1] = T(15.5) * x[3] * x[3] * x[5] +
             Fxd * m_sin(T(0.5) * x[5]) / T(0.043);
    out[2] = x[1];
    out[3] = x[4];
    out[4] = x[5];
  }
};

}  // namespace nmpc
