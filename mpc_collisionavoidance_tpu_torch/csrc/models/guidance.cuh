// CUDA form of the kinematics the guidance models share (the torch forms
// are mpc_collisionavoidance_tpu_torch/models/variants.py: the crab-angle
// heading error of usv_guidance3..5, usv_guidance_ca and the flagship, the
// NED rates and the path's cross-track rate, and _obstacle_distances),
// used by the model forms usv_guidance_ca1, usv_guidance_ca,
// usv_guidance, usv_guidance2..5.
//
// Templates over the scalar type S (float, double or a Dual of either),
// built only from the operators and m_* functions of dual.cuh, with the
// torch forms' order of operations.  The crab angle uses the native atan2.
#pragma once

#include "dual.cuh"

namespace nmpc {

struct Guidance {
  // crab angle beta = atan2(v, u + 0.001) (reference
  // scripts/usv_guidance_ca1/usv_model.py:117)
  template <typename S>
  __device__ __forceinline__ static S crab(const S& u, const S& v) {
    using T = scalar_t<S>;
    return m_atan2(v, u + T(0.001));
  }

  // NED velocity (xned_dot, yned_dot) of body speeds (u, v) at a heading
  // of sine sp and cosine cp
  template <typename S>
  __device__ __forceinline__ static void ned_rates(const S& u, const S& v,
                                                   const S& sp, const S& cp,
                                                   S& xned_dot, S& yned_dot) {
    xned_dot = u * cp - v * sp;
    yned_dot = u * sp + v * cp;
  }
  // the same at heading psi
  template <typename S>
  __device__ __forceinline__ static void ned_rates(const S& u, const S& v,
                                                   const S& psi, S& xned_dot,
                                                   S& yned_dot) {
    S sp, cp;
    m_sincos(psi, sp, cp);
    ned_rates(u, v, sp, cp, xned_dot, yned_dot);
  }

  // cross-track rate along a segment at angle ak
  template <typename S>
  __device__ __forceinline__ static S cross_track_rate(const S& xned_dot,
                                                       const S& yned_dot,
                                                       const S& ak) {
    S sa, ca;
    m_sincos(ak, sa, ca);
    return -xned_dot * sa + yned_dot * ca;
  }

  // distances from (xp, yp) to the NOBS obstacle centres of
  // p = (ox1, oy1, ..., ox_NOBS, oy_NOBS) (reference
  // scripts/usv_guidance_ca1/usv_model.py:133-140)
  template <int NOBS, typename S, int NP>
  __device__ __forceinline__ static void obstacle_distances(
      const S& xp, const S& yp, const scalar_t<S> (&p)[NP], S (&out)[NOBS]) {
    static_assert(2 * NOBS <= NP, "two parameters per obstacle");
#pragma unroll
    for (int i = 0; i < NOBS; ++i) {
      const S dx = xp - p[2 * i];
      const S dy = yp - p[2 * i + 1];
      out[i] = m_sqrt(dx * dx + dy * dy);
    }
  }
};

}  // namespace nmpc
