// CUDA form of the 14-state hull usv_pf_ca (the torch form is
// mpc_collisionavoidance_tpu_torch/models/variants.py::usv_pf_ca; reference
// scripts/usv_pf_ca/usv_model.py:61-168): usv_pf's dynamics (usv_pf.cuh)
// and 4 hard obstacle-distance rows.
//
// p = (ox1, oy1, ..., ox4, oy4); h_i = dist((nedx, nedy), obs_i).  h is a
// template over the scalar type S (float, double or a Dual of either).
#pragma once

#include "dual.cuh"
#include "models/usv_pf.cuh"

namespace nmpc {

struct UsvPfCa : PfDynamics {
  static constexpr int NP = 8, NH = 4;
  static constexpr int N_HDEP = 2;
  __host__ __device__ static constexpr int h_dep(int j) {
    const int t[N_HDEP] = {10, 11};
    return t[j];
  }

  // continuous dynamics xdot = f(x, u, p) (f reads no parameter)
  template <typename S>
  __device__ __forceinline__ static void f(const S (&x)[NX], const S (&uc)[NU],
                                           const scalar_t<S> (&)[NP],
                                           S (&xdot)[NX]) {
    dynamics(x, uc, xdot);
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
