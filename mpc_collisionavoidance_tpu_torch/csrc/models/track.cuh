// A race track's curvature table and its periodic Catmull-Rom interpolant
// kappa(s), for the model forms that read one (the torch form is
// mpc_collisionavoidance_tpu_torch/utils/track.py::_interp_periodic; the
// reference's kapparef_s bspline, scripts/race_cars/bycicle_model.py:
// 46-55).
//
// The table holds M uniform samples of kappa over one lap of `length`
// (utils/track.py::Track.kapparef); the linearization kernel receives it
// as an argument, so any track runs through the same compiled form.  The
// interpolant repeats the torch form's operations in its order: the lap
// count by floor, the sample index by truncation then clip (neither
// carries a tangent, as in jax.linearize), the neighbours modulo M, the
// cubic in the same grouping.  A curvature table carries no lap
// increment, so the seam correction of an unwrapped table (psiref) is
// not needed here.  Four loads per evaluation: the 512 samples of the
// synthetic track (2 or 4 KB) stay in L1.
#pragma once

#include "dual.cuh"

namespace nmpc {

template <typename T>
struct Curvature {
  const T* kap;  // (M,) samples of kappa over one lap
  int M;
  T length;      // the lap's arc length
};

// kappa(s) at arc length s (a scalar or a dual)
template <typename T, typename S>
__device__ __forceinline__ S curvature(const Curvature<T>& c, const S& s) {
  const T laps = m_floor(value_of(s) / c.length);
  const S sm = s - laps * c.length;
  const S t = sm / c.length * static_cast<T>(c.M);
  // truncation toward zero, as the reference's int32 cast, then clip (a
  // non-finite s lands on a valid sample)
  int i1 = static_cast<int>(value_of(t));
  i1 = i1 < 0 ? 0 : (i1 > c.M - 1 ? c.M - 1 : i1);
  const S frac = t - static_cast<T>(i1);
  const T p0 = c.kap[(i1 - 1 + c.M) % c.M], p1 = c.kap[i1];
  const T p2 = c.kap[(i1 + 1) % c.M], p3 = c.kap[(i1 + 2) % c.M];
  const S f2 = frac * frac;
  const S f3 = f2 * frac;
  return T(0.5) * ((T(2) * p1 + (-p0 + p2) * frac) +
                   (T(2) * p0 - T(5) * p1 + T(4) * p2 - p3) * f2 +
                   (-p0 + T(3) * p1 - T(3) * p2 + p3) * f3);
}

}  // namespace nmpc
