// Forward-mode dual numbers for the model forms of the linearization kernel.
//
// Dual<T, ND> carries a value and ND tangents.  The model functions in
// csrc/models/*.cuh are templates over a scalar type S and call only the
// arithmetic operators and the m_* functions below, so one text runs on
// plain T (values) and on Dual<T, ND> (values + ND directional
// derivatives in one pass).
#pragma once

#include <cuda_runtime.h>

namespace nmpc {

template <typename T, int ND>
struct Dual {
  T v;
  T d[ND];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(T value) : v(value) {  // NOLINT: implicit
#pragma unroll
    for (int i = 0; i < ND; ++i) d[i] = T(0);
  }
};

// scalar_t<S>: the underlying floating type of S
template <typename S>
struct scalar_of {
  using type = S;
};
template <typename T, int ND>
struct scalar_of<Dual<T, ND>> {
  using type = T;
};
template <typename S>
using scalar_t = typename scalar_of<S>::type;

// ---- plain scalar math (explicit float / double overloads) ----
__device__ __forceinline__ float m_sin(float a) { return sinf(a); }
__device__ __forceinline__ double m_sin(double a) { return ::sin(a); }
__device__ __forceinline__ float m_cos(float a) { return cosf(a); }
__device__ __forceinline__ double m_cos(double a) { return ::cos(a); }
__device__ __forceinline__ float m_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double m_sqrt(double a) { return ::sqrt(a); }
__device__ __forceinline__ float m_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ double m_tanh(double a) { return ::tanh(a); }
__device__ __forceinline__ float m_floor(float a) { return floorf(a); }
__device__ __forceinline__ double m_floor(double a) { return ::floor(a); }
__device__ __forceinline__ float m_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double m_atan2(double y, double x) {
  return ::atan2(y, x);
}
// |a| with the JAX rule at 0 (see the dual form below)
__device__ __forceinline__ float m_abs(float a) { return a >= 0.f ? a : -a; }
__device__ __forceinline__ double m_abs(double a) { return a >= 0.0 ? a : -a; }
// the value part of a scalar or a dual (for comparisons and selects)
__device__ __forceinline__ float value_of(float a) { return a; }
__device__ __forceinline__ double value_of(double a) { return a; }

// ---- dual arithmetic ----
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator+(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator+(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator+(T a, const Dual<T, ND>& b) {
  return b + a;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(const Dual<T, ND>& a) {
  Dual<T, ND> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = -a.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(T a, const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = -b.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(T a, const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a * b.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] * b;
  return r;
}
// d(a / b) = da / b - (a / b) db / b
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator/(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator/(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] / b;
  return r;
}

// ---- dual elementary functions ----
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_sin(const Dual<T, ND>& a) {
  Dual<T, ND> r;
  r.v = m_sin(a.v);
  const T c = m_cos(a.v);
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = c * a.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_cos(const Dual<T, ND>& a) {
  Dual<T, ND> r;
  r.v = m_cos(a.v);
  const T s = m_sin(a.v);
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = -s * a.d[i];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_sqrt(const Dual<T, ND>& a) {
  Dual<T, ND> r;
  r.v = m_sqrt(a.v);
  const T inv2 = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = a.d[i] * inv2;
  return r;
}
// d tanh(a) = (1 - tanh(a)^2) da
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_tanh(const Dual<T, ND>& a) {
  Dual<T, ND> r;
  r.v = m_tanh(a.v);
  const T g = T(1) - r.v * r.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = g * a.d[i];
  return r;
}
// JAX's derivative of |x|: +dx where x >= 0 (at 0 too), -dx below
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_abs(const Dual<T, ND>& a) {
  return a.v >= T(0) ? a : -a;
}
template <typename T, int ND>
__device__ __forceinline__ T value_of(const Dual<T, ND>& a) {
  return a.v;
}
// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> m_atan2(const Dual<T, ND>& y,
                                               const Dual<T, ND>& x) {
  Dual<T, ND> r;
  r.v = m_atan2(y.v, x.v);
  const T den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int i = 0; i < ND; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}

}  // namespace nmpc
