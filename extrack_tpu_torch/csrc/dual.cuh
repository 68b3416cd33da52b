// Scalar types of the walk templates in common.cuh and grad.cuh.
//
// The walk is written once over a scalar type `Real`.  `float` gives the
// likelihood and gradient kernels (K1, K2).  `Dual` (a value and its
// directional tangent) gives the Hessian-vector-product kernel (K3, hvp.cu):
// every carry, history entry and cotangent then rides with its tangent, so
// K3 applies forward mode to K2's own step code and derives nothing again.
//
// The walk calls the helpers below instead of expf / logf / rsqrtf / fmaxf,
// so one call site serves both types:
//   xexp, xlog, xrsqrt  the functions and their derivatives;
//   shift_max           the max of a max-shifted exp-sum.  The shift cancels
//                       out of the sum, so its tangent is 0: a tie never
//                       counts a tangent twice;
//   clamp_min           a guard such as max(sum, 1e-30): tangent 0 on the
//                       clamped side;
//   val                 the value, for comparisons;
//   shfl_xor            a warp shuffle of every component.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace extrack {

struct __align__(8) Dual {
  float v, t;
  Dual() = default;
  __host__ __device__ constexpr Dual(float a) : v(a), t(0.f) {}
  __host__ __device__ constexpr Dual(float a, float b) : v(a), t(b) {}
};

// Mixed Dual / float forms keep a float operand's tangent out of the
// product rule (an infinite value times a zero tangent would give NaN).
static __device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.t + b.t);
}
static __device__ __forceinline__ Dual operator+(Dual a, float b) {
  return Dual(a.v + b, a.t);
}
static __device__ __forceinline__ Dual operator+(float a, Dual b) {
  return Dual(a + b.v, b.t);
}
static __device__ __forceinline__ Dual operator-(Dual a) {
  return Dual(-a.v, -a.t);
}
static __device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.t - b.t);
}
static __device__ __forceinline__ Dual operator-(Dual a, float b) {
  return Dual(a.v - b, a.t);
}
static __device__ __forceinline__ Dual operator-(float a, Dual b) {
  return Dual(a - b.v, -b.t);
}
static __device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.t * b.v + a.v * b.t);
}
static __device__ __forceinline__ Dual operator*(Dual a, float b) {
  return Dual(a.v * b, a.t * b);
}
static __device__ __forceinline__ Dual operator*(float a, Dual b) {
  return Dual(a * b.v, a * b.t);
}
static __device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float r = 1.0f / b.v;
  const float q = a.v * r;
  return Dual(q, (a.t - q * b.t) * r);
}
static __device__ __forceinline__ Dual operator/(Dual a, float b) {
  const float r = 1.0f / b;
  return Dual(a.v * r, a.t * r);
}
static __device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float r = 1.0f / b.v;
  const float q = a * r;
  return Dual(q, -q * b.t * r);
}
static __device__ __forceinline__ Dual& operator+=(Dual& a, Dual b) {
  return a = a + b;
}
static __device__ __forceinline__ Dual& operator+=(Dual& a, float b) {
  return a = a + b;
}
static __device__ __forceinline__ Dual& operator-=(Dual& a, Dual b) {
  return a = a - b;
}
static __device__ __forceinline__ Dual& operator*=(Dual& a, Dual b) {
  return a = a * b;
}

static __device__ __forceinline__ float xexp(float a) { return expf(a); }
static __device__ __forceinline__ float xlog(float a) { return logf(a); }
static __device__ __forceinline__ float xrsqrt(float a) { return rsqrtf(a); }
static __device__ __forceinline__ float shift_max(float a, float b) {
  return fmaxf(a, b);
}
static __device__ __forceinline__ float clamp_min(float a, float lo) {
  return fmaxf(a, lo);
}
static __device__ __forceinline__ float val(float a) { return a; }
static __device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

static __device__ __forceinline__ Dual xexp(Dual a) {
  const float e = expf(a.v);
  return Dual(e, e * a.t);
}
static __device__ __forceinline__ Dual xlog(Dual a) {
  return Dual(logf(a.v), a.t / a.v);
}
static __device__ __forceinline__ Dual xrsqrt(Dual a) {
  const float r = rsqrtf(a.v);
  return Dual(r, -0.5f * r * r * r * a.t);
}
static __device__ __forceinline__ Dual shift_max(Dual a, Dual b) {
  return Dual(fmaxf(a.v, b.v));
}
static __device__ __forceinline__ Dual clamp_min(Dual a, float lo) {
  return a.v >= lo ? a : Dual(lo);
}
static __device__ __forceinline__ float val(Dual a) { return a.v; }
static __device__ __forceinline__ Dual shfl_xor(Dual v, int o) {
  return Dual(__shfl_xor_sync(0xffffffffu, v.v, o),
              __shfl_xor_sync(0xffffffffu, v.t, o));
}

}  // namespace extrack
