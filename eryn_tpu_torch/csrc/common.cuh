// Shared helpers for the port's hand-written Hopper kernels.
//
// Arithmetic goes through the round-to-nearest intrinsics so nvcc never
// contracts a multiply and an add into one fused multiply-add: the kernels
// must round exactly where the JAX kernels (and the PyTorch plain versions)
// round, so that accept and pick decisions agree with them decision for
// decision.  Only exp and log may differ, by an ulp or two.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace eryn {

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
};

}  // namespace eryn
