// Pieces shared by the port's CUDA sources: dtype codes, limits, element
// conversion, Mish and the device's ns timer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adm {

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

constexpr int MAX_THREADS = 1024;
constexpr int MAX_L = 16;         // positions a kernel holds per output channel
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a CTA may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  return x * tanhf(sp);
}

// The device's ns timer (%globaltimer), the clock of the device spans
// (span_stamp.cu).
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

}  // namespace adm
