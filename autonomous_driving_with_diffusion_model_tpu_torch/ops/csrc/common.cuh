// Pieces shared by the port's CUDA sources: dtype codes, limits, element
// conversion, Mish, the device's ns timer and the phase stamps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adm {

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

constexpr int MAX_THREADS = 1024;
constexpr int MAX_L = 16;         // positions a kernel holds per output channel
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a CTA may use
constexpr int NPHASE = 5;         // phase stamps a CTA records (see stamp)

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

// The device's ns timer (%globaltimer), the clock of the phase stamps and of
// the device spans (span_stamp.cu).
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Phase stamps, off when `stamps` is null (every normal launch): thread 0 of
// CTA i (the CTA's linear index in its grid) writes %globaltimer (ns) and
// clock64() (SM cycles) of phase p to stamps[(i * NPHASE + p) * 2 + {0, 1}].
// The phases are entry, loads landed, outputs in shared memory, statistics
// done and stored (ops/kernels.py:PHASES).
// stamp_at writes a pair read earlier: a kernel that may not write device
// memory yet keeps its entry stamp in registers until it may.
__device__ __forceinline__ void stamp_at(unsigned long long* stamps, int phase,
                                         unsigned long long ns, unsigned long long cycles) {
  if (stamps != nullptr && threadIdx.x == 0) {
    const size_t cta = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    unsigned long long* s = stamps + (cta * NPHASE + phase) * 2;
    s[0] = ns;
    s[1] = cycles;
  }
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int phase) {
  if (stamps != nullptr && threadIdx.x == 0) {
    const unsigned long long ns = globaltimer();
    stamp_at(stamps, phase, ns, (unsigned long long)clock64());
  }
}

}  // namespace adm
