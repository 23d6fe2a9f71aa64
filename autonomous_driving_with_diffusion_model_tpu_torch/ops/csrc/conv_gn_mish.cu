// conv_gn_mish: one k-wide 1-D convolution + GroupNorm + Mish over a
// channels-last trajectory, with an optional fused epilogue. Both TPU kernels
// of the JAX package are built from it (ops/kernels.py):
//
//   fused_conv1d_gn_mish  = conv_gn_mish(x)                          1 launch
//   fused_residual_block  = h   = conv_gn_mish(x) + mish(t) tw + tb  launch 1
//                           out = conv_gn_mish(h) + residual(x)      launch 2
//
// Replaces: autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py
// `fused_conv1d_gn_mish` (_kernel) and `fused_residual_block`
// (_residual_kernel + _conv_gn_mish_inline).
//
// What bounds it on an H100: at the planner's batch of 1-2 the arithmetic is
// tiny (2 FLOPs per weight per batch row and position), so the least time is
// the weight bytes over the memory rate (the 512->512 mid block holds 10.75 MB
// in fp32).
//
// Design. The Pallas grid is (B,), one program per batch row, which suits a
// TPU's one sequential core. Here the grid is (B x groups): each CTA computes
// the cg = C / groups channels of one GroupNorm group at all L positions, so
// the group statistics stay inside the CTA and need no second pass over
// device memory. The zero-padded input rows (L + K - 1) x Cin are staged in
// shared memory as float. Weights are read in a (K, Cin, C) layout packed
// once by the caller, so neighbouring threads (neighbouring channels) read
// neighbouring addresses.
//
// Inside the CTA, S threads share each channel's reduction: thread (s, c)
// sums input channels ci = s, s + S, ... for all L positions at once, so each
// weight is read once per CTA and used L times from a register, and a weight
// load waits behind Cin*K/S others instead of Cin*K. The S partial sums meet
// in shared memory. The epilogues are a second, smaller reduction done the
// same way: mish(t[b]) . tw (one row for all positions) or x . wres (L rows).
// Statistics are two-pass (mean, then centred squares) in fp32; accumulation
// is fp32.
//
// Only 8 * B CTAs stream the weights, so at B = 1-2 the kernel uses a few of
// the 132 SMs and sits far from the weight bound: a split of the Cin
// reduction across CTAs (a cluster sharing partial sums, wgmma, TMA) is the
// next design.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError(), or -1 for an unsupported dtype mix
// and -2 for a shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epilogue : int {
  EPI_NONE = 0,      // out = mish(gn(conv(x)))
  EPI_TBIAS = 1,     // out += mish(t[b]) . tw[:, c] + tb[c]
  EPI_RES_CONV = 2,  // out += xres[b, l, :] . wres[:, c] + bres[c]
  EPI_RES_ID = 3,    // out += xres[b, l, c]
};

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SPLIT = 32;      // S: threads sharing one channel's reduction
constexpr int MAX_L = 16;          // positions a thread holds in registers
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a CTA may use

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  return x * tanhf(sp);
}

// Sum of v over the CTA (blockDim.x a multiple of 32); every thread gets the
// total. red holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// acc[l] += sum over ci = s, s + S, ... < Cin of rows[l * stride + ci] * wc[ci * C],
// for l < rows_n (rows_n <= LMAX).
template <int LMAX, typename TP>
__device__ __forceinline__ void split_dot(float (&acc)[LMAX], const float* rows, int stride,
                                          int rows_n, const TP* __restrict__ wc, int Cin, int C,
                                          int s, int S) {
#pragma unroll 4
  for (int ci = s; ci < Cin; ci += S) {
    const float wv = load(wc, (int64_t)ci * C);
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < rows_n) acc[l] = fmaf(rows[l * stride + ci], wv, acc[l]);
  }
}

// TX: conv input; TP: weights, biases and the epilogue input; TO: output.
// ein/ew/eb: the epilogue's input, weight and bias: t (B, Ce), tw, tb for
// EPI_TBIAS; xres (B, L, Ce), wres, bres for EPI_RES_CONV; xres (B, L, C)
// alone for EPI_RES_ID.
template <int LMAX, typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(MAX_THREADS)
    conv_gn_mish_kernel(const TX* __restrict__ x, const TP* __restrict__ w,
                        const TP* __restrict__ bias, const TP* __restrict__ gamma,
                        const TP* __restrict__ beta, int L, int Cin, int C, int K, int groups,
                        int S, float eps, int epi, const TP* __restrict__ ein, int Ce,
                        const TP* __restrict__ ew, const TP* __restrict__ eb,
                        TO* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int cg = C / groups;
  const int n = L * cg;
  const int pad = K / 2;
  const int Lp = L + K - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool has_e = epi == EPI_TBIAS || epi == EPI_RES_CONV;
  const int erows = epi == EPI_TBIAS ? 1 : L;  // t is one row for every position
  if (!has_e) Ce = 0;

  float* sx = smem;                 // (Lp, Cin) zero-padded input rows
  float* se = sx + Lp * Cin;        // (erows, Ce) epilogue input rows
  float* part = se + erows * Ce;    // (S, L, cg) conv partial sums
  float* parte = part + S * n;      // (S, erows, cg) epilogue partial sums
  float* sy = parte + (has_e ? S * erows * cg : 0);  // (n,) conv + bias
  float* red = sy + n;              // (32,) reduction scratch

  const TX* xb = x + (int64_t)b * L * Cin;
  for (int i = tid; i < Lp * Cin; i += nt) {
    const int l = i / Cin - pad;
    sx[i] = (l >= 0 && l < L) ? load(xb, (int64_t)l * Cin + i % Cin) : 0.f;
  }
  if (epi == EPI_TBIAS)
    for (int e = tid; e < Ce; e += nt) se[e] = mish(load(ein, (int64_t)b * Ce + e));
  else if (epi == EPI_RES_CONV)
    for (int i = tid; i < L * Ce; i += nt) se[i] = load(ein, (int64_t)b * L * Ce + i);
  __syncthreads();

  // partial sums of thread (s, cl) over its share of the input channels
  const int s = tid / cg, cl = tid % cg;
  if (s < S) {
    const int c = g * cg + cl;
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    for (int k = 0; k < K; ++k)
      split_dot<LMAX>(acc, sx + k * Cin, Cin, L, w + (int64_t)k * Cin * C + c, Cin, C, s, S);
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L) part[(s * L + l) * cg + cl] = acc[l];
    if (has_e) {
#pragma unroll
      for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
      split_dot<LMAX>(acc, se, Ce, erows, ew + c, Ce, C, s, S);
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < erows) parte[(s * erows + l) * cg + cl] = acc[l];
    }
  }
  __syncthreads();

  float lsum = 0.f;
  for (int o = tid; o < n; o += nt) {
    const int l = o / cg, ol = o % cg;
    float v = load(bias, g * cg + ol);
    for (int j = 0; j < S; ++j) v += part[(j * L + l) * cg + ol];
    sy[o] = v;
    lsum += v;
  }
  const float mean = block_sum(lsum, red) / n;
  float lsq = 0.f;
  for (int o = tid; o < n; o += nt) {
    const float d = sy[o] - mean;
    lsq += d * d;
  }
  const float rstd = rsqrtf(block_sum(lsq, red) / n + eps);

  for (int o = tid; o < n; o += nt) {
    const int l = o / cg, ol = o % cg, c = g * cg + ol;
    float y = mish((sy[o] - mean) * rstd * load(gamma, c) + load(beta, c));
    if (has_e) {
      const int el = epi == EPI_TBIAS ? 0 : l;
      float e = load(eb, c);
      for (int j = 0; j < S; ++j) e += parte[(j * erows + el) * cg + ol];
      y += e;
    } else if (epi == EPI_RES_ID) {
      y += load(ein, ((int64_t)b * L + l) * C + c);
    }
    store(out, ((int64_t)b * L + l) * C + c, y);
  }
}

template <int LMAX, typename TX, typename TP, typename TO>
int launch_l(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
             int B, int L, int Cin, int C, int K, int groups, int S, int threads, size_t smem,
             float eps, int epi, const void* ein, int Ce, const void* ew, const void* eb,
             void* out, cudaStream_t stream) {
  auto kernel = conv_gn_mish_kernel<LMAX, TX, TP, TO>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * groups, threads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(w), static_cast<const TP*>(bias),
      static_cast<const TP*>(gamma), static_cast<const TP*>(beta), L, Cin, C, K, groups, S, eps,
      epi, static_cast<const TP*>(ein), Ce, static_cast<const TP*>(ew),
      static_cast<const TP*>(eb), static_cast<TO*>(out));
  return (int)cudaGetLastError();
}

template <typename TX, typename TP, typename TO>
int launch(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
           int B, int L, int Cin, int C, int K, int groups, float eps, int epi, const void* ein,
           int Ce, const void* ew, const void* eb, void* out, cudaStream_t stream) {
  if (groups <= 0 || C % groups != 0 || L < 1 || L > MAX_L || K < 1) return -2;
  const int cg = C / groups;
  if (cg > MAX_THREADS) return -2;
  int S = 1;
  while (S * 2 <= MAX_SPLIT && S * 2 * cg <= MAX_THREADS) S *= 2;
  const int threads = (S * cg + 31) / 32 * 32;
  const bool has_e = epi == EPI_TBIAS || epi == EPI_RES_CONV;
  const int erows = epi == EPI_TBIAS ? 1 : L;
  const size_t n = (size_t)L * cg;
  const size_t floats = (size_t)(L + K - 1) * Cin + (has_e ? erows * (size_t)Ce : 0) + S * n +
                        (has_e ? (size_t)S * erows * cg : 0) + n + 32;
  const size_t smem = floats * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return -2;
#define ADM_L(LM)                                                                            \
  return launch_l<LM, TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, S, threads, \
                                  smem, eps, epi, ein, Ce, ew, eb, out, stream)
  if (L <= 2) ADM_L(2);
  if (L <= 4) ADM_L(4);
  if (L <= 8) ADM_L(8);
  ADM_L(16);
#undef ADM_L
}

}  // namespace

// x: (B, L, Cin) of x_dtype; w: (K, Cin, C); bias/gamma/beta: (C,); ein, ew,
// eb: the epilogue's input, weight (Ce, C) and bias (C,) (see the kernel);
// out: (B, L, C) of out_dtype. Weights and the epilogue input are of p_dtype.
extern "C" int adm_conv_gn_mish(const void* x, const void* w, const void* bias,
                                const void* gamma, const void* beta, int B, int L, int Cin, int C,
                                int K, int groups, float eps, int epi, const void* ein, int Ce,
                                const void* ew, const void* eb, void* out, int x_dtype,
                                int p_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADM_LAUNCH(TX, TP, TO) \
  return launch<TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, ein, Ce, ew, eb, out, s)
  if (p_dtype == DT_F32 && x_dtype == DT_F32 && out_dtype == DT_F32) ADM_LAUNCH(float, float, float);
  if (p_dtype == DT_BF16) {
    if (x_dtype == DT_BF16 && out_dtype == DT_BF16)
      ADM_LAUNCH(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16);
    if (x_dtype == DT_BF16 && out_dtype == DT_F32) ADM_LAUNCH(__nv_bfloat16, __nv_bfloat16, float);
    if (x_dtype == DT_F32 && out_dtype == DT_BF16) ADM_LAUNCH(float, __nv_bfloat16, __nv_bfloat16);
  }
#undef ADM_LAUNCH
  return -1;
}
