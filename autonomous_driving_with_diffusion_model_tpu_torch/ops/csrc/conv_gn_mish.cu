// conv_gn_mish: one k-wide 1-D convolution + GroupNorm + Mish over a
// channels-last trajectory, with a fused epilogue. It serves the residual
// block only (ops/kernels.py); the U-Net's head has its own kernel,
// conv1d_gn_mish.cu:
//
//   fused_residual_block  = h   = conv_gn_mish(x) + mish(t) tw + tb  launch 1
//                           out = conv_gn_mish(h) + residual(x)      launch 2
//
// Replaces: autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:106
// `fused_residual_block` (_residual_kernel + _conv_gn_mish_inline).
//
// What bounds it on an H100: at the planner's batch of 1-2 the arithmetic is
// tiny (2 FLOPs per weight per batch row and position), so the least time is
// the weight bytes over the memory rate (the 512->512 mid block holds 10.75 MB
// in fp32). With one CTA per GroupNorm group, 8 SMs streamed a layer's weights
// at B = 1, each with a long chain of dependent loads, and the kernel ran at
// 64x that bound.
//
// Design. Each GroupNorm group of each batch row, (b, g), is owned by one
// cluster of cs CTAs (cs = 1, 2, 4 or 8, chosen per launch by
// ops/kernels.py:launch_geometry and checked here); the grid is
// (B x groups x cs) along x, so clusters of 8 put 64 SMs to a layer at B = 1.
// Rank r takes the contiguous slice [r Cin / cs, (r + 1) Cin / cs) of the
// input channels: it stages only those channels of the zero-padded input
// rows, (L + K - 1) x Cin / cs, in shared memory, and reads only their
// K x Cin / cs weight rows of the (K, Cin, C) layout, cg = C / groups
// contiguous values each. The epilogue's reduction is split the same way: the
// E rows of tw, or the Cin rows of wres.
//
// Inside a CTA, S threads share each channel's reduction: thread (s, c) sums
// the rank's (tap, channel) pairs s, s + S, ... for all L positions at once,
// so each weight is read once per cluster and used L times from a register,
// with 4-8 weight loads in flight per thread. The S partial sums meet in
// shared memory, and the ranks meet in distributed shared memory, with no
// atomics and two cluster barriers:
//   1. each rank sums its S partials into sy (L x cg) and sye (the
//      epilogue's); cluster.sync();
//   2. every rank adds the bias and every rank's sy, in rank order, for all
//      n = L x cg outputs of the group, and takes the group's statistics from
//      them (two-pass, fp32). All ranks do the same sums in the same order,
//      so all hold the same mean and variance without exchanging them;
//   3. rank r normalises its chunk [r n / cs, (r + 1) n / cs) of the outputs,
//      applies Mish and the epilogue (every rank's sye, in rank order) and
//      writes it; a last cluster.sync() keeps each CTA's shared memory alive
//      until its peers have read it.
// Every sum runs in a fixed order, so a result repeats bit for bit. The
// bias, norm and epilogue operands are staged with the input rows, so no
// later step waits on device memory. With up to 1024 threads on an SM, every
// instruction of a thread costs the SM about 8 cycles, so the hot loops carry
// their indices instead of dividing. With cs = 1 a CTA takes no cluster
// barrier and this is the port's first design, one CTA per group.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns the launch's CUDA error, or -1 for an unsupported
// dtype mix and -2 for a shape or geometry the kernel does not take.

#include <cooperative_groups.h>

#include "common.cuh"

namespace coop = cooperative_groups;
using namespace adm;

namespace {

// out = mish(gn(conv(x))) + the epilogue:
enum Epilogue : int {
  EPI_TBIAS = 1,     // out += mish(t[b]) . tw[:, c] + tb[c]
  EPI_RES_CONV = 2,  // out += xres[b, l, :] . wres[:, c] + bres[c]
  EPI_RES_ID = 3,    // out += xres[b, l, c]
};

constexpr int MAX_SPLIT = 32;      // S: threads sharing one channel's reduction
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
// Start of part r of n items cut into `parts` contiguous slices
// (ops/kernels.py:rank_slice).
__host__ __device__ __forceinline__ int slice_begin(int n, int parts, int r) {
  return r * n / parts;  // 32-bit: a 64-bit division costs every thread ~100 instructions
}

// Offsets, in floats, of a CTA's shared-memory buffers, and their total
// (ops/kernels.py:launch_geometry computes the same total).
struct Layout {
  int red, sp, sy, sye, yc, sres, sx, se, part, parte, total;
};

__host__ __device__ inline Layout layout(int L, int Cin, int cg, int K, int S, int cs, int epi,
                                         int Ce) {
  const bool has_e = epi == EPI_TBIAS || epi == EPI_RES_CONV;
  const int erows = epi == EPI_TBIAS ? 1 : L;  // t is one row for every position
  if (!has_e) Ce = 0;
  const int n = L * cg, ne = has_e ? erows * cg : 0;
  Layout o;
  o.red = 0;                                      // (32,) block_sum scratch
  o.sp = o.red + 32;                              // (4, cg) bias, gamma, beta, epilogue bias
  o.sy = o.sp + 4 * cg;                           // (n,) this rank's conv partial
  o.sye = o.sy + n;                               // (ne,) this rank's epilogue partial
  o.yc = o.sye + ne;                              // (n,) conv + bias of the whole group
  o.sres = o.yc + n;                              // the chunk's residual (EPI_RES_ID)
  o.sx = o.sres + (epi == EPI_RES_ID ? (n + cs - 1) / cs : 0);  // (L + K - 1, Cin / cs)
  o.se = o.sx + (L + K - 1) * ((Cin + cs - 1) / cs);  // (erows, Ce / cs) epilogue input
  o.part = o.se + erows * ((Ce + cs - 1) / cs);   // (S, n) conv partials
  o.parte = o.part + S * n;                       // (S, ne) epilogue partials
  o.total = o.parte + S * ne;
  return o;
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

// acc[l] += sum over j = s, s + S, ... < nj of rows[l * stride + j] * wc[wrow(j) * C],
// for l < rows_n (rows_n <= LMAX), where wrow(j) = j + (j / stride) * skip. The
// conv walks j = k * nc + ci over its K taps and the rank's nc channels (row
// j of the padded input is row k + l's channel ci; skip = Cin - nc steps to
// tap k's rows of the (K, Cin, C) weights); an epilogue is one tap (skip 0).
// U weights are loaded before any is used, so U loads per thread are in
// flight. The weight pointer is carried from one j to the next, with no
// division: with up to 1024 threads on an SM, every instruction of a thread
// costs the SM about 8 cycles.
template <int LMAX, int U, typename TP>
__device__ __forceinline__ void split_dot(float (&acc)[LMAX], const float* rows, int stride,
                                          int rows_n, int nj, const TP* __restrict__ wc, int skip,
                                          int C, int s, int S) {
  if (s >= nj) return;
  const int64_t step = (int64_t)S * C, wrap = (int64_t)skip * C;
  int ci = s;  // j's channel: j = k * stride + ci
  const TP* wp = wc + (int64_t)s * C;
  while (ci >= stride) ci -= stride, wp += wrap;
  for (int j0 = s; j0 < nj; j0 += U * S) {
    float wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wv[u] = j0 + u * S < nj ? load(wp, 0) : 0.f;
      ci += S;
      wp += step;
      while (ci >= stride) ci -= stride, wp += wrap;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * S;
      if (j < nj) {
#pragma unroll
        for (int l = 0; l < LMAX; ++l)
          if (l < rows_n) acc[l] = fmaf(rows[l * stride + j], wv[u], acc[l]);
      }
    }
  }
}

// TX: conv input; TP: weights, biases and the epilogue input; TO: output.
// ein/ew/eb: the epilogue's input, weight and bias: t (B, Ce), tw, tb for
// EPI_TBIAS; xres (B, L, Ce), wres, bres for EPI_RES_CONV; xres (B, L, C)
// alone for EPI_RES_ID. Launched in clusters of cs along x. STAMP: record
// the phase stamps; a normal launch compiles without them.
template <int LMAX, bool STAMP, typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(MAX_THREADS)
    conv_gn_mish_kernel(const TX* __restrict__ x, const TP* __restrict__ w,
                        const TP* __restrict__ bias, const TP* __restrict__ gamma,
                        const TP* __restrict__ beta, int L, int Cin, int C, int K, int groups,
                        int S, float eps, int epi, const TP* __restrict__ ein, int Ce,
                        const TP* __restrict__ ew, const TP* __restrict__ eb,
                        TO* __restrict__ out, unsigned long long* __restrict__ stamps) {
  if constexpr (STAMP) stamp(stamps, 0);
  constexpr int U = LMAX <= 4 ? 8 : 4;  // weight loads in flight per thread
  extern __shared__ float smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int bg = blockIdx.x / cs;  // blockIdx.x = (b * groups + g) * cs + r
  const int b = bg / groups, g = bg % groups;
  const int cg = C / groups;
  const int n = L * cg;
  const int pad = K / 2;
  const int Lp = L + K - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool has_e = epi == EPI_TBIAS || epi == EPI_RES_CONV;
  const int erows = epi == EPI_TBIAS ? 1 : L;
  const int Cs = has_e ? Ce : 0;  // epilogue rows that are reduced
  const int ne = has_e ? erows * cg : 0;

  const Layout lay = layout(L, Cin, cg, K, S, cs, epi, Ce);
  float* red = smem + lay.red;
  float* sp = smem + lay.sp;
  float* sy = smem + lay.sy;
  float* sye = smem + lay.sye;
  float* yc = smem + lay.yc;
  float* sres = smem + lay.sres;
  float* sx = smem + lay.sx;
  float* se = smem + lay.se;
  float* part = smem + lay.part;
  float* parte = smem + lay.parte;

  // this rank's input channels [c0, c0 + nc), epilogue rows [e0, e0 + nce)
  // and outputs [o0, o1)
  const int c0 = slice_begin(Cin, cs, r), nc = slice_begin(Cin, cs, r + 1) - c0;
  const int e0 = slice_begin(Cs, cs, r), nce = slice_begin(Cs, cs, r + 1) - e0;
  const int o0 = slice_begin(n, cs, r), o1 = slice_begin(n, cs, r + 1);
  // a cluster of one needs no cluster barrier and no distributed addresses
  auto peer = [&](float* p, int q) { return q == r ? p : cluster.map_shared_rank(p, q); };

  const TX* xb = x + (int64_t)b * L * Cin + c0;
  for (int i = tid; i < Lp * nc; i += nt) {
    const int l = i / nc - pad;
    sx[i] = (l >= 0 && l < L) ? load(xb, (int64_t)l * Cin + i % nc) : 0.f;
  }
  if (epi == EPI_TBIAS)
    for (int e = tid; e < nce; e += nt) se[e] = mish(load(ein, (int64_t)b * Ce + e0 + e));
  else if (epi == EPI_RES_CONV)
    for (int i = tid; i < L * nce; i += nt)
      se[i] = load(ein, ((int64_t)b * L + i / nce) * Ce + e0 + i % nce);
  // the epilogue's operands, loaded now so that no later step waits on memory
  for (int i = tid; i < cg; i += nt) {
    const int c = g * cg + i;
    sp[i] = load(bias, c);
    sp[cg + i] = load(gamma, c);
    sp[2 * cg + i] = load(beta, c);
    sp[3 * cg + i] = has_e ? load(eb, c) : 0.f;
  }
  if (epi == EPI_RES_ID)
    for (int o = o0 + tid; o < o1; o += nt)
      sres[o - o0] = load(ein, ((int64_t)b * L + o / cg) * C + g * cg + o % cg);
  __syncthreads();
  if constexpr (STAMP) stamp(stamps, 1);

  // partial sums of thread (s, cl) over its share of the rank's channels
  const int s = tid / cg, cl = tid % cg;
  if (s < S) {
    const int c = g * cg + cl;
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    split_dot<LMAX, U>(acc, sx, nc, L, K * nc, w + (int64_t)c0 * C + c, Cin - nc, C, s, S);
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L) part[s * n + l * cg + cl] = acc[l];
    if (has_e) {
#pragma unroll
      for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
      split_dot<LMAX, U>(acc, se, nce, erows, nce, ew + (int64_t)e0 * C + c, 0, C, s, S);
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < erows) parte[s * ne + l * cg + cl] = acc[l];
    }
  }
  __syncthreads();

  // 1. the rank's share of every output, summed over its S threads
  for (int o = tid; o < n; o += nt) {
    float v = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) v += part[j * n + o];
    sy[o] = v;
  }
  for (int o = tid; o < ne; o += nt) {
    float v = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) v += parte[j * ne + o];
    sye[o] = v;
  }
  if (cs > 1) cluster.sync(); else __syncthreads();
  if constexpr (STAMP) stamp(stamps, 2);

  // 2. every output of the group: bias + every rank's share, in rank order.
  // Every rank computes all of them, in the same order, so all hold the same
  // statistics without exchanging them.
  float lsum = 0.f;
  for (int o = tid; o < n; o += nt) {
    float v = sp[o % cg];
    for (int q = 0; q < cs; ++q) v += peer(sy, q)[o];
    yc[o] = v;
    lsum += v;
  }

  // 3. statistics of the group, two-pass
  const float mean = block_sum(lsum, red) / n;
  float lsq = 0.f;
  for (int o = tid; o < n; o += nt) {
    const float d = yc[o] - mean;
    lsq += d * d;
  }
  const float rstd = rsqrtf(block_sum(lsq, red) / n + eps);
  if constexpr (STAMP) stamp(stamps, 3);

  // 4. this rank's chunk: normalise, Mish, epilogue
  for (int o = o0 + tid; o < o1; o += nt) {
    const int l = o / cg, ol = o % cg, c = g * cg + ol;
    float y = mish((yc[o] - mean) * rstd * sp[cg + ol] + sp[2 * cg + ol]);
    if (has_e) {
      const int eo = (epi == EPI_TBIAS ? 0 : l) * cg + ol;
      float e = sp[3 * cg + ol];
      for (int q = 0; q < cs; ++q) e += peer(sye, q)[eo];
      y += e;
    } else if (epi == EPI_RES_ID) {
      y += sres[o - o0];
    }
    store(out, ((int64_t)b * L + l) * C + c, y);
  }
  if (cs > 1) cluster.sync();  // peers may still read this CTA's sy and sye
  else if constexpr (STAMP) __syncthreads();
  if constexpr (STAMP) stamp(stamps, 4);
}

__global__ void empty_kernel(int) {}

// A launch of `kernel` on `ctas` CTAs in clusters of cs along x.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int ctas, int threads, size_t smem, int cs,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // the refusal is returned; do not leave it for the next check
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <int LMAX, bool STAMP, typename TX, typename TP, typename TO>
int launch_l(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
             int B, int L, int Cin, int C, int K, int groups, int S, float eps, int epi,
             const void* ein, int Ce, const void* ew, const void* eb, void* out, int cs,
             int threads, size_t smem, unsigned long long* stamps, cudaStream_t stream) {
  auto kernel = conv_gn_mish_kernel<LMAX, STAMP, TX, TP, TO>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_clusters(
      kernel, B * groups * cs, threads, smem, cs, stream, static_cast<const TX*>(x),
      static_cast<const TP*>(w), static_cast<const TP*>(bias), static_cast<const TP*>(gamma),
      static_cast<const TP*>(beta), L, Cin, C, K, groups, S, eps, epi,
      static_cast<const TP*>(ein), Ce, static_cast<const TP*>(ew), static_cast<const TP*>(eb),
      static_cast<TO*>(out), stamps);
}

template <typename TX, typename TP, typename TO>
int launch(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
           int B, int L, int Cin, int C, int K, int groups, float eps, int epi, const void* ein,
           int Ce, const void* ew, const void* eb, void* out, int cs, int threads, int smem,
           unsigned long long* stamps, cudaStream_t stream) {
  if (groups <= 0 || C % groups != 0 || L < 1 || L > MAX_L || K < 1) return -2;
  if (epi != EPI_TBIAS && epi != EPI_RES_CONV && epi != EPI_RES_ID) return -2;
  const int cg = C / groups;
  if (cs < 1 || cs > MAX_CLUSTER || (cs & (cs - 1)) != 0) return -2;
  if (threads < cg || threads > MAX_THREADS || threads % 32 != 0) return -2;
  const int S = threads / cg < MAX_SPLIT ? threads / cg : MAX_SPLIT;
  const Layout lay = layout(L, Cin, cg, K, S, cs, epi, Ce);
  if (smem != lay.total * (int)sizeof(float) || smem > MAX_SMEM) return -2;
#define ADM_L(LM)                                                                              \
  return stamps ? launch_l<LM, true, TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, \
                                                 S, eps, epi, ein, Ce, ew, eb, out, cs, threads,   \
                                                 (size_t)smem, stamps, stream)                     \
                : launch_l<LM, false, TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, \
                                                  S, eps, epi, ein, Ce, ew, eb, out, cs, threads,   \
                                                  (size_t)smem, stamps, stream)
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
// cs, threads, smem: the launch geometry (ops/kernels.py:launch_geometry):
// the cluster size, the threads of a CTA and its shared-memory bytes.
// stamps: null, or (CTAs, 5, 2) values (common.cuh:stamp).
extern "C" int adm_conv_gn_mish(const void* x, const void* w, const void* bias,
                                const void* gamma, const void* beta, int B, int L, int Cin, int C,
                                int K, int groups, float eps, int epi, const void* ein, int Ce,
                                const void* ew, const void* eb, void* out, int x_dtype,
                                int p_dtype, int out_dtype, int cs, int threads, int smem,
                                unsigned long long* stamps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADM_LAUNCH(TX, TP, TO)                                                                   \
  return launch<TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, ein, Ce, \
                            ew, eb, out, cs, threads, smem, stamps, s)
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

// An empty kernel launched as a kernel of the port is: ctas CTAs of
// `threads` with `smem` bytes of dynamic shared memory, in clusters of cs (as
// conv_gn_mish is) or, for cs = 0, with no cluster (as conv1d_gn_mish is).
// The least device time a launch of that shape costs.
extern "C" int adm_empty_launch(int ctas, int threads, int cs, int smem, void* stream) {
  if (cs < 0 || cs > MAX_CLUSTER || (cs > 0 && ctas % cs != 0) || smem < 0 || smem > MAX_SMEM)
    return -2;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cs > 0) return launch_clusters(empty_kernel, ctas, threads, (size_t)smem, cs, s, 0);
  empty_kernel<<<ctas, threads, smem, s>>>(0);
  return (int)cudaGetLastError();
}
