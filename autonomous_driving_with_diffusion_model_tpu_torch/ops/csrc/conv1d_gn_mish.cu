// conv1d_gn_mish: out = mish(GroupNorm(conv1d_k(x) + bias)) over a
// channels-last trajectory, the U-Net's head (final_conv / act_conv).
//
// Replaces: autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:206
// `fused_conv1d_gn_mish` (body `_kernel`).
//
// Shapes: x (B, L, Cin) with L <= 16, w (K, Cin, C), bias/gamma/beta (C,),
// out (B, L, C), C a multiple of the groups; on the planner's path
// x (1-2, 16, 64), w (5, 64, 64), 8 groups.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The head moves
// 90 KB and does 0.33 MFLOP per batch row (a bound of 0.03 us), so what it
// costs is its launch, its round trip to device memory and the instructions
// and barriers on its critical path.
//
// Design. One CTA owns one (batch row, GroupNorm group), with no cluster: its
// whole working set fits in shared memory (on the path: the group's weight
// slice K x Cin x cg, 10 KB; the zero-padded input rows, 5 KB; bias, gamma and
// beta).
// 1. Every copy of the CTA is started at entry with cp.async and waited for
//    once: the weights do not depend on x, so they do not queue behind it.
//    The copy width (16, 4 or 2 bytes; 2 with plain loads, for odd bf16 rows)
//    is a template parameter chosen from the shape and the pointers
//    (ops/kernels.py:head_geometry); the K // 2 zero rows are written here.
//    When Cin takes more than one stage of shared memory, Cin streams through
//    a two-deep ring of channel chunks.
// 2. Thread (tile, s): a tile is P = 4 positions of one output channel, and its
//    K x Cin sum is split over S adjacent lanes of one warp, lane s taking the
//    channels s, s + S, ... for every tap. The P + K - 1 input rows a channel
//    needs sit in registers, so each weight is read once and used P times.
//    The S partial sums meet by __shfl_xor_sync. Rows are padded to an odd
//    number of copy units, so the lanes of neighbouring channels read
//    different banks.
// 3. conv + bias of the group's n = L x cg outputs go to shared memory; one
//    __syncthreads; then every warp takes the two-pass mean and variance over
//    those n values with shuffles, in the same fixed order, so every warp holds
//    the same statistics with no second barrier and no atomics, and the result
//    repeats bit for bit. Then normalise, Mish and store.
// On the path that is two CTA barriers in all. Every instruction a thread
// runs costs the SM threads / 128 cycles, so the host works out the layout,
// the loop bounds and multiply-shift divisors once per launch (Plan), and no
// thread divides; P = 4 keeps the CTA at 256 threads (a group's tiles must
// fit one CTA: cg x ceil(L / 4) <= 1024, else the launch is refused). TMA and
// wgmma are left out: with tens of FMAs a thread there is nothing for them to
// feed.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns the launch's CUDA error, or -1 for an unsupported
// dtype mix and -2 for a shape or geometry the kernel does not take.

#include <initializer_list>

#include "common.cuh"

using namespace adm;

namespace {

constexpr int KC = 5;  // taps a thread unrolls at a time: the planner's kernel size
constexpr int P = 4;   // positions of one output channel a thread holds

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Bytes of a shared-memory row of `nbytes`: an odd number of copy units (at
// least 4 bytes each), so that neighbouring rows start in different banks.
int odd_row(int nbytes, int W) {
  const int u = W > 4 ? W : 4;
  int n = (nbytes + u - 1) / u;
  if (n % 2 == 0) ++n;
  return n * u;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund-Montgomery).
struct FastDiv {
  unsigned mul, shift;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

FastDiv fast_div(int d) {
  unsigned shift = 0;
  while ((1u << shift) < (unsigned)d) ++shift;
  return {(unsigned)((((1ull << shift) - d) << 32) / d + 1), shift};
}

// What a launch needs besides its pointers, worked out once on the host.
// Shared memory, in bytes: bias, gamma, beta (cg values each, `par` apart);
// the group's n conv outputs (fp32) at `yc`; then one or two stage buffers of
// `buf` bytes from `buf0`, each the `rows` padded input rows of `stage`
// channels (`xrow` bytes apart) followed, at `xbytes`, by their K x stage
// weight rows (`wrow` bytes apart; row k * stage + ci). The wrapper computes
// the same total (ops/kernels.py:_head_smem), which launch_w checks: change
// the two together.
struct Plan {
  int L, Cin, C, K, cg, n, S, lgS, stage, nst, tiles;
  int rows, xrow, wrow, par, yc, buf0, xbytes, buf, total;
  int ux, uw;  // copy units of a stage's input row and of a weight row
  FastDiv by_ux, by_uw, by_stage, by_cg;
  float eps;
};

Plan make_plan(int L, int Cin, int C, int K, int groups, int S, int W, int stage, int ex, int ep,
               float eps) {
  Plan p;
  p.L = L, p.Cin = Cin, p.C = C, p.K = K, p.cg = C / groups, p.n = L * p.cg;
  p.S = S;
  p.lgS = 0;
  while ((1 << p.lgS) < S) ++p.lgS;
  p.stage = stage, p.nst = (Cin + stage - 1) / stage;
  p.tiles = p.cg * ((L + P - 1) / P);
  p.rows = (L + P - 1) / P * P + K - 1;
  p.xrow = odd_row(stage * ex, W);
  p.wrow = odd_row(p.cg * ep, W);
  p.par = round_up(p.cg * ep, 16);
  p.yc = 3 * p.par;
  p.buf0 = p.yc + round_up(p.n * 4, 16);
  p.xbytes = round_up(p.rows * p.xrow, 16);
  p.buf = p.xbytes + round_up(K * stage * p.wrow, 16);
  p.total = p.buf0 + (stage < Cin ? 2 : 1) * p.buf;
  p.ux = stage * ex / W;
  p.uw = p.cg * ep / W;
  p.by_ux = fast_div(p.ux), p.by_uw = fast_div(p.uw), p.by_stage = fast_div(stage);
  p.by_cg = fast_div(p.cg);
  p.eps = eps;
  return p;
}

// One copy unit of W bytes from device memory into shared memory: cp.async
// for 16 and 4 bytes; a plain load for 2 (cp.async copies 4, 8 or 16).
template <int W>
__device__ __forceinline__ void copy_unit(char* dst, const char* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *reinterpret_cast<unsigned short*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

template <int W>
__device__ __forceinline__ void zero_unit(char* dst) {
  if constexpr (W == 16) *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (W == 4) *reinterpret_cast<uint32_t*>(dst) = 0u;
  else *reinterpret_cast<unsigned short*>(dst) = 0;
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of stage t into `buf`: channels [c0, c0 + ch) of the
// padded input rows (row r is x row r - K / 2, or zeros) and of the group's
// weight rows. xb: batch row b of x; wg: the group's first weight column.
template <int W, typename TX, typename TP>
__device__ __forceinline__ void copy_stage(char* buf, const Plan& p, const TX* xb, const TP* wg,
                                            int t) {
  const int tid = threadIdx.x, nt = blockDim.x, pad = p.K / 2;
  const int c0 = t * p.stage, ch = min(p.stage, p.Cin - c0);
  const int uch = ch * (int)sizeof(TX) / W;  // units of this stage's rows
  for (int i = tid; i < p.rows * p.ux; i += nt) {
    const int r = p.by_ux(i), u = i - r * p.ux, l = r - pad;
    char* d = buf + r * p.xrow + u * W;
    if (u >= uch) continue;
    if (l >= 0 && l < p.L)
      copy_unit<W>(d, reinterpret_cast<const char*>(xb + (int64_t)l * p.Cin + c0) + u * W);
    else
      zero_unit<W>(d);
  }
  char* sw = buf + p.xbytes;
  for (int i = tid; i < p.K * p.stage * p.uw; i += nt) {
    const int row = p.by_uw(i), u = i - row * p.uw;
    const int k = p.by_stage(row), ci = row - k * p.stage;
    if (ci < ch)
      copy_unit<W>(sw + row * p.wrow + u * W,
                   reinterpret_cast<const char*>(wg + ((int64_t)k * p.Cin + c0 + ci) * p.C) + u * W);
  }
}

// acc[j] += sum over this lane's channels ci = s, s + S, ... < ch and taps k
// of row (j + k)[ci] * w[k][ci]: sx points at the tile's first padded input
// row, sw at its channel in the first weight row; xrow and wrow are row
// strides in elements, wtap the stride from one tap's weight rows to the
// next. The taps go KC at a time: their P + KC - 1 rows and KC weights are
// loaded together before any is used (a branch around each tap's load would
// expose every load's latency). K == KC, the planner's, is one straight run;
// another K goes in chunks of KC, a tap past K as a zero weight.
template <bool WHOLE, typename TX, typename TP>
__device__ __forceinline__ void taps(float (&acc)[P], const TX* xp, int xrow, const TP* wp,
                                     int wtap, int k0, int K) {
  float xr[P + KC - 1], wv[KC];
#pragma unroll
  for (int j = 0; j < P + KC - 1; ++j)
    xr[j] = WHOLE || k0 + j < P + K - 1 ? to_f(xp[(k0 + j) * xrow]) : 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k) wv[k] = WHOLE || k0 + k < K ? to_f(wp[(k0 + k) * wtap]) : 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = fmaf(xr[j + k], wv[k], acc[j]);
}

template <typename TX, typename TP>
__device__ __forceinline__ void split_dot(float (&acc)[P], const TX* sx, int xrow, const TP* sw,
                                          int wrow, int wtap, int ch, int K, int s, int S) {
  if (K == KC) {
#pragma unroll 2
    for (int ci = s; ci < ch; ci += S) taps<true>(acc, sx + ci, xrow, sw + ci * wrow, wtap, 0, K);
  } else {
    for (int ci = s; ci < ch; ci += S)
      for (int k0 = 0; k0 < K; k0 += KC)
        taps<false>(acc, sx + ci, xrow, sw + ci * wrow, wtap, k0, K);
  }
}

// Launched on a (groups, B) grid: CTA (g, b).
template <int W, typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(MAX_THREADS)
    conv1d_gn_mish_kernel(const TX* __restrict__ x, const TP* __restrict__ w,
                          const TP* __restrict__ bias, const TP* __restrict__ gamma,
                          const TP* __restrict__ beta, TO* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = blockIdx.x, b = blockIdx.y;
  const TP* sp = reinterpret_cast<const TP*>(smem);  // bias, gamma, beta
  const int spar = p.par / (int)sizeof(TP);
  float* yc = reinterpret_cast<float*>(smem + p.yc);
  const TX* xb = x + (int64_t)b * p.L * p.Cin;
  const TP* wg = w + g * p.cg;

  // every copy in flight at once: the parameters and the first one or two stages
  for (int i = tid; i < 3 * p.uw; i += nt) {
    const int j = p.by_uw(i), u = i - j * p.uw;
    const TP* src = (j == 0 ? bias : j == 1 ? gamma : beta) + g * p.cg;
    copy_unit<W>(smem + j * p.par + u * W, reinterpret_cast<const char*>(src) + u * W);
  }
  copy_stage<W>(smem + p.buf0, p, xb, wg, 0);
  cp_commit();
  if (p.nst > 1) {
    copy_stage<W>(smem + p.buf0 + p.buf, p, xb, wg, 1);
    cp_commit();
  }

  // thread = (tile q, lane s); tile q = (position block, channel c), c fastest
  const int s = tid & (p.S - 1), q = tid >> p.lgS;
  const bool active = q < p.tiles;
  const int pb = p.by_cg(q), c = q - pb * p.cg, l0 = pb * P;
  const int xrow = p.xrow / (int)sizeof(TX), wrow = p.wrow / (int)sizeof(TP);
  float acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0.f;
  for (int t = 0; t < p.nst; ++t) {
    if (t + 1 < p.nst) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();
    char* buf = smem + p.buf0 + (t & 1) * p.buf;
    if (active)
      split_dot(acc, reinterpret_cast<const TX*>(buf) + l0 * xrow, xrow,
                reinterpret_cast<const TP*>(buf + p.xbytes) + c, wrow, p.stage * wrow,
                min(p.stage, p.Cin - t * p.stage), p.K, s, p.S);
    if (t + 2 < p.nst) {
      __syncthreads();  // every thread is done with this buffer
      copy_stage<W>(buf, p, xb, wg, t + 2);
      cp_commit();
    }
  }

  // each output's S partial sums meet across the S adjacent lanes (every
  // lane of the warp takes part); lane 0 of the tile adds the bias
#pragma unroll
  for (int j = 0; j < P; ++j)
    for (int o = p.S >> 1; o > 0; o >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (active && s == 0) {
    const float bc = to_f(sp[c]);
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (l0 + j < p.L) yc[(l0 + j) * p.cg + c] = acc[j] + bc;
  }
  __syncthreads();

  // statistics of the group, two-pass; every warp sums the n outputs in the
  // same order, so every warp holds the same mean and variance
  const int lane = tid & 31;
  float s1 = 0.f;
  for (int o = lane; o < p.n; o += 32) s1 += yc[o];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  const float mean = s1 / p.n;
  float s2 = 0.f;
  for (int o = lane; o < p.n; o += 32) {
    const float d = yc[o] - mean;
    s2 = fmaf(d, d, s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  const float rstd = rsqrtf(s2 / p.n + p.eps);

  TO* ob = out + (int64_t)b * p.L * p.C + g * p.cg;
  for (int o = tid; o < p.n; o += nt) {
    const int l = p.by_cg(o), cl = o - l * p.cg;
    const float y = (yc[o] - mean) * rstd * to_f(sp[spar + cl]) + to_f(sp[2 * spar + cl]);
    store(ob, (int64_t)l * p.C + cl, mish(y));
  }
}

struct Args {
  const void *x, *w, *bias, *gamma, *beta;
  void* out;
  int B, groups, threads;
  cudaStream_t stream;
};

template <int W, typename TX, typename TP, typename TO>
int launch(const Args& a, const Plan& p) {
  auto kernel = conv1d_gn_mish_kernel<W, TX, TP, TO>;
  if (p.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.total);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.groups, a.B), a.threads, p.total, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TP*>(a.w), static_cast<const TP*>(a.bias),
      static_cast<const TP*>(a.gamma), static_cast<const TP*>(a.beta), static_cast<TO*>(a.out), p);
  return (int)cudaGetLastError();
}

template <typename TX, typename TP, typename TO>
int launch_w(const Args& a, int L, int Cin, int C, int K, float eps, int S, int width, int stage,
             int smem) {
  const int ex = sizeof(TX), ep = sizeof(TP);
  if (a.groups <= 0 || C % a.groups != 0 || L < 1 || L > MAX_L || K < 1 || Cin < 1 || a.B < 1)
    return -2;
  const int cg = C / a.groups;
  if (S < 1 || S > 32 || (S & (S - 1)) != 0) return -2;  // S lanes sit in one warp
  // one CTA holds the group's tiles: cg x ceil(L / P) of them, S threads each
  const long long tiles = (long long)cg * ((L + P - 1) / P);
  if (a.threads > MAX_THREADS || a.threads != round_up((int)(tiles * S), 32)) return -2;
  if (width != 16 && width != 4 && width != 2) return -2;
  if (stage < 1 || stage > Cin) return -2;
  if ((Cin * ex) % width || (cg * ep) % width || (stage * ex) % width) return -2;
  for (const void* ptr : {a.x, a.w, a.bias, a.gamma, a.beta})
    if (reinterpret_cast<uintptr_t>(ptr) % width) return -2;
  const Plan p = make_plan(L, Cin, C, K, a.groups, S, width, stage, ex, ep, eps);
  if (smem != p.total || smem > MAX_SMEM) return -2;
  if (width == 16) return launch<16, TX, TP, TO>(a, p);
  if (width == 4) return launch<4, TX, TP, TO>(a, p);
  if constexpr (sizeof(TX) == 2 || sizeof(TP) == 2) return launch<2, TX, TP, TO>(a, p);
  return -2;  // 2-byte copies only for bf16 rows of an odd length
}

}  // namespace

// x: (B, L, Cin) of x_dtype; w: (K, Cin, C), bias/gamma/beta: (C,) of p_dtype;
// out: (B, L, C) of out_dtype. S, width, stage, threads, smem: the launch
// geometry (ops/kernels.py:head_geometry): lanes sharing a sum, copy bytes,
// input channels a stage holds, threads of a CTA and its shared-memory bytes.
extern "C" int adm_conv1d_gn_mish(const void* x, const void* w, const void* bias,
                                  const void* gamma, const void* beta, int B, int L, int Cin,
                                  int C, int K, int groups, float eps, void* out, int x_dtype,
                                  int p_dtype, int out_dtype, int S, int width, int stage,
                                  int threads, int smem, void* stream) {
  const Args a{x, w, bias, gamma, beta, out, B, groups, threads, static_cast<cudaStream_t>(stream)};
#define ADM_HEAD(TX, TP, TO) \
  return launch_w<TX, TP, TO>(a, L, Cin, C, K, eps, S, width, stage, smem)
  if (p_dtype == DT_F32 && x_dtype == DT_F32 && out_dtype == DT_F32) ADM_HEAD(float, float, float);
  if (p_dtype == DT_BF16) {
    if (x_dtype == DT_BF16 && out_dtype == DT_BF16)
      ADM_HEAD(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16);
    if (x_dtype == DT_BF16 && out_dtype == DT_F32) ADM_HEAD(__nv_bfloat16, __nv_bfloat16, float);
    if (x_dtype == DT_F32 && out_dtype == DT_BF16) ADM_HEAD(float, __nv_bfloat16, __nv_bfloat16);
  }
#undef ADM_HEAD
  return -1;
}
