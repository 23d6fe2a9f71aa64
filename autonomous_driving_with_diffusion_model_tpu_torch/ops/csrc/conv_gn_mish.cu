// conv_gn_mish: one k-wide 1-D convolution + GroupNorm + Mish over a
// channels-last trajectory, with a fused epilogue. It serves the residual
// block only (ops/kernels.py); the U-Net's head has its own kernel,
// conv1d_gn_mish.cu:
//
//   fused_residual_block  = h   = conv_gn_mish(x) + mish(t) tw + tb  launch 1
//                           out = conv_gn_mish(h) + residual(x)      launch 2
//
// or, with FiLM conditioning (Diffusion Policy's ConditionalResidualBlock1D),
// launch 1 is h = s * conv_gn_mish(x) + b, [s | b] = mish(t) tw + tb with tw
// (E, 2C): the scale's C columns, then the shift's.
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
// The one-wave path (ONE_WAVE; ops/kernels.py:launch_path picks it when all
// B x groups clusters are co-resident and the slice fits). At batch 1-2 a
// launch is a chain of latencies, and none of its weights depend on the
// launch before it. So each CTA first issues 16-byte cp.async copies of its
// whole weight slice into shared memory (its rank's K x nc conv rows and nce
// epilogue rows, cg values each) and loads its group's bias, gamma, beta and
// epilogue bias into registers; then it waits on its predecessor
// (griddepcontrol.wait) and only then stages x, t and xres and writes
// anything to device memory; the dot products then read the weights from
// shared memory in the order split_dot reads them, and the later sums keep
// their order too (the peers' values are read before the first add), so at
// the same S the result is the other path's, bit for bit. A one-wave CTA
// holds at most ops/kernels.py:ONE_WAVE_THREADS threads, so that two share an
// SM and a launch's successor fits beside it; a smaller S sums in another
// order. Launched with programmatic dependent launch (`pdl`: the weights were
// not written just before), the launch and that fetch overlap the tail of
// the launch before; each CTA triggers its own dependents
// (griddepcontrol.launch_dependents) after its dot phase, so when a
// successor starts, every kernel before this one has completed. Without the
// attribute the wait and the trigger do nothing.
//
// The streamed path (ops/kernels.py:streamed_geometry; batch 1-2 where the
// one-wave slice does not fit shared memory: Diffusion Policy's 1024- and
// 2048-wide blocks, up to 88 MB of weights a launch). Clusters of 8 a group
// put 64 SMs to such a launch, each holding about 32 KB of 4-byte loads in
// flight: a fifth of HBM's rate. Here a launch is two kernels.
// conv_gn_mish_kernel_streamed cuts each group's weight rows (the conv's
// K x Cin, then the epilogue's Ce rows of each head, cg columns each) into
// `parts` contiguous slices, one CTA each: groups x parts CTAs, one an SM.
// A CTA streams its slice through a ring of STREAM_STAGES tiles of 16 KB in
// shared memory with 16-byte cp.async copies, nine tiles (144 KB) in
// flight; the first nine are issued before griddepcontrol.wait, since no
// weight depends on the launch before. After the wait it gathers the input
// value of each of its rows for all B x L (batch row, position) pairs into
// shared memory, so each weight is read from device memory once and used
// B x L times from registers. Thread (s, q) owns four columns (q) and every
// S-th row of a tile (s: S adjacent lanes); at the end of each segment the S
// lanes add their sums by a butterfly and one writes the CTA's partial sums
// of the segment, (B x L, cg), to a scratch in device memory (at most a few
// MB; it stays in L2). It lets its dependent launch once its last tile is
// under way. conv_gn_mish_kernel_finish, a cluster of FINISH_CLUSTER CTAs a
// (b, g), launched with programmatic dependent launch, stages its
// parameters, waits for the streaming half to end, lets the next launch
// start (its CTAs then arrive together and fill their rings meanwhile), adds
// the bias and every part's sums in part order for its slice of the
// outputs, meets its peers in distributed shared memory for the group's
// statistics (two-pass, fp32), and applies Mish and the epilogue (its
// projection summed the same way). Every sum runs in a fixed order, with no
// atomics, so a result repeats bit for bit. (Measured against this design
// on an H100: a ring of 6 slots, 1.2x slower on the widest launches; bulk
// (TMA) copies of 512-byte rows; prefetching further tiles into L2; fewer
// tiles before the wait; the finishing half as one CTA a (b, g) or letting
// the next launch start at its entry or end; both halves at the largest
// shared-memory carveout; each segment cut over all the parts.)
//
// The folded path (conv_gn_mish_kernel_folded; ops/kernels.py:folded_geometry;
// batch 3 and up where the slices fit shared memory). Above batch 2 the
// other paths give each (b, g) its own cluster, so each weight is read from
// device memory once per batch row and used L times a read. Here one cluster
// of cs CTAs (16 where the card holds a cluster of 16 for every group, else
// 8) owns group g for every batch row: rank r fetches its weight slice once,
// as the one-wave path does (copy_rows before griddepcontrol.wait), stages
// the zero-padded input rows of all B rows for its channels, and then
// computes a small GEMM: rows (b, l), the group's cg columns, K x nc terms.
// A thread holds a register tile of FOLD_PAIRS (batch row, position) pairs
// by four columns; for each of its channels it loads each batch row's window
// of TL + K - 1 positions and then each tap's four weights (one 16-byte
// shared load), so each weight read from shared memory feeds FOLD_PAIRS x 4
// products and each input value up to K x 4. S lanes share a tile's
// channels and meet by halving exchanges (each ends with its share of the
// tile, summed in one fixed order). The epilogue's projection is the same
// GEMM with one tap. Each rank writes its sums straight into the shared
// memory of the rank that owns those outputs (rank q owns the chunk [q n /
// cs, (q + 1) n / cs) of each batch row's n = L x cg outputs; the time
// projection's sums go to every position's owner), once every rank has
// started (a split cluster barrier opened at entry). After one cluster.sync
// each rank adds, for its chunk, the bias and every rank's sums in rank order
// from its own shared memory, takes each batch row's sum and sum of squared
// deviations over the chunk (two-pass) and writes both into every rank;
// after a second cluster.sync it combines the ranks' pairs in rank order into
// each row's mean and variance (Chan et al.'s pairwise update), normalises
// its chunk, applies Mish and the epilogue and writes it. No distributed
// access follows the second barrier. Every sum runs in a fixed order with no
// atomics, and all of it is float32 on CUDA cores. (Measured against this
// design on an H100: pulling the peers' sums after the barrier, the time
// projection's sums written L times by one lane each, unrolled rank sums.)
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
  EPI_FILM = 4,      // out = (mish(t[b]) . ew[:, c] + eb[c]) out + mish(t[b]) . ew[:, C + c] + eb[C + c]
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
// (ops/kernels.py:launch_geometry computes the same total). The one-wave
// path's weight slice follows, from a 16-byte boundary (slice_bytes).
struct Layout {
  int red, sp, sy, sye, yc, sres, sx, se, part, parte, total;
};

__host__ __device__ inline bool reduces(int epi) {  // the epilogue has a projection
  return epi == EPI_TBIAS || epi == EPI_RES_CONV || epi == EPI_FILM;
}
// Weight columns of the epilogue's projection per output channel: FiLM's
// scale and shift, else one.
__host__ __device__ inline int heads(int epi) { return epi == EPI_FILM ? 2 : 1; }

// Bytes of the one-wave path's weight slice: K x ceil(Cin / cs) conv rows and
// heads x ceil(Ce / cs) epilogue rows of cg values
// (ops/kernels.py:one_wave_geometry).
__host__ __device__ inline int slice_bytes(int Cin, int cg, int K, int cs, int epi, int Ce,
                                           int p_bytes) {
  return (K * ((Cin + cs - 1) / cs) + (reduces(epi) ? heads(epi) * ((Ce + cs - 1) / cs) : 0)) *
         cg * p_bytes;
}

__host__ __device__ inline Layout layout(int L, int Cin, int cg, int K, int S, int cs, int epi,
                                         int Ce) {
  const bool has_e = reduces(epi);
  // t is one row for every position; FiLM's two output rows are its scale
  // and its shift
  const int erows = epi == EPI_RES_CONV ? L : 1;
  if (!has_e) Ce = 0;
  const int n = L * cg, ne = has_e ? heads(epi) * erows * cg : 0;
  Layout o;
  o.red = 0;                                      // (32,) block_sum scratch
  o.sp = o.red + 32;                              // (3 + heads, cg) bias, gamma, beta,
                                                  // epilogue bias(es)
  o.sy = o.sp + (3 + heads(epi)) * cg;            // (n,) this rank's conv partial
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

// split_dot with the weights in shared memory: row j of the slice, cg values
// from wc (the thread's channel), in split_dot's order of j and of the sums.
template <int LMAX, int U, typename TP>
__device__ __forceinline__ void split_dot_smem(float (&acc)[LMAX], const float* rows, int stride,
                                               int rows_n, int nj, const TP* wc, int cg, int s,
                                               int S) {
  const TP* wp = wc + s * cg;
  const int step = S * cg;
  for (int j0 = s; j0 < nj; j0 += U * S) {
    float wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wv[u] = j0 + u * S < nj ? to_f(*wp) : 0.f;
      wp += step;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Rows of `bytes` each (a multiple of 16) from src, `pitch` bytes apart, into
// dst back to back, as 16-byte cp.async copies spread over the CTA. Row i is
// (k, ci) = (i / nc, i % nc), its source k * kpitch + ci * pitch.
__device__ __forceinline__ void copy_rows(char* dst, const char* src, int rows, int nc,
                                          int64_t kpitch, int64_t pitch, int bytes) {
  const int pieces = bytes / 16;
  for (int q = threadIdx.x; q < rows * pieces; q += blockDim.x) {
    const int i = q / pieces, piece = q - i * pieces;
    const int k = i / nc, ci = i - k * nc;
    cp_async16(dst + (int64_t)i * bytes + piece * 16, src + k * kpitch + ci * pitch + piece * 16);
  }
}

// Programmatic dependent launch (sm_90): wait until every grid this one
// depends on has completed and its writes are visible; let the dependent
// grid launch. Both do nothing in a launch without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// v + at(0) + at(1) + ... + at(cs - 1), in that order, with every rank's
// value read before the first add: the reads from peers' shared memory are
// in flight together rather than one after the other.
template <typename At>
__device__ __forceinline__ float rank_sum(float v, At at, int cs) {
  float t[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) t[q] = q < cs ? at(q) : 0.f;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < cs) v += t[q];
  return v;
}

// TX: conv input; TP: weights, biases and the epilogue input; TO: output.
// ein/ew/eb: the epilogue's input, weight and bias: t (B, Ce), tw, tb for
// EPI_TBIAS; t (B, Ce), tw (Ce, 2C), tb (2C,) for EPI_FILM; xres (B, L, Ce),
// wres, bres for EPI_RES_CONV; xres (B, L, C) alone for EPI_RES_ID. Launched
// in clusters of cs along x. ONE_WAVE: the one-wave path (see the header).
template <int LMAX, typename TX, typename TP, typename TO, bool ONE_WAVE = false>
__global__ void __launch_bounds__(MAX_THREADS)
    conv_gn_mish_kernel(const TX* __restrict__ x, const TP* __restrict__ w,
                        const TP* __restrict__ bias, const TP* __restrict__ gamma,
                        const TP* __restrict__ beta, int L, int Cin, int C, int K, int groups,
                        int S, float eps, int epi, const TP* __restrict__ ein, int Ce,
                        const TP* __restrict__ ew, const TP* __restrict__ eb,
                        TO* __restrict__ out) {
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
  const bool has_e = reduces(epi);
  const bool film = epi == EPI_FILM;
  const int erows = epi == EPI_RES_CONV ? L : 1;
  const int Cs = has_e ? Ce : 0;  // epilogue rows that are reduced
  const int ne = has_e ? heads(epi) * erows * cg : 0;
  const int epitch = film ? 2 * C : C;  // the epilogue weight's row

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

  // the one-wave path's weight slice: rows j = k * nc + ci of the conv, then
  // the nce epilogue rows (FiLM: the scale's, then the shift's), cg values
  // each, issued before the wait
  TP* ws = nullptr;
  TP* wse = nullptr;
  // this thread's bias, gamma, beta and epilogue bias(es)
  float pv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (ONE_WAVE) {
    ws = reinterpret_cast<TP*>(smem + (lay.total + 3) / 4 * 4);
    wse = ws + K * nc * cg;
    const int64_t pitch = (int64_t)C * sizeof(TP);
    const int row = cg * (int)sizeof(TP);
    copy_rows(reinterpret_cast<char*>(ws), reinterpret_cast<const char*>(w + (int64_t)c0 * C + g * cg),
              K * nc, nc, Cin * pitch, pitch, row);
    if (has_e)
      for (int hd = 0; hd < heads(epi); ++hd)
        copy_rows(reinterpret_cast<char*>(wse + hd * nce * cg),
                  reinterpret_cast<const char*>(ew + (int64_t)e0 * epitch + hd * C + g * cg), nce, nce, 0,
                  (int64_t)epitch * sizeof(TP), row);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < cg) {
      const int c = g * cg + tid;
      pv[0] = load(bias, c);
      pv[1] = load(gamma, c);
      pv[2] = load(beta, c);
      pv[3] = has_e ? load(eb, c) : 0.f;
      pv[4] = film ? load(eb, C + c) : 0.f;
    }
    grid_dependency_wait();
  }

  const TX* xb = x + (int64_t)b * L * Cin + c0;
  for (int i = tid; i < Lp * nc; i += nt) {
    const int l = i / nc - pad;
    sx[i] = (l >= 0 && l < L) ? load(xb, (int64_t)l * Cin + i % nc) : 0.f;
  }
  if (epi == EPI_TBIAS || film)
    for (int e = tid; e < nce; e += nt) se[e] = mish(load(ein, (int64_t)b * Ce + e0 + e));
  else if (epi == EPI_RES_CONV)
    for (int i = tid; i < L * nce; i += nt)
      se[i] = load(ein, ((int64_t)b * L + i / nce) * Ce + e0 + i % nce);
  // the epilogue's operands, loaded now so that no later step waits on memory
  if constexpr (ONE_WAVE) {
    if (tid < cg)
#pragma unroll
      for (int p = 0; p < 5; ++p)  // pv stays in registers
        if (p < 3 + heads(epi)) sp[p * cg + tid] = pv[p];
  } else {
    for (int i = tid; i < cg; i += nt) {
      const int c = g * cg + i;
      sp[i] = load(bias, c);
      sp[cg + i] = load(gamma, c);
      sp[2 * cg + i] = load(beta, c);
      sp[3 * cg + i] = has_e ? load(eb, c) : 0.f;
      if (film) sp[4 * cg + i] = load(eb, C + c);
    }
  }
  if (epi == EPI_RES_ID)
    for (int o = o0 + tid; o < o1; o += nt)
      sres[o - o0] = load(ein, ((int64_t)b * L + o / cg) * C + g * cg + o % cg);
  if constexpr (ONE_WAVE) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // partial sums of thread (s, cl) over its share of the rank's channels
  const int s = tid / cg, cl = tid % cg;
  if (s < S) {
    const int c = g * cg + cl;
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    if constexpr (ONE_WAVE)
      split_dot_smem<LMAX, U>(acc, sx, nc, L, K * nc, ws + cl, cg, s, S);
    else
      split_dot<LMAX, U>(acc, sx, nc, L, K * nc, w + (int64_t)c0 * C + c, Cin - nc, C, s, S);
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L) part[s * n + l * cg + cl] = acc[l];
    // the epilogue's projection: erows rows of one weight column, or
    // FiLM's one row of two (the scale's, then the shift's)
    if (has_e)
      for (int hd = 0; hd < heads(epi); ++hd) {
#pragma unroll
        for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
        if constexpr (ONE_WAVE)
          split_dot_smem<LMAX, U>(acc, se, nce, erows, nce, wse + hd * nce * cg + cl, cg, s, S);
        else
          split_dot<LMAX, U>(acc, se, nce, erows, nce, ew + (int64_t)e0 * epitch + hd * C + c, 0,
                             epitch, s, S);
#pragma unroll
        for (int l = 0; l < LMAX; ++l)
          if (l < erows) parte[s * ne + (hd + l) * cg + cl] = acc[l];
      }
  }
  __syncthreads();
  // past its wait and its weights: a dependent launch may start
  if constexpr (ONE_WAVE) launch_dependents();

  // 1. the rank's share of every output, summed over its S threads (the
  // one-wave path gives the epilogue's outputs threads of their own)
  if constexpr (ONE_WAVE) {
    for (int o = tid; o < n + ne; o += nt) {
      const float* p = o < n ? part + o : parte + (o - n);
      const int stride = o < n ? n : ne;
      float v = 0.f;
#pragma unroll 8
      for (int j = 0; j < S; ++j) v += p[j * stride];
      (o < n ? sy[o] : sye[o - n]) = v;
    }
  } else {
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
  }
  if (cs > 1) cluster.sync(); else __syncthreads();

  // 2. every output of the group: bias + every rank's share, in rank order.
  // Every rank computes all of them, in the same order, so all hold the same
  // statistics without exchanging them.
  float lsum = 0.f;
  for (int o = tid; o < n; o += nt) {
    float v = sp[o % cg];
    if constexpr (ONE_WAVE)
      v = rank_sum(v, [&](int q) { return peer(sy, q)[o]; }, cs);
    else
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

  // 4. this rank's chunk: normalise, Mish, epilogue
  for (int o = o0 + tid; o < o1; o += nt) {
    const int l = o / cg, ol = o % cg, c = g * cg + ol;
    float y = mish((yc[o] - mean) * rstd * sp[cg + ol] + sp[2 * cg + ol]);
    if (film) {
      float sc = sp[3 * cg + ol], sh = sp[4 * cg + ol];
      if constexpr (ONE_WAVE) {
        sc = rank_sum(sc, [&](int q) { return peer(sye, q)[ol]; }, cs);
        sh = rank_sum(sh, [&](int q) { return peer(sye, q)[cg + ol]; }, cs);
      } else {
        for (int q = 0; q < cs; ++q) sc += peer(sye, q)[ol];
        for (int q = 0; q < cs; ++q) sh += peer(sye, q)[cg + ol];
      }
      y = fmaf(sc, y, sh);
    } else if (has_e) {
      const int eo = (epi == EPI_TBIAS ? 0 : l) * cg + ol;
      float e = sp[3 * cg + ol];
      if constexpr (ONE_WAVE)
        e = rank_sum(e, [&](int q) { return peer(sye, q)[eo]; }, cs);
      else
        for (int q = 0; q < cs; ++q) e += peer(sye, q)[eo];
      y += e;
    } else if (epi == EPI_RES_ID) {
      y += sres[o - o0];
    }
    store(out, ((int64_t)b * L + l) * C + c, y);
  }
  if (cs > 1) cluster.sync();  // peers may still read this CTA's sy and sye
}

// ---------------------------------------------------------------- the streamed path

constexpr int STREAM_STAGES = 10;         // ring slots of weight tiles
constexpr int FINISH_CLUSTER = 8;         // CTAs finishing one (batch row, group)
constexpr int STREAM_TILE_BYTES = 16384;  // weight bytes a tile holds, before the rows' skew
constexpr int STREAM_THREADS = 512;       // threads of a streaming CTA at most
constexpr int STREAM_MAX_ROWS = 16;       // B x L a streaming thread sums at most
constexpr int MAX_SEGS = 3;               // the conv, then one or two epilogue heads

// The weight rows of a streamed launch, in the order its CTAs cut them: the
// conv's K x Cin rows (row k Cin + ci of the (K, Cin, C) weights), then each
// epilogue head's Ce rows (FiLM: the scale's columns, then the shift's).
// Segment s holds rows [begin[s], begin[s + 1]); its input has pos[s]
// positions a batch row (L, or 1 for the time projection's one row).
struct Segments {
  int n, rows, begin[MAX_SEGS + 1], pos[MAX_SEGS];
};

__host__ __device__ inline Segments segments(int L, int Cin, int K, int epi, int Ce) {
  Segments sg;
  const int nh = reduces(epi) ? heads(epi) : 0;
  sg.n = 1 + nh;
  sg.begin[0] = 0;
  sg.pos[0] = L;
  for (int s = 1; s <= MAX_SEGS; ++s) {
    sg.begin[s] = s == 1 ? K * Cin : sg.begin[s - 1] + (s - 1 <= nh ? Ce : 0);
    if (s < MAX_SEGS) sg.pos[s] = epi == EPI_RES_CONV ? L : 1;
  }
  sg.rows = sg.begin[sg.n];
  return sg;
}

// S: the adjacent lanes of a warp that share one column quad's rows, the
// largest power of two up to 32 that keeps a CTA within STREAM_THREADS
__host__ __device__ inline int stream_split(int cq) {
  int S = 1;
  while (S * 2 <= 32 && S * 2 * cq <= STREAM_THREADS) S *= 2;
  return S;
}
// rows of a tile: those of STREAM_TILE_BYTES, a multiple of S
__host__ __device__ inline int stream_tile_rows(int row_bytes, int S) {
  const int r = STREAM_TILE_BYTES / row_bytes / S * S;
  return r > S ? r : S;
}
// bytes of a ring row: its weights, then a skew that puts the rows that a
// warp's quarter reads at once (16-byte loads) in different banks
__host__ __device__ inline int stream_pitch(int row_bytes, int S) {
  return row_bytes + 16 * (S < 8 ? 8 / S : 1);
}
// the (batch row, position) pairs a thread sums: 4, 8 or 16 (a template argument)
__host__ __device__ inline int stream_nr(int rows) { return rows <= 4 ? 4 : rows <= 8 ? 8 : 16; }
// shared memory of a streaming CTA: the ring, then its rows' inputs
// (ops/kernels.py:streamed_geometry computes the same)
__host__ __device__ inline int stream_smem(int row_bytes, int S, int rows, int parts, int nr) {
  return STREAM_STAGES * stream_tile_rows(row_bytes, S) * stream_pitch(row_bytes, S) +
         (rows + parts - 1) / parts * nr * 4;
}
// the slice (slice_begin over `parts`) of n rows that holds row j
__host__ __device__ inline int part_of(int j, int n, int parts) {
  return (int)(((int64_t)(j + 1) * parts - 1) / n);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive weights of a ring row, as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// The streaming half of a streamed launch (see the header): CTA g * parts + p
// sums slice p of group g's weight rows over all B x L pairs into
// part_out[((seg * groups + g) * parts + p) * B * L + b * pos + l][cg] for
// every segment it touches. NR >= B x L.
template <int NR, typename TX, typename TP>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
    conv_gn_mish_kernel_streamed(const TX* __restrict__ x, const TP* __restrict__ w, int B, int L,
                                 int Cin, int C, int K, int groups, int epi,
                                 const TP* __restrict__ ein, int Ce, const TP* __restrict__ ew,
                                 int parts, float* __restrict__ part_out) {
  extern __shared__ float smem[];
  const int g = blockIdx.x / parts, p = blockIdx.x - g * parts;
  const int cg = C / groups, cq = cg / 4;
  const int S = stream_split(cq);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int s = tid % S, q = tid / S;  // a row phase and a column quad
  const Segments sg = segments(L, Cin, K, epi, Ce);
  const int row_bytes = cg * (int)sizeof(TP);
  const int pitch = stream_pitch(row_bytes, S), tile_rows = stream_tile_rows(row_bytes, S);
  const int stage = tile_rows * pitch;
  char* ring = reinterpret_cast<char*>(smem);
  float* xs = reinterpret_cast<float*>(ring + STREAM_STAGES * stage);  // (its rows, NR)
  const int epitch = heads(epi) * C;  // an epilogue weight row, in elements

  // this CTA's rows [r0, r1) of all the segments' rows; of each segment,
  // [lo, hi), and the tiles before each
  const int r0 = slice_begin(sg.rows, parts, p), r1 = slice_begin(sg.rows, parts, p + 1);
  int lo[MAX_SEGS], hi[MAX_SEGS], first[MAX_SEGS + 1];
  first[0] = 0;
#pragma unroll
  for (int k = 0; k < MAX_SEGS; ++k) {
    lo[k] = max(r0, sg.begin[k]);
    hi[k] = max(lo[k], min(r1, sg.begin[k + 1]));
    first[k + 1] = first[k] + (hi[k] - lo[k] + tile_rows - 1) / tile_rows;
  }
  const int ntiles = first[MAX_SEGS];
  // tile t: its segment k, its first row j0 and its n rows
  auto tile = [&](int t, int& k, int& j0, int& n) {
    k = t >= first[1] ? (t >= first[2] ? 2 : 1) : 0;
    j0 = lo[k] + (t - first[k]) * tile_rows;
    n = min(tile_rows, hi[k] - j0);
  };
  const int pieces = row_bytes / 16;
  auto issue = [&](int t) {
    int k, j0, n;
    tile(t, k, j0, n);
    const char* src = k == 0 ? reinterpret_cast<const char*>(w + (int64_t)j0 * C + g * cg)
                             : reinterpret_cast<const char*>(ew + (int64_t)(j0 - sg.begin[k]) * epitch +
                                                             (k - 1) * C + g * cg);
    const int64_t spitch = (int64_t)(k == 0 ? C : epitch) * sizeof(TP);
    char* dst = ring + (t % STREAM_STAGES) * stage;
    for (int i = tid; i < n * pieces; i += nt) {
      const int r = i / pieces, pc = i - r * pieces;
      cp_async16(dst + r * pitch + pc * 16, src + r * spitch + pc * 16);
    }
  };

  // the first tiles do not depend on the launch before
  for (int t = 0; t < STREAM_STAGES - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }
  grid_dependency_wait();

  // every row's input for each (b, l): xs[r][b * pos + l], zero past B
  const int nrow = r1 - r0, pad = K / 2, total = nrow * NR;
  auto xval = [&](int i) -> float {
    const int nr = i / nrow, j = r0 + (i - nr * nrow);
    const int k = j >= sg.begin[1] ? (j >= sg.begin[2] ? 2 : 1) : 0;
    const int lp = k == 0 ? L : sg.pos[k];
    const int b = nr / lp, l = nr - b * lp;
    if (b >= B) return 0.f;
    if (k == 0) {
      const int tap = j / Cin, ci = j - tap * Cin, ll = l + tap - pad;
      return ll >= 0 && ll < L ? load(x, ((int64_t)b * L + ll) * Cin + ci) : 0.f;
    }
    const int e = j - sg.begin[k];
    return epi == EPI_RES_CONV ? load(ein, ((int64_t)b * L + l) * Ce + e)
                               : mish(load(ein, (int64_t)b * Ce + e));
  };
  for (int i0 = tid; i0 < total; i0 += 8 * nt) {  // rows fastest: neighbours read neighbouring channels
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = i0 + u * nt < total ? xval(i0 + u * nt) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nt, nr = i / nrow;
      if (i < total) xs[(i - nr * nrow) * NR + nr] = v[u];
    }
  }

  float acc[NR][4];
#pragma unroll
  for (int m = 0; m < NR; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[m][v] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STREAM_STAGES - 2>();
    __syncthreads();  // tile t in every thread's view; every thread done with tile t - 1's slot
    if (t + STREAM_STAGES - 1 < ntiles) issue(t + STREAM_STAGES - 1);
    cp_async_commit();
    int k, j0, n;
    tile(t, k, j0, n);
    if (t + 1 == ntiles) launch_dependents();  // past its last weight
    if (q < cq) {
      const char* wt = ring + (t % STREAM_STAGES) * stage + q * 4 * (int)sizeof(TP);
      const float* xt = xs + (j0 - r0) * NR;
      for (int r = s; r < n; r += S) {
        float wv[4];
        load4(reinterpret_cast<const TP*>(wt + r * pitch), wv);
        const float4* xr = reinterpret_cast<const float4*>(xt + r * NR);
#pragma unroll
        for (int m = 0; m < NR / 4; ++m) {
          const float4 xv = xr[m];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[4 * m][v] = fmaf(xv.x, wv[v], acc[4 * m][v]);
            acc[4 * m + 1][v] = fmaf(xv.y, wv[v], acc[4 * m + 1][v]);
            acc[4 * m + 2][v] = fmaf(xv.z, wv[v], acc[4 * m + 2][v]);
            acc[4 * m + 3][v] = fmaf(xv.w, wv[v], acc[4 * m + 3][v]);
          }
        }
      }
    }
    if (t + 1 == first[k + 1]) {  // the segment's last tile: its sums out
#pragma unroll
      for (int m = 0; m < NR; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float a = acc[m][v];
          for (int o = 1; o < S; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          acc[m][v] = a;
        }
      const int nrs = B * (k == 0 ? L : sg.pos[k]);
      if (s == 0 && q < cq) {
        float* dst = part_out + (((int64_t)k * groups + g) * parts + p) * B * L * cg + 4 * q;
#pragma unroll
        for (int m = 0; m < NR; ++m)
          if (m < nrs)
            *reinterpret_cast<float4*>(dst + (int64_t)m * cg) =
                make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
#pragma unroll
      for (int m = 0; m < NR; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][v] = 0.f;
    }
  }
}

// The finishing half of a streamed launch: a cluster of FINISH_CLUSTER
// CTAs a (batch row, group), b * groups + g; rank r adds the bias and every
// part's sums (conv and epilogue) of its slice of the group's L x cg
// outputs, in part order, one output a thread with all its loads in flight;
// the ranks' sums meet in distributed shared memory, in rank order, for the
// group's statistics (two-pass, fp32, the same in every rank); then each
// rank writes mish(gn(.)) with the epilogue for its slice. Launched with
// programmatic dependent launch behind the streaming half: it stages its
// parameters before the wait and lets the next launch start once the
// streaming half is over, so that launch's CTAs arrive together and fill
// their rings while this one works.
template <typename TP, typename TO>
__global__ void __launch_bounds__(MAX_THREADS)
    conv_gn_mish_kernel_finish(const float* part, const TP* __restrict__ bias,
                               const TP* __restrict__ gamma, const TP* __restrict__ beta, int B,
                               int L, int Cin, int C, int K, int groups, int parts, float eps,
                               int epi, const TP* __restrict__ ein, int Ce,
                               const TP* __restrict__ eb, TO* __restrict__ out) {
  extern __shared__ float smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int cs = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int bg = blockIdx.x / cs, b = bg / groups, g = bg % groups;
  const int cg = C / groups, n = L * cg, nrs = B * L;
  const int o0 = slice_begin(n, cs, r), o1 = slice_begin(n, cs, r + 1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool film = epi == EPI_FILM;
  float* red = smem;
  float* stat = smem + 32;   // (4,) this rank's sum, then its sum of squares
  float* sp = smem + 36;     // (5, cg) bias, gamma, beta, the epilogue bias(es)
  float* yc = sp + 5 * cg;   // (o1 - o0,) conv + bias
  float* ye = yc + (n + cs - 1) / cs;  // (2, o1 - o0) the epilogue's terms
  const int chunk = (n + cs - 1) / cs;
  for (int i = tid; i < cg; i += nt) {  // the parameters do not depend on the launch before
    const int c = g * cg + i;
    sp[i] = load(bias, c);
    sp[cg + i] = load(gamma, c);
    sp[2 * cg + i] = load(beta, c);
    sp[3 * cg + i] = reduces(epi) ? load(eb, c) : 0.f;
    sp[4 * cg + i] = film ? load(eb, C + c) : 0.f;
  }
  grid_dependency_wait();  // the partial sums are the launch before's
  launch_dependents();
  __syncthreads();
  const Segments sg = segments(L, Cin, K, epi, Ce);
  // v + segment k's sums of pair nr, channel c, over the parts that hold
  // any of its rows, in part order, 16 loads in flight
  auto sum = [&](int k, int nr, int c, float v) {
    const int p0 = part_of(sg.begin[k], sg.rows, parts);
    const int p1 = part_of(sg.begin[k + 1] - 1, sg.rows, parts);
    const float* src = part + (((int64_t)k * groups + g) * parts * nrs + nr) * cg + c;
    const int64_t stride = (int64_t)nrs * cg;
    for (int pp = p0; pp <= p1; pp += 16) {
      float t[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) t[u] = pp + u <= p1 ? src[(pp + u) * stride] : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (pp + u <= p1) v += t[u];
    }
    return v;
  };
  float lsum = 0.f;
  for (int o = o0 + tid; o < o1; o += nt) {
    const int l = o / cg, c = o - l * cg;
    const float v = sum(0, b * L + l, c, sp[c]);
    float e0 = 0.f, e1 = 0.f;
    if (film) {
      e0 = sum(1, b, c, sp[3 * cg + c]);
      e1 = sum(2, b, c, sp[4 * cg + c]);
    } else if (epi == EPI_TBIAS) {
      e0 = sum(1, b, c, sp[3 * cg + c]);
    } else if (epi == EPI_RES_CONV) {
      e0 = sum(1, b * L + l, c, sp[3 * cg + c]);
    } else {
      e0 = load(ein, ((int64_t)b * L + l) * C + g * cg + c);
    }
    yc[o - o0] = v;
    ye[o - o0] = e0;
    ye[chunk + o - o0] = e1;
    lsum += v;
  }
  // the group's statistics: every rank adds the ranks' sums in rank order
  auto all_ranks = [&](float mine, int slot) {
    mine = block_sum(mine, red);
    if (tid == 0) stat[slot] = mine;
    cluster.sync();
    float v = 0.f;
    for (int q = 0; q < cs; ++q) v += *cluster.map_shared_rank(stat + slot, q);
    return v;
  };
  const float mean = all_ranks(lsum, 0) / n;
  float lsq = 0.f;
  for (int o = o0 + tid; o < o1; o += nt) {
    const float d = yc[o - o0] - mean;
    lsq += d * d;
  }
  const float rstd = rsqrtf(all_ranks(lsq, 1) / n + eps);
  for (int o = o0 + tid; o < o1; o += nt) {
    const int l = o / cg, c = o - l * cg;
    const float y = mish((yc[o - o0] - mean) * rstd * sp[cg + c] + sp[2 * cg + c]);
    const float e0 = ye[o - o0], e1 = ye[chunk + o - o0];
    store(out, ((int64_t)b * L + l) * C + g * cg + c, film ? fmaf(e0, y, e1) : y + e0);
  }
  cluster.sync();  // peers may still read this CTA's statistics
}

// ---------------------------------------------------------------- the folded path

constexpr int FOLD_THREADS = 512;     // threads of a folded CTA at most: two share an SM
constexpr int FOLD_MAX_CLUSTER = 16;  // H100's non-portable cluster size
constexpr int FOLD_PAIRS = 4;         // (batch row, position) pairs of a thread's register tile
constexpr int FOLD_MAX_K = 5;         // taps a thread's input window covers
constexpr int FOLD_MAX_SPLIT = 4;     // adjacent tiles' lanes sharing one tile's channels

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) / 4 * 4; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// positions of a register tile over `pos` positions: 1, 2 or 4; its batch
// rows are FOLD_PAIRS over that. A thread loads an input window of the tile's
// positions and the taps after them in pieces of that many floats.
__host__ __device__ inline int fold_tl(int pos) { return pos <= 1 ? 1 : pos <= 2 ? 2 : 4; }
// floats between two staged input rows: every position of the padded row and
// every piece a window loads from the last tile, in whole pieces
__host__ __device__ inline int fold_pitch(int pos, int taps, int kmax) {
  const int tl = fold_tl(pos), ntl = cdiv(pos, tl);
  return cdiv(imax(pos + taps - 1, (ntl - 1) * tl + cdiv(tl + kmax - 1, tl) * tl), tl) * tl;
}

// A folded CTA's register tiles, threads and shared memory: offsets in floats
// (each from a 16-byte boundary) and their total, after which the weight
// slice follows (slice_bytes). ops/kernels.py:folded_geometry computes the same.
struct FoldLayout {
  int tl;          // the conv's tile positions
  int nbx, nbe;    // batch rows staged: B rounded up to whole tiles of the conv and of the epilogue
  int S, threads;  // lanes sharing one tile's channels, threads of a CTA
  int xp, ep;      // floats between two staged input rows, the conv's and the epilogue's
  int rowst, cnt, sp, recv, recve, sres, sx, se, sye, stat, yc, total;
};

__host__ __device__ inline int take(int& at, int floats) {
  const int o = at;
  at += round4(floats);
  return o;
}

__host__ __device__ inline FoldLayout fold_layout(int B, int L, int Cin, int cg, int K, int cs, int epi,
                                                  int Ce) {
  FoldLayout f;
  const bool has_e = reduces(epi);
  const int erows = epi == EPI_RES_CONV ? L : 1, nh = has_e ? heads(epi) : 0;
  const int n = L * cg, chunk = cdiv(n, cs), nc = cdiv(Cin, cs), nce = has_e ? cdiv(Ce, cs) : 0;
  f.tl = fold_tl(L);
  const int tb = FOLD_PAIRS / f.tl, etb = FOLD_PAIRS / fold_tl(erows);
  f.nbx = cdiv(B, tb) * tb;
  f.nbe = cdiv(B, etb) * etb;
  const int items = f.nbx / tb * cdiv(L, f.tl) * (cg / 4);  // the conv's tiles of four columns
  f.S = 1;
  while (f.S * 2 <= FOLD_MAX_SPLIT && f.S * 2 <= nc && items * f.S * 2 <= FOLD_THREADS) f.S *= 2;
  const int t = cdiv(items, 32 / f.S) * 32;
  f.threads = t < FOLD_THREADS ? t : FOLD_THREADS;
  f.xp = fold_pitch(L, K, FOLD_MAX_K);
  f.ep = fold_pitch(erows, 1, 1);
  int at = 0;
  f.rowst = take(at, B * 2);  // (B, 2) this rank's (sum, M2), then the group's (mean, rstd)
  f.cnt = take(at, 2 * cs);   // (2, cs) each rank's outputs of a batch row, 1 over that
  f.sp = take(at, 5 * cg);    // (5, cg) bias, gamma, beta, the epilogue bias(es)
  f.recv = take(at, cs * B * chunk);                     // (cs, B, chunk) every rank's conv sums of the chunk
  f.recve = take(at, nh * cs * B * chunk);               // (heads, cs, B, chunk) their epilogue sums
  f.sres = take(at, epi == EPI_RES_ID ? B * chunk : 0);  // (B, chunk) the chunk's residual
  // before the first cluster.sync: the staged inputs and the time
  // projection's sums; after it, in the same bytes: the ranks' statistics
  // (which peers write only once past that barrier) and the chunk's values
  const int before = at;
  f.sx = take(at, f.nbx * nc * f.xp);  // (nbx, nc, xp) input rows
  f.se = take(at, f.nbe * nce * f.ep);  // (nbe, nce, ep) epilogue input
  f.sye = take(at, erows == 1 ? nh * B * cg : 0);  // (heads, B, cg) the time projection's sums
  const int after = at;
  at = before;
  f.stat = take(at, cs * B * 2);  // (cs, B, 2) every rank's (sum, M2) of each batch row, pushed by it
  f.yc = take(at, B * chunk);     // (B, chunk) conv + bias of the chunk
  f.total = imax(at, after);
  return f;
}

// p in rank q's shared memory (this CTA's own for q == r)
__device__ __forceinline__ float* peer_of(coop::cluster_group& cluster, int r, float* p, int q) {
  return q == r ? p : cluster.map_shared_rank(p, q);
}

// N floats from p (aligned to TL floats) in pieces of TL
template <int TL, int N>
__device__ __forceinline__ void load_window(const float* p, float (&v)[N]) {
#pragma unroll
  for (int u = 0; u < N; u += TL) {
    if constexpr (TL == 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + u);
      v[u] = a.x, v[u + 1] = a.y, v[u + 2] = a.z, v[u + 3] = a.w;
    } else if constexpr (TL == 2) {
      const float2 a = *reinterpret_cast<const float2*>(p + u);
      v[u] = a.x, v[u + 1] = a.y;
    } else {
      v[u] = p[u];
    }
  }
}

// acc[tb][l][v] += sum over the channels ci = s, s + S, ... < nch and taps
// k < K of xs[(tb * nch + ci) * xp + l + k] * w[(k * nch + ci) * cg + v]:
// one register tile's products, xs at the tile's first batch row and
// position, w at its four columns (weights in shared memory, cg a row). Per
// channel the batch rows' windows are loaded first, then each tap's four
// weights, each feeding the tile's FOLD_PAIRS x 4 products.
template <int TL, int KMAX, typename TP>
__device__ __forceinline__ void fold_dot(float (&acc)[FOLD_PAIRS / TL][TL][4], const float* xs, int xp,
                                         int nch, int K, const TP* w, int cg, int s, int S) {
  constexpr int TB = FOLD_PAIRS / TL, NW = (TL + KMAX - 1 + TL - 1) / TL * TL;  // a window's floats
  for (int ci = s; ci < nch; ci += S) {
    float xw[TB][NW];
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) load_window<TL>(xs + (tb * nch + ci) * xp, xw[tb]);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) {
        float wq[4];
        load4(w + (k * nch + ci) * cg, wq);
#pragma unroll
        for (int tb = 0; tb < TB; ++tb)
#pragma unroll
          for (int l = 0; l < TL; ++l)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[tb][l][v] = fmaf(xw[tb][l + k], wq[v], acc[tb][l][v]);
      }
  }
}

// dst[(b * nch + ci) * pitch + pad + p] = f(src[(b * P + p) * row + c0 + ci])
// for b < B, p < P, ci < nch; every other float of the nb * nch rows of
// `pitch` zero. Four channels a load where the row, the slice and the
// pointer allow it, four loads in flight a thread.
template <typename T, typename F>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int B, int nb, int P, int row,
                                           int c0, int nch, int pitch, int pad, F f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool vec = row % 4 == 0 && c0 % 4 == 0 && nch % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  const int W = vec ? 4 : 1, nu = nch / W, total = B * P * nu;
  for (int i0 = tid; i0 < total; i0 += 4 * nt) {
    float v[4][4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt;
      at[u] = -1;
      if (i < total) {
        const int bp = i / nu, cu = i - bp * nu, b = bp / P, p = bp - b * P;
        const T* s = src + ((int64_t)b * P + p) * row + c0 + cu * W;
        at[u] = (b * nch + cu * W) * pitch + pad + p;
        if (vec)
          load4(s, v[u]);
        else
          v[u][0] = load(s, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0)
        for (int j = 0; j < W; ++j) dst[at[u] + j * pitch] = f(v[u][j]);
  }
  for (int i = tid; i < nb * nch; i += nt) {  // zeros: the padding, and the rows past B
    float* d = dst + i * pitch;
    const bool real = i < B * nch;
    for (int p = 0; p < pitch; ++p)
      if (!real || p < pad || p >= pad + P) d[p] = 0.f;
  }
}

// One folded GEMM of a CTA: for every head hd < nheads, batch row b < B,
// position p < P and four columns c..c+3 (c a multiple of 4 below cg),
// store(hd, b, p, c, v) with v[j] the sum over the channels ci < nch and taps
// k < K of xs[(b * nch + ci) * xp + p + k] * w[hd * hstride + (k * nch + ci) *
// cg + c + j]. Tiles of TB x TL pairs by four columns go to `lanes` adjacent
// lanes of a warp at a time, each tile's channels split over S = 32 / lanes
// lanes (1, 2 or 4), `lanes` apart. Their sums meet by halving exchanges
// (lane s keeps the pairs of its bits, adds its partner's), so each of the
// S lanes ends with FOLD_PAIRS / S of the tile's pairs, summed over all S in
// the same order in every lane, and stores them.
template <int TL, int KMAX, typename TP, typename Store>
__device__ __forceinline__ void fold_gemm(const float* xs, int xp, int nch, int K, const TP* w,
                                          int hstride, int nheads, int B, int P, int cg, int S,
                                          Store store) {
  constexpr int TB = FOLD_PAIRS / TL;
  const int lanes = 32 / S, lane = threadIdx.x & 31;
  const int s = lane / lanes, li = lane - s * lanes;
  const int nq = cg / 4, ntl = cdiv(P, TL), nbt = cdiv(B, TB);
  const int items = nheads * nbt * ntl * nq;
  for (int it0 = (threadIdx.x >> 5) * lanes; it0 < items; it0 += (blockDim.x >> 5) * lanes) {
    const int it = it0 + li;  // it0 is the same in every lane of the warp
    int m = it / nq;
    const int q = it - m * nq;
    const int lt = m % ntl;
    m /= ntl;
    const int bt = m % nbt, hd = m / nbt;
    float acc[TB][TL][4];
#pragma unroll
    for (int tb = 0; tb < TB; ++tb)
#pragma unroll
      for (int l = 0; l < TL; ++l)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[tb][l][v] = 0.f;
    if (it < items)
      fold_dot<TL, KMAX>(acc, xs + bt * TB * nch * xp + lt * TL, xp, nch, K, w + hd * hstride + 4 * q, cg, s,
                         S);
    float* a = &acc[0][0][0];  // pair j = tb * TL + l at a[4 j]
    int first = 0;             // the first pair this lane holds
    if (S > 1) {               // pairs 0-1 to the lane with s bit 0 clear, 2-3 to the other
      const bool hi = s & 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float mine = hi ? a[8 + j] : a[j], theirs = hi ? a[j] : a[8 + j];
        a[j] = mine + __shfl_xor_sync(0xffffffffu, theirs, lanes);
      }
      first = hi ? 2 : 0;
    }
    if (S > 2) {  // then one pair to each by s bit 1
      const bool hi = s & 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float mine = hi ? a[4 + j] : a[j], theirs = hi ? a[j] : a[4 + j];
        a[j] = mine + __shfl_xor_sync(0xffffffffu, theirs, 2 * lanes);
      }
      first += hi ? 1 : 0;
    }
    if (it < items) {
      const int held = FOLD_PAIRS / S;
#pragma unroll
      for (int k = 0; k < FOLD_PAIRS; ++k)
        if (k < held) {
          const int j = first + k, b = bt * TB + j / TL, p = lt * TL + j % TL;
          if (b < B && p < P) store(hd, b, p, 4 * q, *reinterpret_cast<const float(*)[4]>(a + 4 * k));
        }
    }
  }
}

// cluster barrier halves: arrive (relaxed: orders nothing) and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The folded path (see the header): cluster g of cs CTAs (blockIdx.x = g * cs
// + r) owns group g of every batch row; rank r the input channels [c0, c0 +
// nc), the epilogue rows [e0, e0 + nce) and the outputs [o0, o0 + no) of each
// batch row. TL: the conv's register tile positions, fold_tl(L).
template <int TL, typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(FOLD_THREADS, 2)
    conv_gn_mish_kernel_folded(const TX* __restrict__ x, const TP* __restrict__ w,
                               const TP* __restrict__ bias, const TP* __restrict__ gamma,
                               const TP* __restrict__ beta, int B, int L, int Cin, int C, int K,
                               int groups, float eps, int epi, const TP* __restrict__ ein, int Ce,
                               const TP* __restrict__ ew, const TP* __restrict__ eb,
                               TO* __restrict__ out) {
  extern __shared__ float smem[];
  coop::cluster_group cluster = coop::this_cluster();
  // every rank has started before any rank writes into a peer (the wait
  // before the first push)
  cluster_arrive_relaxed();
  const int cs = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int g = blockIdx.x / cs;
  const int cg = C / groups, n = L * cg, pad = K / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool has_e = reduces(epi), film = epi == EPI_FILM;
  const int erows = epi == EPI_RES_CONV ? L : 1, nh = has_e ? heads(epi) : 0;
  const int Cs = has_e ? Ce : 0;
  const int epitch = film ? 2 * C : C;  // the epilogue weight's row
  const FoldLayout f = fold_layout(B, L, Cin, cg, K, cs, epi, Ce);
  float* stat = smem + f.stat;
  float* rowst = smem + f.rowst;
  float* cnt = smem + f.cnt;
  float* sp = smem + f.sp;
  float* recv = smem + f.recv;
  float* recve = smem + f.recve;
  float* yc = smem + f.yc;
  float* sres = smem + f.sres;
  float* sx = smem + f.sx;
  float* se = smem + f.se;
  const int c0 = slice_begin(Cin, cs, r), nc = slice_begin(Cin, cs, r + 1) - c0;
  const int e0 = slice_begin(Cs, cs, r), nce = slice_begin(Cs, cs, r + 1) - e0;
  const int o0 = slice_begin(n, cs, r), no = slice_begin(n, cs, r + 1) - o0;
  const int chunk = cdiv(n, cs), slab = cs * B * chunk;  // a receive buffer's floats

  // the weight slice, as the one-wave path fetches it: rows k * nc + ci of
  // the conv, then each head's nce epilogue rows, cg values each; then the
  // group's parameters and each rank's output count; none depends on the
  // launch before
  TP* ws = reinterpret_cast<TP*>(smem + f.total);
  TP* wse = ws + K * nc * cg;
  {
    const int64_t pitch = (int64_t)C * sizeof(TP);
    const int row = cg * (int)sizeof(TP);
    copy_rows(reinterpret_cast<char*>(ws), reinterpret_cast<const char*>(w + (int64_t)c0 * C + g * cg),
              K * nc, nc, Cin * pitch, pitch, row);
    for (int hd = 0; hd < nh; ++hd)
      copy_rows(reinterpret_cast<char*>(wse + hd * nce * cg),
                reinterpret_cast<const char*>(ew + (int64_t)e0 * epitch + hd * C + g * cg), nce, nce, 0,
                (int64_t)epitch * sizeof(TP), row);
    cp_async_commit();
  }
  for (int i = tid; i < cg; i += nt) {
    const int c = g * cg + i;
    sp[i] = load(bias, c);
    sp[cg + i] = load(gamma, c);
    sp[2 * cg + i] = load(beta, c);
    sp[3 * cg + i] = has_e ? load(eb, c) : 0.f;
    sp[4 * cg + i] = film ? load(eb, C + c) : 0.f;
  }
  for (int q = tid; q < cs; q += nt) {  // rank q's outputs of a batch row, and 1 over that
    const int m = slice_begin(n, cs, q + 1) - slice_begin(n, cs, q);
    cnt[q] = (float)m;
    cnt[cs + q] = m > 0 ? 1.f / m : 0.f;
  }
  grid_dependency_wait();

  // the inputs' rows for the rank's channels, zero-padded: x for the conv;
  // mish(t) or xres for the epilogue's projection
  stage_rows(sx, x, B, f.nbx, L, Cin, c0, nc, f.xp, pad, [](float v) { return v; });
  if (epi == EPI_RES_CONV)
    stage_rows(se, ein, B, f.nbe, L, Ce, e0, nce, f.ep, 0, [](float v) { return v; });
  else if (has_e)
    stage_rows(se, ein, B, f.nbe, 1, Ce, e0, nce, f.ep, 0, [](float v) { return mish(v); });
  if (epi == EPI_RES_ID)
    for (int i = tid; i < B * no; i += nt) {
      const int b = i / no, oo = i - b * no, o = o0 + oo;
      sres[b * chunk + oo] = load(ein, ((int64_t)b * L + o / cg) * C + g * cg + o % cg);
    }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  cluster_wait();

  // this rank's sums, each written into the receive buffer of the rank that
  // owns the output: buf[(r * B + b) * chunk + o - that rank's first output],
  // four at a time where every rank owns a whole number of float4s
  const bool vec = n % (4 * cs) == 0;
  auto push = [&](float* buf, int b, int o, const float(&v)[4]) {
    if (vec) {
      const int q = o / chunk;
      *reinterpret_cast<float4*>(peer_of(cluster, r, buf, q) + (r * B + b) * chunk + o - q * chunk) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = ((o + j + 1) * cs - 1) / n;
        peer_of(cluster, r, buf, q)[(r * B + b) * chunk + o + j - slice_begin(n, cs, q)] = v[j];
      }
    }
  };
  // the conv over the rank's channels and taps, then the epilogue's
  // projection over its rows (one tap; the time projection's one row goes to
  // every position)
  fold_gemm<TL, FOLD_MAX_K>(sx, f.xp, nc, K, ws, 0, 1, B, L, cg, f.S,
                            [&](int, int b, int p, int c, const float(&v)[4]) { push(recv, b, p * cg + c, v); });
  if (epi == EPI_RES_CONV) {
    fold_gemm<TL, 1>(se, f.ep, nce, 1, wse, 0, 1, B, L, cg, f.S,
                     [&](int, int b, int p, int c, const float(&v)[4]) { push(recve, b, p * cg + c, v); });
  } else if (has_e) {
    float* sye = smem + f.sye;
    fold_gemm<1, 1>(se, f.ep, nce, 1, wse, nce * cg, nh, B, 1, cg, f.S,
                    [&](int hd, int b, int, int c, const float(&v)[4]) {
                      *reinterpret_cast<float4*>(sye + (hd * B + b) * cg + c) = make_float4(v[0], v[1], v[2], v[3]);
                    });
    __syncthreads();
    // to each rank, for each of its outputs (b, l, c), the projection of
    // column c: every position of a batch row takes the same
    const int W = vec ? 4 : 1, nu = chunk / W;
    for (int i = tid; i < nh * B * cs * nu; i += nt) {
      int m = i / nu;
      const int u = i - m * nu, q = m % cs;
      m /= cs;
      const int b = m % B, hd = m / B, lo = slice_begin(n, cs, q);
      if (u * W >= slice_begin(n, cs, q + 1) - lo) continue;
      float* dst = peer_of(cluster, r, recve, q) + hd * slab + (r * B + b) * chunk + u * W;
      const float* src = sye + (hd * B + b) * cg + (lo + u * W) % cg;
      if (vec)
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      else
        *dst = *src;
    }
  }
  launch_dependents();  // past its wait and its weights: a dependent launch may start
  cluster.sync();       // every rank's sums are in

  // the chunk of each batch row: bias + every rank's sums, in rank order
  const int rstride = B * chunk;  // between two ranks' sums in a receive buffer
  for (int i = tid; i < B * no; i += nt) {
    const int b = i / no, oo = i - b * no;
    const float* p = recv + b * chunk + oo;
    float v = sp[(o0 + oo) % cg];
    for (int q = 0; q < cs; ++q) v += p[q * rstride];
    yc[b * chunk + oo] = v;
  }
  __syncthreads();
  // each batch row's sum over the chunk and sum of squared deviations from
  // the chunk's mean, into every rank's slot r
  for (int b = tid; b < B; b += nt) {
    const float* v = yc + b * chunk;
    float s1 = 0.f;
    for (int oo = 0; oo < no; ++oo) s1 += v[oo];
    const float mr = s1 * cnt[cs + r];
    float m2 = 0.f;
    for (int oo = 0; oo < no; ++oo) {
      const float d = v[oo] - mr;
      m2 += d * d;
    }
    rowst[2 * b] = s1;
    rowst[2 * b + 1] = m2;
  }
  __syncthreads();
  for (int i = tid; i < cs * 2 * B; i += nt) {
    const int q = i / (2 * B), j = i - q * 2 * B;
    peer_of(cluster, r, stat, q)[r * 2 * B + j] = rowst[j];
  }
  cluster.sync();  // every rank's pairs are in; no distributed access follows

  // each batch row's mean and variance over the group: the ranks' pairs
  // combined in rank order
  for (int b = tid; b < B; b += nt) {
    const float* st = stat + 2 * b;
    float tot = 0.f;
    for (int q = 0; q < cs; ++q) tot += st[q * 2 * B];
    const float mean = tot / n;
    float m2 = 0.f;
    for (int q = 0; q < cs; ++q) {
      const float d = st[q * 2 * B] * cnt[cs + q] - mean;
      m2 += st[q * 2 * B + 1] + cnt[q] * d * d;
    }
    rowst[2 * b] = mean;
    rowst[2 * b + 1] = rsqrtf(m2 / n + eps);
  }
  __syncthreads();

  // normalise, Mish, epilogue (every rank's terms, in rank order)
  for (int i = tid; i < B * no; i += nt) {
    const int b = i / no, oo = i - b * no, o = o0 + oo, l = o / cg, c = o - l * cg;
    const float y =
        mish((yc[b * chunk + oo] - rowst[2 * b]) * rowst[2 * b + 1] * sp[cg + c] + sp[2 * cg + c]);
    const float* p = recve + b * chunk + oo;
    float e0v, e1v = sp[4 * cg + c];
    if (has_e) {
      e0v = sp[3 * cg + c];
      for (int q = 0; q < cs; ++q) e0v += p[q * rstride];
      if (film)
        for (int q = 0; q < cs; ++q) e1v += p[slab + q * rstride];
    } else {
      e0v = sres[b * chunk + oo];
    }
    store(out, ((int64_t)b * L + l) * C + g * cg + c, film ? fmaf(e0v, y, e1v) : y + e0v);
  }
}

__global__ void empty_kernel(int) {}

// A launch of `kernel` on `ctas` CTAs in clusters of cs along x (cs = 0: no
// cluster); with `pdl`, a programmatic dependent launch. With `clusters`
// set, nothing is launched: *clusters gets how many such clusters the card
// holds at once.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int ctas, int threads, size_t smem, int cs,
                    bool pdl, int* clusters, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (cs > 0) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = cs;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (pdl) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t err = clusters ? cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg)
                                   : cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // the refusal is returned; do not leave it for the next check
    return (int)err;
  }
  return clusters ? 0 : (int)cudaGetLastError();
}

template <int LMAX, typename TX, typename TP, typename TO, bool ONE_WAVE>
int launch_l(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
             int B, int L, int Cin, int C, int K, int groups, int S, float eps, int epi,
             const void* ein, int Ce, const void* ew, const void* eb, void* out, int cs,
             int threads, size_t smem, bool pdl, int* clusters, cudaStream_t stream) {
  auto kernel = conv_gn_mish_kernel<LMAX, TX, TP, TO, ONE_WAVE>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_clusters(
      kernel, B * groups * cs, threads, smem, cs, pdl, clusters, stream,
      static_cast<const TX*>(x), static_cast<const TP*>(w), static_cast<const TP*>(bias),
      static_cast<const TP*>(gamma), static_cast<const TP*>(beta), L, Cin, C, K, groups, S, eps,
      epi, static_cast<const TP*>(ein), Ce, static_cast<const TP*>(ew),
      static_cast<const TP*>(eb), static_cast<TO*>(out));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TP, typename TO>
int launch(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
           int B, int L, int Cin, int C, int K, int groups, float eps, int epi, const void* ein,
           int Ce, const void* ew, const void* eb, void* out, int cs, int threads, int smem,
           bool one_wave, bool pdl, int* clusters, cudaStream_t stream) {
  if (groups <= 0 || C % groups != 0 || L < 1 || L > MAX_L || K < 1) return -2;
  if (epi != EPI_TBIAS && epi != EPI_RES_CONV && epi != EPI_RES_ID && epi != EPI_FILM) return -2;
  const int cg = C / groups;
  if (cs < 1 || cs > MAX_CLUSTER || (cs & (cs - 1)) != 0) return -2;
  if (threads < cg || threads > MAX_THREADS || threads % 32 != 0) return -2;
  const int S = threads / cg < MAX_SPLIT ? threads / cg : MAX_SPLIT;
  const Layout lay = layout(L, Cin, cg, K, S, cs, epi, Ce);
  int want = lay.total * (int)sizeof(float);
  if (one_wave) {
    // whole 16-byte copies of every weight row, from 16-byte aligned rows
    if ((cg * (int)sizeof(TP)) % 16 != 0) return -2;
    if (!clusters && (!aligned16(w) || (reduces(epi) && !aligned16(ew))))
      return -2;
    want = (want + 15) / 16 * 16 + slice_bytes(Cin, cg, K, cs, epi, Ce, (int)sizeof(TP));
  } else if (pdl) {
    return -2;  // only the one-wave path waits on its predecessor
  }
  if (smem != want || smem > MAX_SMEM) return -2;
#define ADM_L(LM, OW)                                                                     \
  return launch_l<LM, TX, TP, TO, OW>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, S, eps, \
                                      epi, ein, Ce, ew, eb, out, cs, threads, (size_t)smem, pdl, \
                                      clusters, stream)
#define ADM_LS(OW)     \
  if (L <= 2) ADM_L(2, OW); \
  if (L <= 4) ADM_L(4, OW); \
  if (L <= 8) ADM_L(8, OW); \
  ADM_L(16, OW)
  if (one_wave) {
    ADM_LS(true);
  }
  ADM_LS(false);
#undef ADM_LS
#undef ADM_L
}

template <int NR, typename TX, typename TP, typename TO>
int launch_streamed_nr(const void* x, const void* w, const void* bias, const void* gamma,
                       const void* beta, int B, int L, int Cin, int C, int K, int groups, float eps,
                       int epi, const void* ein, int Ce, const void* ew, const void* eb, void* out,
                       void* scratch, int parts, int threads, int smem, int fin_threads,
                       int fin_smem, bool pdl, cudaStream_t stream) {
  auto stream_k = conv_gn_mish_kernel_streamed<NR, TX, TP>;
  auto finish_k = conv_gn_mish_kernel_finish<TP, TO>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(stream_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && fin_smem > 48 * 1024)
    err = cudaFuncSetAttribute(finish_k, cudaFuncAttributeMaxDynamicSharedMemorySize, fin_smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_clusters(stream_k, groups * parts, threads, (size_t)smem, 0, pdl, nullptr,
                                 stream, static_cast<const TX*>(x), static_cast<const TP*>(w), B, L,
                                 Cin, C, K, groups, epi, static_cast<const TP*>(ein), Ce,
                                 static_cast<const TP*>(ew), parts, static_cast<float*>(scratch));
  if (rc != 0) return rc;
  return launch_clusters(finish_k, B * groups * FINISH_CLUSTER, fin_threads, (size_t)fin_smem,
                         FINISH_CLUSTER, true, nullptr,
                         stream, static_cast<const float*>(scratch), static_cast<const TP*>(bias),
                         static_cast<const TP*>(gamma), static_cast<const TP*>(beta), B, L, Cin, C,
                         K, groups, parts, eps, epi, static_cast<const TP*>(ein), Ce,
                         static_cast<const TP*>(eb), static_cast<TO*>(out));
}

// The streamed path's two launches, after checking the geometry that
// ops/kernels.py:streamed_geometry gave against the same formulas.
template <typename TX, typename TP, typename TO>
int launch_streamed(const void* x, const void* w, const void* bias, const void* gamma,
                    const void* beta, int B, int L, int Cin, int C, int K, int groups, float eps,
                    int epi, const void* ein, int Ce, const void* ew, const void* eb, void* out,
                    void* scratch, int parts, int threads, int smem, int fin_threads, int fin_smem,
                    bool pdl, cudaStream_t stream) {
  if (groups <= 0 || C % groups != 0 || L < 1 || L > MAX_L || K < 1 || B < 1 ||
      B * L > STREAM_MAX_ROWS)
    return -2;
  if (epi != EPI_TBIAS && epi != EPI_RES_CONV && epi != EPI_RES_ID && epi != EPI_FILM) return -2;
  const int cg = C / groups, row_bytes = cg * (int)sizeof(TP);
  if (row_bytes % 16 != 0 || !aligned16(w) || (reduces(epi) && !aligned16(ew)) ||
      !aligned16(scratch))
    return -2;
  const int cq = cg / 4, S = stream_split(cq);
  if (threads != (S * cq + 31) / 32 * 32 || threads > STREAM_THREADS) return -2;
  const Segments sg = segments(L, Cin, K, epi, Ce);
  if (parts < 1 || parts > sg.rows) return -2;
  if (smem != stream_smem(row_bytes, S, sg.rows, parts, stream_nr(B * L)) || smem > MAX_SMEM)
    return -2;
  const int n = L * cg;
  const int chunk = (n + FINISH_CLUSTER - 1) / FINISH_CLUSTER, fin_want = (chunk + 31) / 32 * 32;
  if (fin_threads != (fin_want < MAX_THREADS ? fin_want : MAX_THREADS) ||
      fin_smem != 4 * (36 + 5 * cg + 3 * chunk) ||
      fin_smem > MAX_SMEM)
    return -2;
#define ADM_NR(NR)                                                                               \
  return launch_streamed_nr<NR, TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, \
                                            epi, ein, Ce, ew, eb, out, scratch, parts, threads,   \
                                            smem, fin_threads, fin_smem, pdl, stream)
  if (B * L <= 4) ADM_NR(4);
  if (B * L <= 8) ADM_NR(8);
  ADM_NR(16);
#undef ADM_NR
}

template <int TL, typename TX, typename TP, typename TO>
int launch_folded_tl(const void* x, const void* w, const void* bias, const void* gamma,
                     const void* beta, int B, int L, int Cin, int C, int K, int groups, float eps,
                     int epi, const void* ein, int Ce, const void* ew, const void* eb, void* out, int cs,
                     int threads, int smem, bool pdl, int* clusters, cudaStream_t stream) {
  auto kernel = conv_gn_mish_kernel_folded<TL, TX, TP, TO>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > MAX_CLUSTER)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return launch_clusters(kernel, groups * cs, threads, (size_t)smem, cs, pdl, clusters, stream,
                         static_cast<const TX*>(x), static_cast<const TP*>(w),
                         static_cast<const TP*>(bias), static_cast<const TP*>(gamma),
                         static_cast<const TP*>(beta), B, L, Cin, C, K, groups, eps, epi,
                         static_cast<const TP*>(ein), Ce, static_cast<const TP*>(ew),
                         static_cast<const TP*>(eb), static_cast<TO*>(out));
}

// The folded path's launch, after checking the geometry that
// ops/kernels.py:folded_geometry gave against fold_layout; with `clusters`
// set, the occupancy query instead.
template <typename TX, typename TP, typename TO>
int launch_folded(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
                  int B, int L, int Cin, int C, int K, int groups, float eps, int epi, const void* ein,
                  int Ce, const void* ew, const void* eb, void* out, int cs, int threads, int smem,
                  bool pdl, int* clusters, cudaStream_t stream) {
  if (groups <= 0 || C % groups != 0 || L < 1 || L > MAX_L || K < 1 || K > FOLD_MAX_K || B < 1 ||
      Cin < 1)
    return -2;
  if (epi != EPI_TBIAS && epi != EPI_RES_CONV && epi != EPI_RES_ID && epi != EPI_FILM) return -2;
  const int cg = C / groups;
  if (cs < 1 || cs > FOLD_MAX_CLUSTER || (cs & (cs - 1)) != 0) return -2;
  // whole 16-byte copies of every weight row, from 16-byte aligned rows
  if ((cg * (int)sizeof(TP)) % 16 != 0) return -2;
  if (!clusters && (!aligned16(w) || (reduces(epi) && !aligned16(ew)))) return -2;
  const FoldLayout f = fold_layout(B, L, Cin, cg, K, cs, epi, Ce);
  const int want = f.total * (int)sizeof(float) + slice_bytes(Cin, cg, K, cs, epi, Ce, (int)sizeof(TP));
  if (threads != f.threads || smem != want || smem > MAX_SMEM) return -2;
#define ADM_F(TL)                                                                                  \
  return launch_folded_tl<TL, TX, TP, TO>(x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, \
                                          ein, Ce, ew, eb, out, cs, threads, smem, pdl, clusters, stream)
  if (f.tl == 1) ADM_F(1);
  if (f.tl == 2) ADM_F(2);
  ADM_F(4);
#undef ADM_F
}

template <typename Fn>
int by_dtype(int x_dtype, int p_dtype, int out_dtype, Fn&& fn) {
  if (p_dtype == DT_F32 && x_dtype == DT_F32 && out_dtype == DT_F32)
    return fn(float(), float(), float());
  if (p_dtype == DT_BF16) {
    if (x_dtype == DT_BF16 && out_dtype == DT_BF16)
      return fn(__nv_bfloat16(), __nv_bfloat16(), __nv_bfloat16());
    if (x_dtype == DT_BF16 && out_dtype == DT_F32) return fn(__nv_bfloat16(), __nv_bfloat16(), float());
    if (x_dtype == DT_F32 && out_dtype == DT_BF16) return fn(float(), __nv_bfloat16(), __nv_bfloat16());
  }
  return -1;
}

}  // namespace

// x: (B, L, Cin) of x_dtype; w: (K, Cin, C); bias/gamma/beta: (C,); ein, ew,
// eb: the epilogue's input, weight (Ce, C) and bias (C,) (see the kernel);
// out: (B, L, C) of out_dtype. Weights and the epilogue input are of p_dtype.
// cs, threads, smem: the launch geometry (ops/kernels.py:launch_geometry):
// the cluster size, the threads of a CTA and its shared-memory bytes.
// one_wave: the one-wave path, its smem the layout's total rounded up to 16
// bytes and the weight slice (ops/kernels.py:one_wave_geometry); pdl: launch
// it with programmatic dependent launch (the one-wave path only).
extern "C" int adm_conv_gn_mish(const void* x, const void* w, const void* bias,
                                const void* gamma, const void* beta, int B, int L, int Cin, int C,
                                int K, int groups, float eps, int epi, const void* ein, int Ce,
                                const void* ew, const void* eb, void* out, int x_dtype,
                                int p_dtype, int out_dtype, int cs, int threads, int smem,
                                int one_wave, int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(x_dtype, p_dtype, out_dtype, [&](auto tx, auto tp, auto to) {
    return launch<decltype(tx), decltype(tp), decltype(to)>(
        x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, ein, Ce, ew, eb, out, cs,
        threads, smem, one_wave != 0, pdl != 0, nullptr, s);
  });
}

// The streamed path (ops/kernels.py:streamed_geometry): the arguments of
// adm_conv_gn_mish, then `scratch`, (segments, groups, parts, B x L, cg)
// floats for the partial sums (segments: the conv and the epilogue's heads); `parts`, the CTAs a group's rows are cut over; threads
// and shared-memory bytes of a streaming and of a finishing CTA; pdl: the
// streaming launch with programmatic dependent launch (the finishing launch
// always has it, behind its own streaming launch).
extern "C" int adm_conv_gn_mish_streamed(const void* x, const void* w, const void* bias,
                                         const void* gamma, const void* beta, int B, int L,
                                         int Cin, int C, int K, int groups, float eps, int epi,
                                         const void* ein, int Ce, const void* ew, const void* eb,
                                         void* out, void* scratch, int x_dtype, int p_dtype,
                                         int out_dtype, int parts, int threads, int smem,
                                         int fin_threads, int fin_smem, int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(x_dtype, p_dtype, out_dtype, [&](auto tx, auto tp, auto to) {
    return launch_streamed<decltype(tx), decltype(tp), decltype(to)>(
        x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, ein, Ce, ew, eb, out, scratch,
        parts, threads, smem, fin_threads, fin_smem, pdl != 0, s);
  });
}

// The folded path (ops/kernels.py:folded_geometry): the arguments of
// adm_conv_gn_mish but the path's; cs, threads, smem: its cluster size (up to
// 16), the threads of a CTA and its shared-memory bytes (fold_layout and the
// weight slice); pdl: launched with programmatic dependent launch.
extern "C" int adm_conv_gn_mish_folded(const void* x, const void* w, const void* bias,
                                       const void* gamma, const void* beta, int B, int L, int Cin,
                                       int C, int K, int groups, float eps, int epi, const void* ein,
                                       int Ce, const void* ew, const void* eb, void* out,
                                       int x_dtype, int p_dtype, int out_dtype, int cs, int threads,
                                       int smem, int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(x_dtype, p_dtype, out_dtype, [&](auto tx, auto tp, auto to) {
    return launch_folded<decltype(tx), decltype(tp), decltype(to)>(
        x, w, bias, gamma, beta, B, L, Cin, C, K, groups, eps, epi, ein, Ce, ew, eb, out, cs,
        threads, smem, pdl != 0, nullptr, s);
  });
}

// How many clusters of the launch that adm_conv_gn_mish (path 1: its one-wave
// path) or adm_conv_gn_mish_folded (path 2) would make with these arguments
// (less the pointers) the card holds at once: cudaOccupancyMaxActiveClusters
// of that kernel instance, into *clusters. ops/kernels.py asks once per
// geometry.
extern "C" int adm_conv_gn_mish_clusters(int B, int L, int Cin, int C, int K, int groups, int epi,
                                         int Ce, int x_dtype, int p_dtype, int out_dtype, int cs,
                                         int threads, int smem, int path, int* clusters) {
  if (clusters == nullptr) return -2;
  return by_dtype(x_dtype, p_dtype, out_dtype, [&](auto tx, auto tp, auto to) {
    if (path == 2)
      return launch_folded<decltype(tx), decltype(tp), decltype(to)>(
          nullptr, nullptr, nullptr, nullptr, nullptr, B, L, Cin, C, K, groups, 0.f, epi, nullptr,
          Ce, nullptr, nullptr, nullptr, cs, threads, smem, false, clusters, nullptr);
    return launch<decltype(tx), decltype(tp), decltype(to)>(
        nullptr, nullptr, nullptr, nullptr, nullptr, B, L, Cin, C, K, groups, 0.f, epi, nullptr,
        Ce, nullptr, nullptr, nullptr, cs, threads, smem, path == 1, false, clusters, nullptr);
  });
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
  if (cs > 0)
    return launch_clusters(empty_kernel, ctas, threads, (size_t)smem, cs, false, nullptr, s, 0);
  empty_kernel<<<ctas, threads, smem, s>>>(0);
  return (int)cudaGetLastError();
}
