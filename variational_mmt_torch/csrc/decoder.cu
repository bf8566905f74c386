// The teacher-forced 2-layer input-feed GRU decoder with general attention
// over a whole sequence, forward and backward.
//
// Replaces two Pallas kernels of variational_mmt_tpu/ops/pallas/decoder.py:
//   _dec_fwd_kernel (decoder_fwd_pallas, pallas_call at :153)
//   _dec_bwd_kernel (decoder_bwd_pallas, pallas_call at :304)
// Every tensor but the biases, mask_bias and the f32 streams is in one
// compute dtype T (float or bfloat16). Per step t the forward computes
//   x0 = emb_proj[t] + feed @ Wfeed;      h0' = GRU(x0, h0 @ Wh0 + bh0, h0)
//   x1 = (dmid[t] * h0') @ Wmid + bmid;   h1' = GRU(x1, h1 @ Wh1 + bh1, h1)
//   probs = softmax(h1' . keys + mask_bias)
//   feed' = attn = tanh(sum_s probs . mem_v + h1' @ Wc_q)
// with h0, h1 and feed kept in f32 across time (the Pallas VMEM scratch)
// and only the saved streams attn_hs, h0s, h1s, probs rounded to T. Every
// product takes its operands rounded to T and accumulates in f32; the
// attention products are each rounded to T before their f32 sum, as the
// Pallas body computes them.
//
// The backward runs time in reverse, carrying (dh0, dh1, dfeed) in f32, and
// writes the local gradients dx0, dhp0, dx1, dhp1 (B,T,3H), pre (B,T,H),
// dscores (B,T,S) and dh00, dh01. The weight gradients are products over
// these streams outside (ops/decoder.py), as _pal_bwd computes them outside
// Pallas.
//
// On the TPU one grid step held the whole step with the weights resident in
// VMEM. On the H100 the step has grid-wide dependencies (GRU1 needs every
// column of h0', attention all of h1', the next step all of feed).
//
// Forward: one entry point queues T steps of small kernels on the stream
// with no host synchronisation, 4 kernels a step (GRU0 cell, GRU1 cell,
// h1' @ Wc_q, attention): the decode step's (common.cuh), with the dropout
// mask on GRU1's input and an f32 state. At B=64, T=25, H=500 each kernel
// does tens of MFLOP, so the chain of 100 dependent launches bounds it.
//
// Backward: two launches. What bounds it on this card is the serial chain
// of T steps, each a few (64, 1500) x (1500, 500) products and the
// attention backward; its bytes and FLOPs bound it at about 20 us.
//   (a) The four gate products of the cells (round(dmid*h0s) @ Wmid,
//       round(h1_prev) @ Wh1, round(feed_prev) @ Wfeed, round(h0_prev) @
//       Wh0) read only saved forward streams, so one launch of the tiled
//       product (tile_gemm.cuh; tensor cores in bf16) computes them for
//       every (row, t) before the loop, biases and emb_proj folded in.
//   (b) One persistent cooperative kernel walks t = T-1 .. 0 in four
//       phases separated by grid barriers: attention backward (a CTA per
//       row, keys and mem_v read from L2); dh1' = dk + round(pre) @ Wc_q^T
//       and GRU1's cell backward; dh1 = dh1'z1 + round(dhp1) @ Wh1^T, dh0'
//       = dmid * (round(dx1) @ Wmid^T) + dh0 and GRU0's cell backward; dh0
//       = dh0'z0 + round(dhp0) @ Wh0^T and dfeed = round(dx0) @ Wfeed^T.
//       The grid spreads over the card's SMs; two CTAs fit an SM at H=500
//       (113 KB of shared memory each in bf16). Each CTA owns 8 hidden
//       units in bf16 (4 in f32) with their three gate columns, so a cell
//       backward needs only the products of its own CTA, and keeps the rows
//       of the five weights it reads (104 KB at H=500 in either dtype) in
//       shared memory for the whole call: no weight is transposed or
//       re-read from memory. The products take the other CTAs' results as
//       T-rounded copies from L2 (mma.sync m16n8k16 in bf16, one n-tile of
//       8 units; FMAs in f32). In-kernel exchanges are read with
//       ld.global.cg, past the L1.

#include <cooperative_groups.h>

#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRPT = 2;          // rows per thread
constexpr int kTR = kTY * kRPT;  // rows per block

// Launch shapes for N rows and H hidden units: the cells and the products
// with M = H output columns share one (units x rows) tile grid.
template <typename T>
struct Launch {
  int N, H;
  cudaStream_t stream;
  dim3 grid, block;
  Launch(int N_, int H_, cudaStream_t s)
      : N(N_), H(H_), stream(s), grid((H_ + kTU - 1) / kTU, (N_ + kTR - 1) / kTR),
        block(kTU, kTY) {}
  void gemm(const float* a, int lda, const T* w, const T* mul, int ldm, const float* add,
            float* out, int K) const {
    gemm_kernel<T, float, kRPT><<<grid, block, 0, stream>>>(a, lda, w, mul, ldm, add, out, N, K,
                                                            H);
  }
};

template <typename T>
void decoder_fwd(const T* emb_proj, const T* dmid, const float* h00, const float* h01,
                 const T* wfeed, const T* wh0, const float* bh0, const T* wmid,
                 const float* bmid, const T* wh1, const float* bh1, const T* keys,
                 const T* mem_v, const T* wcq, const float* mask_bias, T* attn_hs, T* h0s,
                 T* h1s, T* probs, float* scratch, int B, int T_len, int S, int H,
                 cudaStream_t stream) {
  const Launch<T> L(B, H, stream);
  const size_t BH = (size_t)B * H;
  float* feed = scratch + 4 * BH;
  float* qw = scratch + 5 * BH;
  const int smem = (H + S) * (int)sizeof(float);
  allow_smem(attn_fwd_kernel<T, float>, smem);
  const float* h0c = h00;
  const float* h1c = h01;
  for (int t = 0; t < T_len; ++t) {
    float* h0n = scratch + (t % 2) * BH;
    float* h1n = scratch + (2 + t % 2) * BH;
    cell_fwd_kernel<T, float, kRPT><<<L.grid, L.block, 0, stream>>>(
        emb_proj + (size_t)t * 3 * H, T_len * 3 * H, nullptr, t == 0 ? nullptr : feed, nullptr,
        0, wfeed, h0c, wh0, bh0, h0n, h0s + (size_t)t * H, T_len * H, B, H);
    cell_fwd_kernel<T, float, kRPT><<<L.grid, L.block, 0, stream>>>(
        nullptr, 0, bmid, h0n, dmid + (size_t)t * H, T_len * H, wmid, h1c, wh1, bh1, h1n,
        h1s + (size_t)t * H, T_len * H, B, H);
    L.gemm(h1n, H, wcq, nullptr, 0, nullptr, qw, H);
    attn_fwd_kernel<T, float><<<B, kAttnThreads, smem, stream>>>(
        h1n, keys, mem_v, qw, mask_bias, feed, attn_hs + (size_t)t * H, T_len * H,
        probs + (size_t)t * S, T_len * S, S, H);
    h0c = h0n;
    h1c = h1n;
  }
}

// ---------------------------------------------------------------------------
// Backward: the hoisted gate products, then one persistent cooperative
// kernel over time.

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecUnitsMma = 8;  // units of a CTA in bf16: one mma n-tile
constexpr int kDecUnitsFma = 4;  // most units of a CTA in f32

// One of the four gate products of a step, for every (row, t) at once:
// out (B*T, 3H) f32 = [add +] round(A) @ w [+ bias], A the previous state
// (shift) or round(mul * stream) at the same step.
template <typename T>
struct DecHoist {
  int M, N, K;
  const float* __restrict__ init;  // f32 state before t = 0, or null (a zero state)
  const T* __restrict__ stream;    // (B,T,H)
  const T* __restrict__ mul;       // (B,T,H) or null
  const T* __restrict__ w;         // (H,3H)
  const float* __restrict__ bias;  // (3H) or null
  const T* __restrict__ add;       // (B,T,3H) or null
  float* __restrict__ dst;         // (B,T,3H)
  int T_len, H, shift;
  static constexpr bool kAFastK = true, kBFastK = false;
  __device__ void load_a(int m, int k, float (&v)[16]) const {
    const int n = m < M ? min(16, K - k) : 0;
    if (shift) {
      prev_seg<T>(init, stream, m / T_len, m % T_len, T_len, H, k, n, false, v);
      return;
    }
    seg_load(stream + (size_t)m * H + k, n, v);
    if (mul != nullptr) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < n) v[i] = to_f(mul[(size_t)m * H + k + i]) * v[i];
    }
  }
  __device__ void load_b(int k, int n, float (&v)[16]) const {
    seg_load(w + (size_t)k * N + n, k < K ? min(16, N - n) : 0, v);
  }
  __device__ void out(int m, int n, float v) const {
    if (add != nullptr) v = to_f(add[(size_t)m * N + n]) + v;
    if (bias != nullptr) v = v + bias[n];
    dst[(size_t)m * N + n] = v;
  }
  int extra_blocks() const { return 0; }
  __device__ void extra(int) const {}
};

// Row stride of the activations and weight slices that block_product
// reads: K padded to 32 and, for bf16 weight rows in shared memory, to an
// odd multiple of 64 bytes, so that the two rows a quarter-warp reads with
// 16-byte loads fall in different halves of the banks.
__host__ __device__ int pad32(int k) { return (k + 31) & ~31; }

template <typename T>
__host__ __device__ int frag_ld(int K) {
  const int k = pad32(K);
  return is_bf16<T>() ? k + (96 - k % 64) % 64 : k;
}

// Shared-memory plan of the persistent kernel for CTAs of `units` hidden
// units and `rows` batch rows (a multiple of 16).
template <typename T>
struct DecLayout {
  int wrows, ld1, ld3, prod_rows;
  size_t w1, w3, prod, carry, attn, total;
  __host__ __device__ DecLayout(int rows, int S, int H, int units) {
    wrows = is_bf16<T>() ? kDecUnitsMma : units;
    ld1 = frag_ld<T>(H);
    ld3 = frag_ld<T>(3 * H);
    prod_rows = is_bf16<T>() ? max(kDecWarps * 16, rows) : rows;  // >= kp * 16 * tiles
    w1 = align16((size_t)wrows * ld1 * sizeof(T));
    w3 = align16((size_t)wrows * ld3 * sizeof(T));
    prod = (size_t)prod_rows * kDecUnitsMma * sizeof(float);
    carry = align16((size_t)rows * units * sizeof(float));
    attn = align16((size_t)(H + 2 * S) * sizeof(float));
    total = w1 + 4 * w3 + prod + 2 * carry + attn;
  }
};

template <typename T>
struct DecBwd {
  const T *dmid, *wfeed, *wh0, *wmid, *wh1, *wcq, *keys, *mem_v, *attn_hs, *h0s, *h1s, *probs;
  const float *h00, *h01, *d_attn, *d_probs;
  const float *x0, *hp0, *x1, *hp1;  // hoisted gate products (B,T,3H)
  float *dx0, *dhp0, *dx1, *dhp1, *pre, *dscores, *dh00, *dh01;
  // written and read inside the kernel across CTAs: read with __ldcg, from
  // L2, since an SM's L1 may hold a stale copy
  float* dfeed;  // (B,H) dL/dfeed
  float* dk;     // (B,H) the attention part of dL/dh1' plus dh1
  T* pre_c;      // (B,ld_pre) pre rounded to T
  T* act_c;      // 4 x (B,ld_act): dhp1, dx1, dhp0, dx0 rounded to T
  int B, T_len, S, H, units, unit_tiles, rows, ld_pre, ld_act;
};

// prod[m * 8 + u] = sum_k act[r0 + m, k] w_s[u, k] for m < nr, u < nu: act
// in T rows lda apart (columns K..lda zero, lda a multiple of 32), w_s
// (wrows, ldw) in shared memory. bf16: mma.sync over 16-row tiles, the K
// range split across warps when there are fewer tiles than warps, partial
// sums added in a fixed order. Each lane loads 16 bytes of a row per 32
// columns, whole sectors: within a 32-column block, lane tq's columns 8tq ..
// 8tq+7 serve as the mma fragment's k = 2tq, 2tq+1, 2tq+8, 2tq+9 of two
// k-steps, in A and B alike, which permutes the sum over k and changes
// nothing else. f32: FMAs, a warp per row, lanes along K.
constexpr int kDecBatch = 12;  // 32-column blocks whose fragments a warp loads at once

template <typename T>
__device__ void block_product(const T* act, int lda, int K, const T* w_s, int ldw, int nu,
                              int r0, int nr, float* prod) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // prod is free
  if constexpr (is_bf16<T>()) {
    const int gq = lane >> 2, tq = lane & 3;
    const int mt = (nr + 15) / 16, kp = mt < kDecWarps ? kDecWarps / mt : 1;
    const int blocks = lda / 32;
    for (int task = warp; task < mt * kp; task += kDecWarps) {
      const int tile = task % mt, part = task / mt;
      const int m0 = tile * 16 + gq, m1 = m0 + 8;
      const bool ok0 = m0 < nr, ok1 = m1 < nr;
      const uint4* row0 = reinterpret_cast<const uint4*>(act + (size_t)(r0 + m0) * lda) + tq;
      const uint4* row1 = reinterpret_cast<const uint4*>(act + (size_t)(r0 + m1) * lda) + tq;
      const uint4* wb = reinterpret_cast<const uint4*>(w_s + (size_t)gq * ldw) + tq;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int q1 = (part + 1) * blocks / kp;
      for (int q = part * blocks / kp; q < q1; q += kDecBatch) {
        uint4 x0[kDecBatch], x1[kDecBatch];
#pragma unroll
        for (int i = 0; i < kDecBatch; ++i) {
          const bool in = q + i < q1;
          x0[i] = in && ok0 ? __ldcg(row0 + (q + i) * 4) : make_uint4(0u, 0u, 0u, 0u);
          x1[i] = in && ok1 ? __ldcg(row1 + (q + i) * 4) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < kDecBatch; ++i) {
          if (q + i < q1) {
            const uint4 w = wb[(q + i) * 4];
            const uint32_t lo[4] = {x0[i].x, x1[i].x, x0[i].y, x1[i].y};
            const uint32_t hi[4] = {x0[i].z, x1[i].z, x0[i].w, x1[i].w};
            mma_bf16(c, lo, w.x, w.y);
            mma_bf16(c, hi, w.z, w.w);
          }
        }
      }
      float* out = prod + (size_t)part * mt * 16 * kDecUnitsMma;
      out[m0 * kDecUnitsMma + 2 * tq] = c[0];
      out[m0 * kDecUnitsMma + 2 * tq + 1] = c[1];
      out[m1 * kDecUnitsMma + 2 * tq] = c[2];
      out[m1 * kDecUnitsMma + 2 * tq + 1] = c[3];
    }
    __syncthreads();
    if (kp > 1) {
      const int stride = mt * 16 * kDecUnitsMma;
      for (int i = tid; i < stride; i += kDecThreads) {
        float v = prod[i];
        for (int part = 1; part < kp; ++part) v += prod[part * stride + i];
        prod[i] = v;
      }
      __syncthreads();
    }
  } else {
    for (int m = warp; m < nr; m += kDecWarps) {
      float acc[kDecUnitsFma] = {};
      const float* a = reinterpret_cast<const float*>(act) + (size_t)(r0 + m) * lda;
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        const float av = __ldcg(a + k);
#pragma unroll
        for (int u = 0; u < kDecUnitsFma; ++u)
          if (u < nu) acc[u] = fmaf(av, to_f(w_s[u * ldw + k]), acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kDecUnitsFma; ++u) {
        const float v = warp_sum(acc[u]);
        if (lane == 0) prod[m * kDecUnitsMma + u] = v;
      }
    }
    __syncthreads();
  }
}

// The inputs of one (row, unit) cell backward, loaded before the product
// that the cell waits for: the hoisted x and hp, the previous state, and
// the two terms of dh that do not come from the product.
struct CellIn {
  float x[3], hp[3], h_prev, a, b;
};

__device__ __forceinline__ void load_gates(const float* x, const float* hp, size_t n3, int j,
                                           int H, CellIn& in) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    in.x[q] = x[n3 + q * H + j];
    in.hp[q] = hp[n3 + q * H + j];
  }
}

// GRU cell backward of one (row, unit) with dL/dh' = dh: writes dx =
// [dr_pre|dz_pre|dn_pre] and dhp = [dr_pre|dz_pre|dhn] to the f32 streams
// (at n3 + gate * H + j) and their T-rounded copies, returns dh * z.
template <typename T>
__device__ __forceinline__ float cell_bwd(const CellIn& in, float dh, size_t n3, int j, int H,
                                          float* dx, float* dhp, T* dx_c, T* dhp_c) {
  const float r = sigmoid_f(in.x[0] + in.hp[0]);
  const float z = sigmoid_f(in.x[1] + in.hp[1]);
  const float hn = in.hp[2];
  const float n = tanhf(in.x[2] + r * hn);
  const float dz = dh * (in.h_prev - n);
  const float dn = dh * (1.f - z);
  const float dn_pre = dn * (1.f - n * n);
  const float dr = dn_pre * hn;
  const float dhn_ = dn_pre * r;
  const float dz_pre = dz * z * (1.f - z);
  const float dr_pre = dr * r * (1.f - r);
  const float gx[3] = {dr_pre, dz_pre, dn_pre}, gh[3] = {dr_pre, dz_pre, dhn_};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dx[n3 + q * H + j] = gx[q];
    dhp[n3 + q * H + j] = gh[q];
    dx_c[q * H + j] = from_f<T>(gx[q]);
    dhp_c[q * H + j] = from_f<T>(gh[q]);
  }
  return dh * z;
}

// The reverse scan. CTA b < unit_tiles * (B / rows rounded up) owns hidden
// units [(b % unit_tiles) * units, +units) of batch rows [(b / unit_tiles)
// * rows, +rows), with the units' rows of the five weights in shared
// memory; in the attention phase every CTA takes batch rows b, b +
// gridDim.x, ... Four phases a step, separated by grid barriers (see the
// note at the top).
template <typename T>
__global__ void __launch_bounds__(kDecThreads) decoder_bwd_kernel(DecBwd<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, T_len = p.T_len, S = p.S, H = p.H, H3 = 3 * H, units = p.units;
  const int tid = threadIdx.x;
  const int row_tiles = (B + p.rows - 1) / p.rows;
  const bool owner = (int)blockIdx.x < p.unit_tiles * row_tiles;
  const int u0 = (blockIdx.x % p.unit_tiles) * units;
  const int nu = owner ? max(0, min(units, H - u0)) : 0;
  const int r0 = owner ? (blockIdx.x / p.unit_tiles) * p.rows : 0;
  const int nr = owner ? min(p.rows, B - r0) : 0;
  const int items = nr * nu;  // (row, unit) cells of this CTA
  const DecLayout<T> L(p.rows, S, H, units);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  T* wcq_s = reinterpret_cast<T*>(sp);  // Wc_q[u0 + u, :]
  sp += L.w1;
  T* w3_s[4];  // Wh1, Wmid, Wh0, Wfeed rows u0 + u, in the order of act_c
  for (int i = 0; i < 4; ++i, sp += L.w3) w3_s[i] = reinterpret_cast<T*>(sp);
  float* prod = reinterpret_cast<float*>(sp);
  sp += L.prod;
  float* dh1p = reinterpret_cast<float*>(sp);  // (rows, units) dh1' * z1
  sp += L.carry;
  float* dh0p = reinterpret_cast<float*>(sp);  // (rows, units) dh0' * z0
  sp += L.carry;
  float* pr_s = reinterpret_cast<float*>(sp);  // (H) pre rounded to T
  float* dpr_s = pr_s + H;                     // (S) dprobs
  float* ds_s = dpr_s + S;                     // (S) dscores rounded to T

  // weight rows into shared memory, zero past nu rows and K columns
  const T* w3[4] = {p.wh1, p.wmid, p.wh0, p.wfeed};
  for (int i = tid; i < L.wrows * L.ld1; i += kDecThreads) {
    const int u = i / L.ld1, k = i % L.ld1;
    wcq_s[i] = u < nu && k < H ? p.wcq[(size_t)(u0 + u) * H + k] : from_f<T>(0.f);
  }
  for (int w = 0; w < 4; ++w) {
    for (int i = tid; i < L.wrows * L.ld3; i += kDecThreads) {
      const int u = i / L.ld3, k = i % L.ld3;
      w3_s[w][i] = u < nu && k < H3 ? w3[w][(size_t)(u0 + u) * H3 + k] : from_f<T>(0.f);
    }
  }
  // carries and the padding columns of the rounded copies start at zero
  const size_t gtid = (size_t)blockIdx.x * kDecThreads + tid;
  const size_t gstride = (size_t)gridDim.x * kDecThreads;
  for (size_t i = gtid; i < (size_t)B * H; i += gstride) p.dh00[i] = p.dh01[i] = p.dfeed[i] = 0.f;
  for (size_t i = gtid; i < (size_t)B * p.ld_pre; i += gstride)
    if ((int)(i % p.ld_pre) >= H) p.pre_c[i] = from_f<T>(0.f);
  for (size_t i = gtid; i < (size_t)4 * B * p.ld_act; i += gstride)
    if ((int)(i % p.ld_act) >= H3) p.act_c[i] = from_f<T>(0.f);
  grid.sync();

  const size_t act_n = (size_t)B * p.ld_act;
  T* dhp1_c = p.act_c;
  T* dx1_c = p.act_c + act_n;
  T* dhp0_c = p.act_c + 2 * act_n;
  T* dx0_c = p.act_c + 3 * act_n;
  const int lane = tid & 31, warp = tid >> 5;

  for (int t = T_len - 1; t >= 0; --t) {
    // phase 1: attention backward, a CTA per row
    for (int n = blockIdx.x; n < B; n += gridDim.x) {
      const size_t nt = (size_t)n * T_len + t;
      for (int k = tid; k < H; k += kDecThreads) {
        const float a = to_f(p.attn_hs[nt * H + k]);
        const float da = p.d_attn[nt * H + k] + __ldcg(p.dfeed + (size_t)n * H + k);
        const float pre = (1.f - a * a) * da;
        p.pre[nt * H + k] = pre;
        pr_s[k] = round_as<T>(pre);
        p.pre_c[(size_t)n * p.ld_pre + k] = from_f<T>(pre);
      }
      __syncthreads();
      for (int s = warp; s < S; s += kDecWarps) {
        const T* mv = p.mem_v + ((size_t)n * S + s) * H;
        float acc = 0.f;
#pragma unroll 8
        for (int k = lane; k < H; k += 32) acc += round_as<T>(pr_s[k] * to_f(mv[k]));
        acc = warp_sum(acc);
        if (lane == 0) dpr_s[s] = acc + p.d_probs[nt * S + s];
      }
      __syncthreads();
      if (warp == 0) {
        float dot = 0.f;
        for (int s = lane; s < S; s += 32) dot += dpr_s[s] * to_f(p.probs[nt * S + s]);
        dot = warp_sum(dot);
        for (int s = lane; s < S; s += 32) {
          const float d = to_f(p.probs[nt * S + s]) * (dpr_s[s] - dot);
          p.dscores[nt * S + s] = d;
          ds_s[s] = round_as<T>(d);
        }
      }
      __syncthreads();
      for (int j = tid; j < H; j += kDecThreads) {
        float c = 0.f;
        const T* kr = p.keys + (size_t)n * S * H + j;
#pragma unroll 8
        for (int s = 0; s < S; ++s) c += round_as<T>(ds_s[s] * to_f(kr[(size_t)s * H]));
        p.dk[(size_t)n * H + j] = c + __ldcg(p.dh01 + (size_t)n * H + j);
      }
      __syncthreads();
    }
    grid.sync();

    // phase 2: dh1' = dk + round(pre) @ Wc_q^T, then GRU1's cell backward
    if (items > 0) {
      CellIn first;
      auto load1 = [&](int i, CellIn& in) {
        const int m = r0 + i / nu, j = u0 + i % nu;
        load_gates(p.x1, p.hp1, ((size_t)m * T_len + t) * H3, j, H, in);
        in.h_prev = t == 0 ? p.h01[(size_t)m * H + j]
                           : to_f(p.h1s[((size_t)m * T_len + t - 1) * H + j]);
        in.a = __ldcg(p.dk + (size_t)m * H + j);
      };
      if (tid < items) load1(tid, first);
      block_product<T>(p.pre_c, p.ld_pre, H, wcq_s, L.ld1, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        CellIn in = first;
        if (i != tid) load1(i, in);
        const int mm = i / nu, u = i % nu, m = r0 + mm;
        const float dh = prod[mm * kDecUnitsMma + u] + in.a;
        dh1p[mm * units + u] =
            cell_bwd<T>(in, dh, ((size_t)m * T_len + t) * H3, u0 + u, H, p.dx1, p.dhp1,
                        dx1_c + (size_t)m * p.ld_act, dhp1_c + (size_t)m * p.ld_act);
      }
    }
    grid.sync();

    // phase 3: dh1 = dh1'z1 + round(dhp1) @ Wh1^T; dh0' = dmid * (round(dx1)
    // @ Wmid^T) + dh0, then GRU0's cell backward
    if (items > 0) {
      CellIn first;
      auto load0 = [&](int i, CellIn& in) {
        const int m = r0 + i / nu, j = u0 + i % nu;
        const size_t mt = (size_t)m * T_len + t;
        load_gates(p.x0, p.hp0, mt * H3, j, H, in);
        in.h_prev = t == 0 ? p.h00[(size_t)m * H + j]
                           : to_f(p.h0s[((size_t)m * T_len + t - 1) * H + j]);
        in.a = to_f(p.dmid[mt * H + j]);
        in.b = __ldcg(p.dh00 + (size_t)m * H + j);
      };
      if (tid < items) load0(tid, first);
      block_product<T>(dhp1_c, p.ld_act, H3, w3_s[0], L.ld3, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dh01[(size_t)(r0 + mm) * H + u0 + u] =
            dh1p[mm * units + u] + prod[mm * kDecUnitsMma + u];
      }
      block_product<T>(dx1_c, p.ld_act, H3, w3_s[1], L.ld3, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        CellIn in = first;
        if (i != tid) load0(i, in);
        const int mm = i / nu, u = i % nu, m = r0 + mm;
        const float dh = in.a * prod[mm * kDecUnitsMma + u] + in.b;
        dh0p[mm * units + u] =
            cell_bwd<T>(in, dh, ((size_t)m * T_len + t) * H3, u0 + u, H, p.dx0, p.dhp0,
                        dx0_c + (size_t)m * p.ld_act, dhp0_c + (size_t)m * p.ld_act);
      }
    }
    grid.sync();

    // phase 4: dh0 = dh0'z0 + round(dhp0) @ Wh0^T; dfeed = round(dx0) @ Wfeed^T
    if (items > 0) {
      block_product<T>(dhp0_c, p.ld_act, H3, w3_s[2], L.ld3, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dh00[(size_t)(r0 + mm) * H + u0 + u] =
            dh0p[mm * units + u] + prod[mm * kDecUnitsMma + u];
      }
      block_product<T>(dx0_c, p.ld_act, H3, w3_s[3], L.ld3, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dfeed[(size_t)(r0 + mm) * H + u0 + u] = prod[mm * kDecUnitsMma + u];
      }
    }
    if (t > 0) grid.sync();
  }
}

// The card's co-resident CTAs of the persistent kernel and its dynamic
// shared memory, for CTAs of `units` units and `rows` batch rows.
template <typename T>
cudaError_t decoder_bwd_occupancy(int rows, int S, int H, int units, int* max_blocks,
                                  int* smem_bytes) {
  const DecLayout<T> L(rows, S, H, units);
  *smem_bytes = (int)L.total;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_bwd_kernel<T>, kDecThreads,
                                                      L.total);
  *max_blocks = per_sm * sms;
  return err;
}

template <typename T>
int decoder_bwd(const T* emb_proj, const T* dmid, const float* h00, const float* h01,
                const T* wfeed, const T* wh0, const float* bh0, const T* wmid, const float* bmid,
                const T* wh1, const float* bh1, const T* keys, const T* mem_v, const T* wcq,
                const T* attn_hs, const T* h0s, const T* h1s, const T* probs,
                const float* d_attn, const float* d_probs, float* const* o, float* gates,
                float* fscratch, T* tscratch, int B, int T_len, int S, int H, int units, int rows,
                int grid, cudaStream_t stream) {
  const int H3 = 3 * H, M = B * T_len;
  const size_t G = (size_t)M * H3;
  float* x0 = gates;
  float* hp0 = gates + G;
  float* x1 = gates + 2 * G;
  float* hp1 = gates + 3 * G;
  OpArray<DecHoist<T>, 4> hoist{{
      {M, H3, H, nullptr, h0s, dmid, wmid, bmid, nullptr, x1, T_len, H, 0},
      {M, H3, H, h01, h1s, nullptr, wh1, bh1, nullptr, hp1, T_len, H, 1},
      {M, H3, H, nullptr, attn_hs, nullptr, wfeed, nullptr, emb_proj, x0, T_len, H, 1},
      {M, H3, H, h00, h0s, nullptr, wh0, bh0, nullptr, hp0, T_len, H, 1},
  }};
  tile_gemm<T>(hoist, stream);

  const size_t smem = DecLayout<T>(rows, S, H, units).total;
  const cudaError_t err = cudaFuncSetAttribute(
      decoder_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  DecBwd<T> p;
  p.dmid = dmid;
  p.wfeed = wfeed;
  p.wh0 = wh0;
  p.wmid = wmid;
  p.wh1 = wh1;
  p.wcq = wcq;
  p.keys = keys;
  p.mem_v = mem_v;
  p.attn_hs = attn_hs;
  p.h0s = h0s;
  p.h1s = h1s;
  p.probs = probs;
  p.h00 = h00;
  p.h01 = h01;
  p.d_attn = d_attn;
  p.d_probs = d_probs;
  p.x0 = x0;
  p.hp0 = hp0;
  p.x1 = x1;
  p.hp1 = hp1;
  p.dx0 = o[0];
  p.dhp0 = o[1];
  p.dx1 = o[2];
  p.dhp1 = o[3];
  p.pre = o[4];
  p.dscores = o[5];
  p.dh00 = o[6];
  p.dh01 = o[7];
  p.dfeed = fscratch;
  p.dk = fscratch + (size_t)B * H;
  p.ld_pre = pad32(H);
  p.ld_act = pad32(H3);
  p.pre_c = tscratch;
  p.act_c = tscratch + (size_t)B * p.ld_pre;
  p.B = B;
  p.T_len = T_len;
  p.S = S;
  p.H = H;
  p.units = units;
  p.unit_tiles = (H + units - 1) / units;
  p.rows = rows;
  void* args[] = {&p};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that is not co-resident
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(decoder_bwd_kernel<T>),
                                          dim3(grid), dim3(kDecThreads), args, smem, stream);
}

}  // namespace

// Forward over the sequence. dtype: 0 = float32, 1 = bfloat16 for every
// tensor but h00, h01, the biases and mask_bias (f32). emb_proj (B,T,3H),
// dmid (B,T,H), keys and mem_v (B,S,H), mask_bias (B,S); writes attn_hs,
// h0s, h1s (B,T,H) and probs (B,T,S). scratch: 6*B*H floats.
extern "C" int vmmt_decoder_fwd(int dtype, const void* emb_proj, const void* dmid,
                                const void* h00, const void* h01, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* mask_bias, void* attn_hs, void* h0s, void* h1s,
                                void* probs, void* scratch, int B, int T_len, int S, int H,
                                void* stream) {
  if (B == 0 || T_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(h00), static_cast<const float*>(h01),
                      static_cast<const float*>(bh0), static_cast<const float*>(bmid),
                      static_cast<const float*>(bh1), static_cast<const float*>(mask_bias)};
  if (dtype == 1) {
    using T = __nv_bfloat16;
    decoder_fwd<T>(static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
                   static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2],
                   static_cast<const T*>(wmid), f[3], static_cast<const T*>(wh1), f[4],
                   static_cast<const T*>(keys), static_cast<const T*>(mem_v),
                   static_cast<const T*>(wcq), f[5], static_cast<T*>(attn_hs),
                   static_cast<T*>(h0s), static_cast<T*>(h1s), static_cast<T*>(probs),
                   static_cast<float*>(scratch), B, T_len, S, H, s);
  } else {
    using T = float;
    decoder_fwd<T>(static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
                   static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2],
                   static_cast<const T*>(wmid), f[3], static_cast<const T*>(wh1), f[4],
                   static_cast<const T*>(keys), static_cast<const T*>(mem_v),
                   static_cast<const T*>(wcq), f[5], static_cast<T*>(attn_hs),
                   static_cast<T*>(h0s), static_cast<T*>(h1s), static_cast<T*>(probs),
                   static_cast<float*>(scratch), B, T_len, S, H, s);
  }
  return (int)cudaGetLastError();
}

// Backward over the sequence in two launches: the hoisted gate products and
// the persistent cooperative kernel on `grid` CTAs (co-resident, else an
// error), of which the first ceil(H / units) * ceil(B / rows) each own
// `units` hidden units (at most 8 in bf16, 4 in f32) of `rows` batch rows
// (a multiple of 16). Inputs as the forward's plus its four streams and d_attn (B,T,H), d_probs (B,T,S) in f32; writes dx0, dhp0,
// dx1, dhp1 (B,T,3H), pre (B,T,H), dscores (B,T,S), dh00, dh01 (B,H), all
// f32. Scratch: gates 4*B*T*3H floats, fscratch 2*B*H floats, tscratch
// B*pad32(H) + 4*B*pad32(3H) elements of the compute dtype (pad32 rounds up
// to a multiple of 32).
extern "C" int vmmt_decoder_bwd(int dtype, const void* emb_proj, const void* dmid,
                                const void* h00, const void* h01, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* attn_hs, const void* h0s, const void* h1s,
                                const void* probs, const void* d_attn, const void* d_probs,
                                void* dx0, void* dhp0, void* dx1, void* dhp1, void* pre,
                                void* dscores, void* dh00, void* dh01, void* gates,
                                void* fscratch, void* tscratch, int B, int T_len, int S, int H,
                                int units, int rows, int grid, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  const int max_units = dtype == 1 ? kDecUnitsMma : kDecUnitsFma;
  if (units < 1 || units > max_units || rows < 16 || rows % 16 != 0 ||
      grid < ((H + units - 1) / units) * ((B + rows - 1) / rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(h00), static_cast<const float*>(h01),
                      static_cast<const float*>(bh0), static_cast<const float*>(bmid),
                      static_cast<const float*>(bh1), static_cast<const float*>(d_attn),
                      static_cast<const float*>(d_probs)};
  float* o[] = {static_cast<float*>(dx0), static_cast<float*>(dhp0), static_cast<float*>(dx1),
                static_cast<float*>(dhp1), static_cast<float*>(pre),
                static_cast<float*>(dscores), static_cast<float*>(dh00),
                static_cast<float*>(dh01)};
  auto run = [&](auto zero) {
    using T = decltype(zero);
    return decoder_bwd<T>(
        static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
        static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2], static_cast<const T*>(wmid),
        f[3], static_cast<const T*>(wh1), f[4], static_cast<const T*>(keys),
        static_cast<const T*>(mem_v), static_cast<const T*>(wcq), static_cast<const T*>(attn_hs),
        static_cast<const T*>(h0s), static_cast<const T*>(h1s), static_cast<const T*>(probs), f[5],
        f[6], o, static_cast<float*>(gates), static_cast<float*>(fscratch),
        static_cast<T*>(tscratch), B, T_len, S, H, units, rows, grid, s);
  };
  const int err = dtype == 1 ? run(__nv_bfloat16{}) : run(float{});
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the backward's persistent kernel the card holds at once,
// and the dynamic shared memory of one CTA, for CTAs of `units` units and
// `rows` batch rows.
extern "C" int vmmt_decoder_bwd_occupancy(int dtype, int rows, int S, int H, int units,
                                          int* max_blocks, int* smem_bytes) {
  return (int)(dtype == 1
                   ? decoder_bwd_occupancy<__nv_bfloat16>(rows, S, H, units, max_blocks,
                                                          smem_bytes)
                   : decoder_bwd_occupancy<float>(rows, S, H, units, max_blocks, smem_bytes));
}
