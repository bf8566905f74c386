// The teacher-forced 2-layer input-feed GRU decoder with general attention
// over a whole sequence, forward and backward.
//
// Replaces two Pallas kernels of variational_mmt_tpu/ops/pallas/decoder.py:
//   _dec_fwd_kernel (decoder_fwd_pallas, pallas_call at :153)
//   _dec_bwd_kernel (decoder_bwd_pallas, pallas_call at :304)
// Every tensor but the biases, mask_bias and the f32 streams is in one
// compute dtype T (float, bfloat16 or float16). Per step t the forward computes
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
// column of h0', attention all of h1', the next step all of feed). So each
// pass walks time inside one persistent cooperative kernel, four phases a
// step separated by grid barriers. Each CTA owns a few hidden units (8 in
// bf16: one mma.sync n-tile; 4 in f32, FMAs on the CUDA cores, never TF32)
// of a tile of batch rows, so a GRU cell needs only its own CTA's products,
// and keeps its units' slices of the five weights in shared memory for the
// whole call: no weight is re-read from memory after the prologue. The
// products take the other CTAs' results as T-rounded copies with rows
// padded to 32 (zero past H) from L2, read with ld.global.cg past the L1,
// which is not coherent across SMs. In the attention phases a CTA takes a
// batch row (rows b, b + gridDim.x, ...), keys and mem_v from L2.
//
// What bounds both passes on this card is that serial chain. At B=64, T=25,
// S=24, H=500 a call's bytes and FLOPs bound it at 10-20 us; the chain of
// 4 T grid barriers, each after a product whose operand comes from L2 or
// after the attention, takes the time. The designs put on the chain only
// what depends on the step's own results and run the rest beside it.
//
// Forward, phases of step t (the products of phase 1 of step 0 that need
// only the initial state run after the prologue's barrier):
//   1. x0 = emb_proj[t] + round(feed) @ Wfeed (no product at t = 0: feed
//      starts at zero) and GRU0 with the hp0 of phase 4: h0' stays f32 in
//      the owner's shared memory and goes to h0s[t] and the exchange copy
//      rounded; the Wmid operand round(dmid[t] * h0'), rounded from the f32
//      h0' (not from h0s), goes to an exchange copy of its own;
//   2. x1 = round(dmid * h0') @ Wmid + bmid and GRU1 with the hp1 of phase 3;
//   3. the attention of the CTA's rows: scores, masked softmax (mask_bias
//      -1e9), probs[t] and the context into an f32 exchange;
//   4. attn = tanh(ctx + qw) for the owned cells, to attn_hs[t] and to the
//      exchange copy that is step t + 1's feed operand.
// Only the context leaves phase 3 and only attn phase 4, so their barriers
// are split: a CTA arrives as soon as those are written and, while the
// barrier completes, runs the products that only it reads: in phase 3 one
// pass over round(h1') with the slices [Wh1 | Wc_q] (hp1 of step t + 1
// and qw), in phase 4 hp0 of step t + 1 = round(h0') @ Wh0 + bh0 (h0'
// alternates between two exchange buffers, so step t + 1 does not
// overwrite it). The split barrier is a counter in global memory (atomic
// arrival after a fence, acquire loads while waiting); the prologue's is
// the cooperative groups grid barrier.
// Every sum runs in a fixed order (no atomics): repeats are bit-identical.
//
// Backward, two launches:
//   (a) The four gate products of the cells (round(dmid*h0s) @ Wmid,
//       round(h1_prev) @ Wh1, round(feed_prev) @ Wfeed, round(h0_prev) @
//       Wh0) read only saved forward streams, so one launch of the tiled
//       product (tile_gemm.cuh; tensor cores in bf16) computes them for
//       every (row, t) before the loop, biases and emb_proj folded in.
//   (b) The persistent kernel walks t = T-1 .. 0: attention backward (a CTA
//       per row); dh1' = dk + round(pre) @ Wc_q^T and GRU1's cell backward;
//       dh1 = dh1'z1 + round(dhp1) @ Wh1^T, dh0' = dmid * (round(dx1) @
//       Wmid^T) + dh0 and GRU0's cell backward; dh0 = dh0'z0 + round(dhp0)
//       @ Wh0^T and dfeed = round(dx0) @ Wfeed^T. Two CTAs fit an SM at
//       H=500 (113 KB of shared memory each in bf16).
//
// The streamed plan (kStream, both kernels). The resident plan above keeps
// each CTA's weight slices (13 H / units rows of H values) in shared memory
// and needs a co-resident CTA for every tile, so it stops where a slice
// and 16 rows outgrow 227 KB (bf16: the forward from H = 932, the backward
// from 1060) or where the tiles outnumber what the card holds at once (f32:
// the forward from H = 532, the backward from 536). The
// streamed kernels cap the grid at kDecStreamPerSm CTAs an SM (or the
// tiles, or B) and let each CTA take its tiles in turn within every phase;
// the weights stay in global memory, laid out once a call by the wrapper
// (ops/decoder.py _stream_weights) in the slices' own order, so that
// block_product reads its fragments through L2 (from HBM every step where
// the five weights exceed the 50 MB L2: bf16 above about 1387 units). The
// f32 carries move to global memory, each cell's read and written only by
// the thread that owns it; a tile's rows are capped (ops/decoder.py
// DEC_STREAM_MAX_ROWS), so a CTA's shared memory is the product buffer
// and the attention row, whatever H and B. The phases, barriers,
// exchanges, products and their rounding are the resident kernels'.
//
// Both kernels take an optional probe buffer: thread 0 of CTA 0 writes
// %globaltimer there at its start, after the prologue and as it arrives at
// and leaves each grid barrier (tools/phase_times.py reads it).
//
// float16 takes bf16's path in both kernels (is_mma in tile_gemm.cuh: the
// same mma.sync fragments with f16 operands, the same strides, tiling and
// shared memory); what this file says of bf16 holds for both. mask_bias
// stays f32 in every dtype: its -1e9 is -inf in float16.

#include <cooperative_groups.h>

#include "block_product.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kDecPhases = 4;    // grid-barrier phases of a step, both passes
// most CTAs an SM of the streamed kernels (their grid is as many an SM;
// launch bounds keep their registers within that)
constexpr int kDecStreamPerSm = 2;

// %globaltimer (ns) into probe[slot] from thread 0 of CTA 0, when probing
__device__ __forceinline__ void stamp(unsigned long long* probe, int slot) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    probe[slot] = ns;
  }
}

// End of phase `phase` of the `step`-th step processed: a grid barrier
// unless it is the call's last. When probing, CTA 0 stamps as its threads
// arrive (probe[2 + 2 * (step * kDecPhases + phase)]) and as it leaves (the
// next slot); probe[0] is the kernel's start and probe[1] the end of its
// prologue.
__device__ __forceinline__ void phase_end(cg::grid_group& grid, unsigned long long* probe,
                                          int step, int phase, bool barrier) {
  const int slot = 2 + 2 * (step * kDecPhases + phase);
  if (probe != nullptr) {
    __syncthreads();
    stamp(probe, slot);
  }
  if (barrier) grid.sync();
  stamp(probe, slot + 1);
}

// A grid barrier split into arrive and wait, on a counter in global
// memory that CTA 0 zeroes before a grid.sync: barrier i (counted from 0)
// is passed when the counter reaches (i + 1) * gridDim.x. Between its
// arrive and its wait a CTA may do work whose inputs no CTA overwrites
// before the next barrier and whose results stay its own. When probing, CTA
// 0 stamps as it arrives and as it leaves, in the slots of phase_end.
__device__ __forceinline__ void grid_arrive(unsigned int* count, unsigned long long* probe,
                                            int step, int phase) {
  __syncthreads();
  stamp(probe, 2 + 2 * (step * kDecPhases + phase));
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

__device__ __forceinline__ void grid_wait(const unsigned int* count, unsigned long long* probe,
                                          int step, int phase) {
  if (threadIdx.x == 0) {
    const unsigned int target = (step * kDecPhases + phase + 1) * gridDim.x;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
  stamp(probe, 3 + 2 * (step * kDecPhases + phase));
}

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

// ---------------------------------------------------------------------------
// Forward: one persistent cooperative kernel over the sequence.

// Shared-memory plan of the forward kernel for CTAs of `units` hidden units
// and `rows` batch rows (a multiple of 16): the units' gate columns of
// Wfeed, Wh0, Wmid and Wh1 (three n-tiles each, gate-major) and their
// columns of Wc_q (one n-tile, right after Wh1's, so that one pass over
// round(h1') computes both), transposed into (column, K) rows; the product
// buffer (4 n-tiles; in bf16 room for the K-split partial sums); the f32
// carries h0, h1 and qw (rows, units); the hidden products hp0, hp1 (rows,
// units, 3 gates); the attention row (query, two context halves, scores).
// Streamed (kStream): the product buffer and the attention row alone.
template <typename T>
struct DecFwdLayout {
  int ldw;
  size_t w3, w1, prod, carry, gates, attn, total;
  __host__ __device__ DecFwdLayout(int rows, int S, int H, int units, bool stream) {
    ldw = frag_ld<T>(H);
    w3 = stream ? 0 : align16((size_t)3 * tile_rows<T>() * ldw * sizeof(T));
    w1 = stream ? 0 : align16((size_t)tile_rows<T>() * ldw * sizeof(T));
    const int prod_rows = is_mma<T>() ? max(kDecWarps * 16, rows) : rows;
    prod = (size_t)prod_rows * 4 * kDecUnitsMma * sizeof(float);
    carry = stream ? 0 : align16((size_t)rows * units * sizeof(float));
    gates = stream ? 0 : align16((size_t)rows * units * 3 * sizeof(float));
    attn = align16((size_t)(3 * H + S) * sizeof(float));
    total = 4 * w3 + w1 + prod + 3 * carry + 2 * gates + attn;
  }
};

template <typename T>
struct DecFwd {
  const T *emb_proj, *dmid, *wfeed, *wh0, *wmid, *wh1, *wcq, *keys, *mem_v;
  const float *h00, *h01, *bh0, *bmid, *bh1, *mask_bias;
  T *attn_hs, *h0s, *h1s, *probs;
  // written and read inside the kernel across CTAs: read with __ldcg, from
  // L2, since an SM's L1 may hold a stale copy. (B, ldx) in T, zero past H:
  T* h0x;   // 2 x (B, ldx): round(h0') of step t in buffer t % 2
  T* h1x;   // round(h1'), also the attention's query
  T* midx;  // round(dmid * h0'), the Wmid operand
  T* ax;    // round(attn), the next step's feed operand
  float* ctx;  // (B,H) the attention context
  unsigned int* count;  // the split barrier's counter
  unsigned long long* probe;  // null, or 2 + 2 * kDecPhases * T_len stamps
  // streamed only: the five weights laid out as the resident CTAs' slices,
  // unit tile after unit tile (13 n-tiles of (tile_rows, ldw) a tile:
  // Wfeed's, Wh0's, Wmid's and Wh1's three, then Wc_q's), zero past H and
  // past each tile's units; and the f32 carries h0, h1, qw (B,H) and hp0,
  // hp1 (B,H,3), each cell's read and written only by the thread that owns
  // it (the same thread of the same CTA every step)
  const T* wt;
  float* carry;
  int B, T_len, S, H, units, unit_tiles, rows, ldx;
};

// Four values of T as one load: 8 bytes in 16 bits, 16 in f32
template <typename T>
using Quad = typename std::conditional<is_mma<T>(), uint2, float4>::type;

template <typename T>
__device__ __forceinline__ void unpack(const uint2& q, float (&v)[4]) {
  const float2 lo = unpack2<T>(q.x);
  const float2 hi = unpack2<T>(q.y);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

template <typename T>
__device__ __forceinline__ void unpack(const float4& q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

constexpr int kScorePos = 3;   // source positions a warp scores at once
constexpr int kScoreQuads = 4;  // quads of a key row a lane loads at once
constexpr int kCtxPos = 12;     // positions whose mem_v quads a thread loads at once

// The attention of batch row n at step t: the query round(h1') from the
// exchange, scores against keys (a warp a source position), masked softmax
// (one warp), probs[t], and the context (a thread 4 columns over half of
// the positions, the halves added in a fixed order) into ctx. Keys and
// mem_v are read as quads (H is a multiple of 4 and both are 16-byte
// aligned: the wrapper's plan and copies see to it), and a thread starts a
// batch of quad loads before it uses any, so their L2 latencies overlap.
// q_s (H), part_s (2H), p_s (S) in shared memory.
template <typename T>
__device__ void attention_row(const DecFwd<T>& p, int n, int t, float* q_s, float* part_s,
                              float* p_s) {
  const int S = p.S, H = p.H, nq = H / 4, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* keys = p.keys + (size_t)n * S * H;
  const T* mem_v = p.mem_v + (size_t)n * S * H;
  for (int k = tid; k < H; k += kDecThreads) q_s[k] = to_f(__ldcg(p.h1x + (size_t)n * p.ldx + k));
  __syncthreads();
  for (int s = warp; s < S; s += kDecWarps * kScorePos) {
    float acc[kScorePos] = {};
    for (int c0 = lane; c0 < nq; c0 += 32 * kScoreQuads) {
      Quad<T> raw[kScorePos][kScoreQuads];
#pragma unroll
      for (int a = 0; a < kScorePos; ++a) {
        const int sa = s + a * kDecWarps;
        const Quad<T>* row = reinterpret_cast<const Quad<T>*>(keys + (size_t)sa * H);
#pragma unroll
        for (int i = 0; i < kScoreQuads; ++i) {
          const int c = c0 + 32 * i;
          raw[a][i] = sa < S && c < nq ? row[c] : Quad<T>{};
        }
      }
#pragma unroll
      for (int a = 0; a < kScorePos; ++a) {
#pragma unroll
        for (int i = 0; i < kScoreQuads; ++i) {
          const int c = c0 + 32 * i;
          if (c < nq) {
            float v[4];
            unpack<T>(raw[a][i], v);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a] += round_as<T>(q_s[4 * c + e] * v[e]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kScorePos; ++a) {
      const int sa = s + a * kDecWarps;
      const float v = warp_sum(acc[a]);
      if (lane == 0 && sa < S) p_s[sa] = v + p.mask_bias[(size_t)n * S + sa];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, p_s[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(p_s[s] - mx);
      p_s[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    T* pr = p.probs + ((size_t)n * p.T_len + t) * S;
    for (int s = lane; s < S; s += 32) {
      const float v = p_s[s] / sum;
      pr[s] = from_f<T>(v);
      p_s[s] = round_as<T>(v);
    }
  }
  __syncthreads();
  constexpr int kHalf = kDecThreads / 2;
  const int half = tid / kHalf, s_mid = (S + 1) / 2;
  const int s0 = half ? s_mid : 0, s1 = half ? S : s_mid;
  for (int c = tid % kHalf; c < nq; c += kHalf) {
    float acc[4] = {};
    for (int sb = s0; sb < s1; sb += kCtxPos) {
      Quad<T> raw[kCtxPos];
#pragma unroll
      for (int b = 0; b < kCtxPos; ++b)
        raw[b] = sb + b < s1 ? reinterpret_cast<const Quad<T>*>(mem_v + (size_t)(sb + b) * H)[c]
                             : Quad<T>{};
#pragma unroll
      for (int b = 0; b < kCtxPos; ++b) {
        if (sb + b < s1) {
          float v[4];
          unpack<T>(raw[b], v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += round_as<T>(p_s[sb + b] * v[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) part_s[half * H + 4 * c + e] = acc[e];
  }
  __syncthreads();
  for (int j = tid; j < H; j += kDecThreads) p.ctx[(size_t)n * H + j] = part_s[j] + part_s[H + j];
  __syncthreads();  // q_s, part_s and p_s are free for the next row
}

// Tile b of the launch's unit_tiles * (B / rows rounded up) tiles owns
// hidden units [(b % unit_tiles) * units, +units) of batch rows [(b /
// unit_tiles) * rows, +rows); the four phases of a step are those of the
// note at the top. Resident: CTA b holds tile b, its weight slices and
// carries in shared memory. Streamed (kStream): CTA b takes tiles b, b +
// gridDim.x, ... in turn within each phase, reads each tile's weight slices
// from wt (through L2) and keeps its carries in global memory.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kDecThreads, kStream ? kDecStreamPerSm : 1)
decoder_fwd_kernel(DecFwd<T> p) {
  stamp(p.probe, 0);
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, T_len = p.T_len, S = p.S, H = p.H, H3 = 3 * H, units = p.units;
  const int ldx = p.ldx, tid = threadIdx.x;
  const int tiles = p.unit_tiles * ((B + p.rows - 1) / p.rows);
  constexpr int tr = tile_rows<T>(), PS3 = 3 * kDecUnitsMma, PS4 = 4 * kDecUnitsMma;
  const DecFwdLayout<T> L(p.rows, S, H, units, kStream);
  const int ldw = L.ldw;
  const size_t wn = (size_t)3 * tr * ldw;  // one weight's three n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  // resident: Wfeed, Wh0, Wmid, Wh1 (3 n-tiles each) and Wc_q (1), wn apart
  T* w_s = reinterpret_cast<T*>(sp);
  sp += 4 * L.w3 + L.w1;
  float* prod = reinterpret_cast<float*>(sp);
  sp += L.prod;
  // the f32 carries h0, h1, qw (at a cell's index) and the hidden products
  // plus bias hp0, hp1 (3 a cell): (rows, units) in shared memory, or (B,
  // H) in global memory (cell_of)
  float *h0c, *h1c, *qw_s, *hp0_s, *hp1_s;
  if constexpr (kStream) {
    const size_t bh = (size_t)B * H;
    h0c = p.carry;
    h1c = p.carry + bh;
    qw_s = p.carry + 2 * bh;
    hp0_s = p.carry + 3 * bh;
    hp1_s = p.carry + 6 * bh;
  } else {
    h0c = reinterpret_cast<float*>(sp);
    h1c = reinterpret_cast<float*>(sp + L.carry);
    qw_s = reinterpret_cast<float*>(sp + 2 * L.carry);
    hp0_s = reinterpret_cast<float*>(sp + 3 * L.carry);
    hp1_s = reinterpret_cast<float*>(sp + 3 * L.carry + L.gates);
    sp += 3 * L.carry + 2 * L.gates;
  }
  float* q_s = reinterpret_cast<float*>(sp);  // (H) attention query
  float* part_s = q_s + H;                     // (2H) context halves
  float* p_s = part_s + 2 * H;                 // (S) scores, then probs
  auto cell_of = [&](const WideTile& c, int mm, int u) -> size_t {
    return kStream ? (size_t)(c.r0 + mm) * H + c.u0 + u : (size_t)mm * units + u;
  };
  // tile c's weight slices: shared memory, or the tile's slices in wt
  auto w_of = [&](const WideTile& c) -> const T* {
    return kStream ? p.wt + (size_t)c.ut * (4 * wn + (size_t)tr * ldw) : w_s;
  };

  if constexpr (!kStream) {
    if ((int)blockIdx.x < tiles) {
      // weight columns into shared memory, transposed: row g * tr + u of a
      // slice is column g * H + u0 + u of W (H,3H), zero past nu rows and H
      // columns; a thread reads a unit, so neighbouring threads read
      // neighbouring columns
      const WideTile c(blockIdx.x, p.unit_tiles, units, p.rows, H, B);
      const T* w3[4] = {p.wfeed, p.wh0, p.wmid, p.wh1};
#pragma unroll  // static indices into w3: no local-memory arrays
      for (int w = 0; w < 4; ++w) {
        for (int i = tid; i < ldw * 3 * tr; i += kDecThreads) {
          const int u = i % tr, g = (i / tr) % 3, k = i / (3 * tr);
          w_s[w * wn + (g * tr + u) * ldw + k] =
              u < c.nu && k < H ? w3[w][(size_t)k * H3 + g * H + c.u0 + u] : from_f<T>(0.f);
        }
      }
      for (int i = tid; i < ldw * tr; i += kDecThreads) {
        const int u = i % tr, k = i / tr;
        w_s[4 * wn + u * ldw + k] =
            u < c.nu && k < H ? p.wcq[(size_t)k * H + c.u0 + u] : from_f<T>(0.f);
      }
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
    for (int i = tid; i < c.nr * c.nu; i += kDecThreads) {
      const int mm = i / c.nu, u = i % c.nu;
      const size_t off = (size_t)(c.r0 + mm) * H + c.u0 + u;
      h0c[cell_of(c, mm, u)] = p.h00[off];
      h1c[cell_of(c, mm, u)] = p.h01[off];
    }
  }
  // exchanges: the rounded initial states (h0 in the buffer that step 0
  // does not write); zero padding columns; the barrier's counter
  const size_t gtid = (size_t)blockIdx.x * kDecThreads + tid;
  const size_t gstride = (size_t)gridDim.x * kDecThreads;
  const size_t xn = (size_t)B * ldx;
  T* h0x_init = p.h0x + xn;
  for (size_t i = gtid; i < xn; i += gstride) {
    const int k = (int)(i % ldx);
    const size_t off = (i / ldx) * H + k;
    h0x_init[i] = from_f<T>(k < H ? p.h00[off] : 0.f);
    p.h1x[i] = from_f<T>(k < H ? p.h01[off] : 0.f);
    p.h0x[i] = p.midx[i] = p.ax[i] = from_f<T>(0.f);
  }
  if (gtid == 0) *p.count = 0u;
  grid.sync();
  stamp(p.probe, 1);

  // hp = product + bias for tile c's cells, from n-tiles 0..2 of prod
  // (rows ps apart)
  auto keep_gates = [&](const WideTile& c, float* hp_s, const float* bias, int ps) {
    for (int i = tid; i < c.nr * c.nu; i += kDecThreads) {
      const int mm = i / c.nu, u = i % c.nu;
      const size_t cc = cell_of(c, mm, u);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        hp_s[cc * 3 + g] = prod[mm * ps + g * 8 + u] + bias[g * H + c.u0 + u];
    }
  };
  // step 0's hidden products, from the initial states
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
    if (c.nr * c.nu == 0) continue;
    block_product<T, 3>(h0x_init, ldx, H, w_of(c) + wn, ldw, c.nu, c.r0, c.nr, prod);
    keep_gates(c, hp0_s, p.bh0, PS3);
    block_product<T, 3>(p.h1x, ldx, H, w_of(c) + 3 * wn, ldw, c.nu, c.r0, c.nr, prod);
    keep_gates(c, hp1_s, p.bh1, PS3);
  }

  struct In0 {
    float x[3], dm;
  };
  for (int t = 0; t < T_len; ++t) {
    T* h0x = p.h0x + (t % 2) * xn;
    // phase 1: x0 = emb_proj[t] + round(feed) @ Wfeed, GRU0
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      const int nu = c.nu, items = c.nr * nu;
      if (items == 0) continue;
      auto load0 = [&](int i, In0& in) {
        const size_t mt = (size_t)(c.r0 + i / nu) * T_len + t;
        const int j = c.u0 + i % nu;
#pragma unroll
        for (int g = 0; g < 3; ++g) in.x[g] = to_f(p.emb_proj[mt * H3 + g * H + j]);
        in.dm = to_f(p.dmid[mt * H + j]);
      };
      In0 first;
      if (tid < items) load0(tid, first);
      if (t > 0) block_product<T, 3>(p.ax, ldx, H, w_of(c), ldw, nu, c.r0, c.nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        In0 in = first;
        if (i != tid) load0(i, in);
        const int mm = i / nu, u = i % nu, m = c.r0 + mm, j = c.u0 + u;
        const size_t cc = cell_of(c, mm, u);
        float x[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) x[g] = t > 0 ? in.x[g] + prod[mm * PS3 + g * 8 + u] : in.x[g];
        const float h = gru_cell(x, hp0_s + cc * 3, h0c[cc]);
        h0c[cc] = h;
        p.h0s[((size_t)m * T_len + t) * H + j] = from_f<T>(h);
        h0x[(size_t)m * ldx + j] = from_f<T>(h);
        p.midx[(size_t)m * ldx + j] = from_f<T>(in.dm * h);
      }
    }
    grid_arrive(p.count, p.probe, t, 0);
    grid_wait(p.count, p.probe, t, 0);

    // phase 2: x1 = round(dmid * h0') @ Wmid + bmid, GRU1
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      const int nu = c.nu, items = c.nr * nu;
      if (items == 0) continue;
      block_product<T, 3>(p.midx, ldx, H, w_of(c) + 2 * wn, ldw, nu, c.r0, c.nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu, m = c.r0 + mm, j = c.u0 + u;
        const size_t cc = cell_of(c, mm, u);
        float x[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) x[g] = prod[mm * PS3 + g * 8 + u] + p.bmid[g * H + j];
        const float h = gru_cell(x, hp1_s + cc * 3, h1c[cc]);
        h1c[cc] = h;
        p.h1s[((size_t)m * T_len + t) * H + j] = from_f<T>(h);
        p.h1x[(size_t)m * ldx + j] = from_f<T>(h);
      }
    }
    grid_arrive(p.count, p.probe, t, 1);
    grid_wait(p.count, p.probe, t, 1);

    // phase 3: the attention of this CTA's rows; then, as the barrier
    // completes, round(h1') @ [Wh1 | Wc_q] (hp1 of step t + 1 and qw, both
    // the tile's own; h1x is next written two barriers on)
    for (int n = blockIdx.x; n < B; n += gridDim.x) attention_row(p, n, t, q_s, part_s, p_s);
    grid_arrive(p.count, p.probe, t, 2);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      if (c.nr * c.nu == 0) continue;
      block_product<T, 4>(p.h1x, ldx, H, w_of(c) + 3 * wn, ldw, c.nu, c.r0, c.nr, prod);
      keep_gates(c, hp1_s, p.bh1, PS4);
      for (int i = tid; i < c.nr * c.nu; i += kDecThreads) {
        const int mm = i / c.nu, u = i % c.nu;
        qw_s[cell_of(c, mm, u)] = prod[mm * PS4 + 3 * 8 + u];
      }
    }
    grid_wait(p.count, p.probe, t, 2);

    // phase 4: attn = tanh(ctx + qw), the next feed; then, as the barrier
    // completes, hp0 of step t + 1 (from this step's h0x buffer, which step
    // t + 1 does not write)
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      for (int i = tid; i < c.nr * c.nu; i += kDecThreads) {
        const int mm = i / c.nu, u = i % c.nu, m = c.r0 + mm, j = c.u0 + u;
        const float v = tanhf(__ldcg(p.ctx + (size_t)m * H + j) + qw_s[cell_of(c, mm, u)]);
        p.attn_hs[((size_t)m * T_len + t) * H + j] = from_f<T>(v);
        p.ax[(size_t)m * ldx + j] = from_f<T>(v);
      }
    }
    if (t + 1 < T_len) {
      grid_arrive(p.count, p.probe, t, 3);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
        if (c.nr * c.nu == 0) continue;
        block_product<T, 3>(h0x, ldx, H, w_of(c) + wn, ldw, c.nu, c.r0, c.nr, prod);
        keep_gates(c, hp0_s, p.bh0, PS3);
      }
      grid_wait(p.count, p.probe, t, 3);
    } else {
      phase_end(grid, p.probe, t, 3, false);
    }
  }
}

template <typename T>
int decoder_fwd(const T* emb_proj, const T* dmid, const float* h00, const float* h01,
                const T* wfeed, const T* wh0, const float* bh0, const T* wmid, const float* bmid,
                const T* wh1, const float* bh1, const T* keys, const T* mem_v, const T* wcq,
                const float* mask_bias, T* attn_hs, T* h0s, T* h1s, T* probs, T* tscratch,
                float* fscratch, const T* wt, unsigned long long* probe, int B, int T_len,
                int S, int H, int units, int rows, int grid, cudaStream_t stream) {
  const bool streamed = wt != nullptr;
  const size_t smem = DecFwdLayout<T>(rows, S, H, units, streamed).total;
  void* kernel = streamed ? reinterpret_cast<void*>(decoder_fwd_kernel<T, true>)
                          : reinterpret_cast<void*>(decoder_fwd_kernel<T, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  DecFwd<T> p;
  p.emb_proj = emb_proj;
  p.dmid = dmid;
  p.wfeed = wfeed;
  p.wh0 = wh0;
  p.wmid = wmid;
  p.wh1 = wh1;
  p.wcq = wcq;
  p.keys = keys;
  p.mem_v = mem_v;
  p.h00 = h00;
  p.h01 = h01;
  p.bh0 = bh0;
  p.bmid = bmid;
  p.bh1 = bh1;
  p.mask_bias = mask_bias;
  p.attn_hs = attn_hs;
  p.h0s = h0s;
  p.h1s = h1s;
  p.probs = probs;
  p.ldx = pad32(H);
  const size_t xn = (size_t)B * p.ldx;
  p.h0x = tscratch;
  p.h1x = tscratch + 2 * xn;
  p.midx = tscratch + 3 * xn;
  p.ax = tscratch + 4 * xn;
  p.ctx = fscratch;
  p.wt = wt;
  p.carry = streamed ? fscratch + (size_t)B * H : nullptr;
  p.count = reinterpret_cast<unsigned int*>(fscratch + (size_t)B * H * (streamed ? 10 : 1));
  p.probe = probe;
  p.B = B;
  p.T_len = T_len;
  p.S = S;
  p.H = H;
  p.units = units;
  p.unit_tiles = (H + units - 1) / units;
  p.rows = rows;
  void* args[] = {&p};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that is not co-resident
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDecThreads), args, smem,
                                          stream);
}

// ---------------------------------------------------------------------------
// Backward: the hoisted gate products, then one persistent cooperative
// kernel over time.

// Shared-memory plan of the backward kernel for CTAs of `units` hidden
// units and `rows` batch rows (a multiple of 16): the units' rows of Wc_q
// (K = H) and of Wh1, Wmid, Wh0, Wfeed (K = 3H), the product buffer, the
// f32 carries dh1' z1 and dh0' z0 (rows, units) and the attention row.
// Streamed (kStream): the product buffer and the attention row alone.
template <typename T>
struct DecLayout {
  int wrows, ld1, ld3, prod_rows;
  size_t w1, w3, prod, carry, attn, total;
  __host__ __device__ DecLayout(int rows, int S, int H, int units, bool stream) {
    wrows = is_mma<T>() ? kDecUnitsMma : units;
    ld1 = frag_ld<T>(H);
    ld3 = frag_ld<T>(3 * H);
    prod_rows = is_mma<T>() ? max(kDecWarps * 16, rows) : rows;  // >= kp * 16 * tiles
    w1 = stream ? 0 : align16((size_t)wrows * ld1 * sizeof(T));
    w3 = stream ? 0 : align16((size_t)wrows * ld3 * sizeof(T));
    prod = (size_t)prod_rows * kDecUnitsMma * sizeof(float);
    carry = stream ? 0 : align16((size_t)rows * units * sizeof(float));
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
  unsigned long long* probe;  // null, or 2 + 2 * kDecPhases * T_len stamps
  // streamed only: the five weights laid out as the resident CTAs' slices,
  // unit tile after unit tile (a tile's rows of Wc_q (wrows, ld1), then of
  // Wh1, Wmid, Wh0 and Wfeed (wrows, ld3) each), zero past H and past each
  // row's width; and the f32 carries dh1' z1 and dh0' z0 (B,H), each cell's
  // read and written only by the thread that owns it
  const T* wt;
  float* carry;
  int B, T_len, S, H, units, unit_tiles, rows, ld_pre, ld_act;
};

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

// The reverse scan. Tile b of unit_tiles * (B / rows rounded up) owns
// hidden units [(b % unit_tiles) * units, +units) of batch rows [(b /
// unit_tiles) * rows, +rows); resident, CTA b holds tile b with the units'
// rows of the five weights in shared memory; streamed (kStream), CTA b
// takes tiles b, b + gridDim.x, ... in turn, reading each tile's rows from
// wt (through L2), with its carries in global memory. In the attention
// phase every CTA takes batch rows b, b + gridDim.x, ... Four phases a
// step, separated by grid barriers (see the note at the top).
template <typename T, bool kStream>
__global__ void __launch_bounds__(kDecThreads, kStream ? kDecStreamPerSm : 1)
decoder_bwd_kernel(DecBwd<T> p) {
  stamp(p.probe, 0);
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, T_len = p.T_len, S = p.S, H = p.H, H3 = 3 * H, units = p.units;
  const int tid = threadIdx.x;
  const int tiles = p.unit_tiles * ((B + p.rows - 1) / p.rows);
  const DecLayout<T> L(p.rows, S, H, units, kStream);
  const size_t w1n = (size_t)L.wrows * L.ld1, w3n = (size_t)L.wrows * L.ld3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  // resident: Wc_q[u0 + u, :], then Wh1, Wmid, Wh0, Wfeed rows u0 + u (in
  // the order of act_c), w1n and then w3n apart
  T* w_s = reinterpret_cast<T*>(sp);
  sp += L.w1 + 4 * L.w3;
  float* prod = reinterpret_cast<float*>(sp);
  sp += L.prod;
  // the f32 carries dh1' z1 and dh0' z0: (rows, units) in shared memory, or
  // (B, H) in global memory (cell_of)
  float *dh1p, *dh0p;
  if constexpr (kStream) {
    dh1p = p.carry;
    dh0p = p.carry + (size_t)B * H;
  } else {
    dh1p = reinterpret_cast<float*>(sp);
    dh0p = reinterpret_cast<float*>(sp + L.carry);
    sp += 2 * L.carry;
  }
  float* pr_s = reinterpret_cast<float*>(sp);  // (H) pre rounded to T
  float* dpr_s = pr_s + H;                     // (S) dprobs
  float* ds_s = dpr_s + S;                     // (S) dscores rounded to T
  auto cell_of = [&](const WideTile& c, int mm, int u) -> size_t {
    return kStream ? (size_t)(c.r0 + mm) * H + c.u0 + u : (size_t)mm * units + u;
  };
  // tile c's Wc_q rows; its rows of weight w (0 Wh1, 1 Wmid, 2 Wh0, 3 Wfeed)
  // are w1n + w * w3n further
  auto w_of = [&](const WideTile& c) -> const T* {
    return kStream ? p.wt + (size_t)c.ut * (w1n + 4 * w3n) : w_s;
  };

  if constexpr (!kStream) {
    if ((int)blockIdx.x < tiles) {
      // weight rows into shared memory, zero past nu rows and K columns
      const WideTile c(blockIdx.x, p.unit_tiles, units, p.rows, H, B);
      const T* w3[4] = {p.wh1, p.wmid, p.wh0, p.wfeed};
      for (int i = tid; i < L.wrows * L.ld1; i += kDecThreads) {
        const int u = i / L.ld1, k = i % L.ld1;
        w_s[i] = u < c.nu && k < H ? p.wcq[(size_t)(c.u0 + u) * H + k] : from_f<T>(0.f);
      }
      for (int w = 0; w < 4; ++w) {
        for (int i = tid; i < L.wrows * L.ld3; i += kDecThreads) {
          const int u = i / L.ld3, k = i % L.ld3;
          w_s[w1n + w * w3n + i] =
              u < c.nu && k < H3 ? w3[w][(size_t)(c.u0 + u) * H3 + k] : from_f<T>(0.f);
        }
      }
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
  stamp(p.probe, 1);

  const size_t act_n = (size_t)B * p.ld_act;
  T* dhp1_c = p.act_c;
  T* dx1_c = p.act_c + act_n;
  T* dhp0_c = p.act_c + 2 * act_n;
  T* dx0_c = p.act_c + 3 * act_n;
  const int lane = tid & 31, warp = tid >> 5;

  for (int t = T_len - 1; t >= 0; --t) {
    const int step = T_len - 1 - t;
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
    phase_end(grid, p.probe, step, 0, true);

    // phase 2: dh1' = dk + round(pre) @ Wc_q^T, then GRU1's cell backward
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      const int nu = c.nu, r0 = c.r0, items = c.nr * nu;
      if (items == 0) continue;
      CellIn first;
      auto load1 = [&](int i, CellIn& in) {
        const int m = r0 + i / nu, j = c.u0 + i % nu;
        load_gates(p.x1, p.hp1, ((size_t)m * T_len + t) * H3, j, H, in);
        in.h_prev = t == 0 ? p.h01[(size_t)m * H + j]
                           : to_f(p.h1s[((size_t)m * T_len + t - 1) * H + j]);
        in.a = __ldcg(p.dk + (size_t)m * H + j);
      };
      if (tid < items) load1(tid, first);
      block_product<T>(p.pre_c, p.ld_pre, H, w_of(c), L.ld1, nu, r0, c.nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        CellIn in = first;
        if (i != tid) load1(i, in);
        const int mm = i / nu, u = i % nu, m = r0 + mm;
        const float dh = prod[mm * kDecUnitsMma + u] + in.a;
        dh1p[cell_of(c, mm, u)] =
            cell_bwd<T>(in, dh, ((size_t)m * T_len + t) * H3, c.u0 + u, H, p.dx1, p.dhp1,
                        dx1_c + (size_t)m * p.ld_act, dhp1_c + (size_t)m * p.ld_act);
      }
    }
    phase_end(grid, p.probe, step, 1, true);

    // phase 3: dh1 = dh1'z1 + round(dhp1) @ Wh1^T; dh0' = dmid * (round(dx1)
    // @ Wmid^T) + dh0, then GRU0's cell backward
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      const int nu = c.nu, r0 = c.r0, items = c.nr * nu;
      if (items == 0) continue;
      CellIn first;
      auto load0 = [&](int i, CellIn& in) {
        const int m = r0 + i / nu, j = c.u0 + i % nu;
        const size_t mt = (size_t)m * T_len + t;
        load_gates(p.x0, p.hp0, mt * H3, j, H, in);
        in.h_prev = t == 0 ? p.h00[(size_t)m * H + j]
                           : to_f(p.h0s[((size_t)m * T_len + t - 1) * H + j]);
        in.a = to_f(p.dmid[mt * H + j]);
        in.b = __ldcg(p.dh00 + (size_t)m * H + j);
      };
      if (tid < items) load0(tid, first);
      block_product<T>(dhp1_c, p.ld_act, H3, w_of(c) + w1n, L.ld3, nu, r0, c.nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dh01[(size_t)(r0 + mm) * H + c.u0 + u] =
            dh1p[cell_of(c, mm, u)] + prod[mm * kDecUnitsMma + u];
      }
      block_product<T>(dx1_c, p.ld_act, H3, w_of(c) + w1n + w3n, L.ld3, nu, r0, c.nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        CellIn in = first;
        if (i != tid) load0(i, in);
        const int mm = i / nu, u = i % nu, m = r0 + mm;
        const float dh = in.a * prod[mm * kDecUnitsMma + u] + in.b;
        dh0p[cell_of(c, mm, u)] =
            cell_bwd<T>(in, dh, ((size_t)m * T_len + t) * H3, c.u0 + u, H, p.dx0, p.dhp0,
                        dx0_c + (size_t)m * p.ld_act, dhp0_c + (size_t)m * p.ld_act);
      }
    }
    phase_end(grid, p.probe, step, 2, true);

    // phase 4: dh0 = dh0'z0 + round(dhp0) @ Wh0^T; dfeed = round(dx0) @ Wfeed^T
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WideTile c(tile, p.unit_tiles, units, p.rows, H, B);
      const int nu = c.nu, r0 = c.r0, items = c.nr * nu;
      if (items == 0) continue;
      block_product<T>(dhp0_c, p.ld_act, H3, w_of(c) + w1n + 2 * w3n, L.ld3, nu, r0, c.nr,
                       prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dh00[(size_t)(r0 + mm) * H + c.u0 + u] =
            dh0p[cell_of(c, mm, u)] + prod[mm * kDecUnitsMma + u];
      }
      block_product<T>(dx0_c, p.ld_act, H3, w_of(c) + w1n + 3 * w3n, L.ld3, nu, r0, c.nr,
                       prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu;
        p.dfeed[(size_t)(r0 + mm) * H + c.u0 + u] = prod[mm * kDecUnitsMma + u];
      }
    }
    phase_end(grid, p.probe, step, 3, t > 0);
  }
}

template <typename T>
int decoder_bwd(const T* emb_proj, const T* dmid, const float* h00, const float* h01,
                const T* wfeed, const T* wh0, const float* bh0, const T* wmid, const float* bmid,
                const T* wh1, const float* bh1, const T* keys, const T* mem_v, const T* wcq,
                const T* attn_hs, const T* h0s, const T* h1s, const T* probs,
                const float* d_attn, const float* d_probs, float* const* o, float* gates,
                float* fscratch, T* tscratch, const T* wt, unsigned long long* probe, int B,
                int T_len, int S, int H, int units, int rows, int grid, cudaStream_t stream) {
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

  const bool streamed = wt != nullptr;
  const size_t smem = DecLayout<T>(rows, S, H, units, streamed).total;
  void* kernel = streamed ? reinterpret_cast<void*>(decoder_bwd_kernel<T, true>)
                          : reinterpret_cast<void*>(decoder_bwd_kernel<T, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  p.wt = wt;
  p.carry = streamed ? fscratch + 2 * (size_t)B * H : nullptr;
  p.ld_pre = pad32(H);
  p.ld_act = pad32(H3);
  p.pre_c = tscratch;
  p.act_c = tscratch + (size_t)B * p.ld_pre;
  p.probe = probe;
  p.B = B;
  p.T_len = T_len;
  p.S = S;
  p.H = H;
  p.units = units;
  p.unit_tiles = (H + units - 1) / units;
  p.rows = rows;
  void* args[] = {&p};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that is not co-resident
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDecThreads), args, smem,
                                          stream);
}

}  // namespace

// Checks the CTA tiling that a launch plan gives (units at most 8 in bf16
// and f16, 4 in f32; rows a multiple of 16; resident, a CTA for every
// tile; streamed, at least one CTA).
static bool valid_tiling(int dtype, int B, int H, int units, int rows, int grid, bool streamed) {
  const int max_units = dtype == 0 ? kDecUnitsFma : kDecUnitsMma;
  const int tiles = ((H + units - 1) / units) * ((B + rows - 1) / rows);
  return known_dtype(dtype) && units >= 1 && units <= max_units && rows >= 16 && rows % 16 == 0 &&
         grid >= (streamed ? 1 : tiles);
}

// Forward over the sequence in one persistent cooperative launch on `grid`
// CTAs (co-resident, else an error). Its tiles, ceil(H / units) *
// ceil(B / rows), each own `units` hidden units (at most 8 in bf16 and f16,
// 4 in f32) of `rows` batch rows (a multiple of 16). wt null: the resident
// plan, a CTA a tile (grid at least the tiles); else the streamed plan, wt
// the five weights laid out as DecFwd::wt says (ops/decoder.py
// _stream_weights), each CTA taking tiles in turn. dtype: 0 = float32, 1 =
// bfloat16, 2 = float16 for every tensor but h00, h01, the biases and
// mask_bias (f32); any other code is cudaErrorInvalidValue, in every entry.
// H a multiple of 4. emb_proj (B,T,3H), dmid (B,T,H), keys and mem_v
// (B,S,H) 16-byte aligned, mask_bias (B,S);
// writes attn_hs, h0s, h1s (B,T,H) and probs (B,T,S). Scratch: tscratch
// 5*B*pad32(H) elements of the compute dtype (pad32 rounds up to a multiple
// of 32), fscratch B*H + 1 floats (streamed: 10*B*H + 1). probe: null, or
// 2 + 8*T 64-bit stamps.
extern "C" int vmmt_decoder_fwd(int dtype, const void* emb_proj, const void* dmid,
                                const void* h00, const void* h01, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* mask_bias, void* attn_hs, void* h0s, void* h1s,
                                void* probs, void* tscratch, void* fscratch, const void* wt,
                                void* probe, int B, int T_len, int S, int H, int units, int rows,
                                int grid, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  if (!valid_tiling(dtype, B, H, units, rows, grid, wt != nullptr) || H % 4 != 0 ||
      reinterpret_cast<uintptr_t>(keys) % 16 != 0 || reinterpret_cast<uintptr_t>(mem_v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(h00), static_cast<const float*>(h01),
                      static_cast<const float*>(bh0), static_cast<const float*>(bmid),
                      static_cast<const float*>(bh1), static_cast<const float*>(mask_bias)};
  auto run = [&](auto zero) {
    using T = decltype(zero);
    return decoder_fwd<T>(
        static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
        static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2], static_cast<const T*>(wmid),
        f[3], static_cast<const T*>(wh1), f[4], static_cast<const T*>(keys),
        static_cast<const T*>(mem_v), static_cast<const T*>(wcq), f[5], static_cast<T*>(attn_hs),
        static_cast<T*>(h0s), static_cast<T*>(h1s), static_cast<T*>(probs),
        static_cast<T*>(tscratch), static_cast<float*>(fscratch), static_cast<const T*>(wt),
        static_cast<unsigned long long*>(probe), B, T_len, S, H, units, rows, grid, s);
  };
  const int err = by_dtype(dtype, run);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the forward's persistent kernel the card holds at once,
// and the dynamic shared memory of one CTA, for CTAs of `units` units and
// `rows` batch rows: the resident kernel (vmmt_decoder_fwd_occupancy) and
// the streamed one (vmmt_decoder_fwd_stream_occupancy).
extern "C" int vmmt_decoder_fwd_occupancy(int dtype, int rows, int S, int H, int units,
                                          int* max_blocks, int* smem_bytes) {
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    return co_resident(decoder_fwd_kernel<T, false>,
                       DecFwdLayout<T>(rows, S, H, units, false).total, max_blocks, smem_bytes);
  });
}

extern "C" int vmmt_decoder_fwd_stream_occupancy(int dtype, int rows, int S, int H, int units,
                                                 int* max_blocks, int* smem_bytes) {
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    return co_resident(decoder_fwd_kernel<T, true>, DecFwdLayout<T>(rows, S, H, units, true).total,
                       max_blocks, smem_bytes);
  });
}

// Backward over the sequence in two launches: the hoisted gate products and
// the persistent cooperative kernel, tiled as the forward's (wt: as the
// forward's, laid out as DecBwd::wt says). Inputs as the forward's plus its
// four streams and d_attn (B,T,H), d_probs (B,T,S) in f32; writes dx0,
// dhp0, dx1, dhp1 (B,T,3H), pre (B,T,H), dscores (B,T,S), dh00, dh01
// (B,H), all f32. Scratch: gates 4*B*T*3H floats, fscratch 2*B*H floats
// (streamed: 4*B*H), tscratch B*pad32(H) + 4*B*pad32(3H) elements of the
// compute dtype. probe: null, or 2 + 8*T 64-bit stamps.
extern "C" int vmmt_decoder_bwd(int dtype, const void* emb_proj, const void* dmid,
                                const void* h00, const void* h01, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* attn_hs, const void* h0s, const void* h1s,
                                const void* probs, const void* d_attn, const void* d_probs,
                                void* dx0, void* dhp0, void* dx1, void* dhp1, void* pre,
                                void* dscores, void* dh00, void* dh01, void* gates,
                                void* fscratch, void* tscratch, const void* wt, void* probe,
                                int B, int T_len, int S, int H, int units, int rows, int grid,
                                void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  if (!valid_tiling(dtype, B, H, units, rows, grid, wt != nullptr))
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
        static_cast<T*>(tscratch), static_cast<const T*>(wt),
        static_cast<unsigned long long*>(probe), B, T_len, S, H, units, rows, grid, s);
  };
  const int err = by_dtype(dtype, run);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the backward's persistent kernel the card holds at once,
// and the dynamic shared memory of one CTA, for CTAs of `units` units and
// `rows` batch rows: resident and streamed.
extern "C" int vmmt_decoder_bwd_occupancy(int dtype, int rows, int S, int H, int units,
                                          int* max_blocks, int* smem_bytes) {
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    return co_resident(decoder_bwd_kernel<T, false>, DecLayout<T>(rows, S, H, units, false).total,
                       max_blocks, smem_bytes);
  });
}

extern "C" int vmmt_decoder_bwd_stream_occupancy(int dtype, int rows, int S, int H, int units,
                                                 int* max_blocks, int* smem_bytes) {
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    return co_resident(decoder_bwd_kernel<T, true>, DecLayout<T>(rows, S, H, units, true).total,
                       max_blocks, smem_bytes);
  });
}
