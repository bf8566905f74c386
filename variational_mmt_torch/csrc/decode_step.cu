// One beam-decode step of the 2-layer input-feed GRU decoder with general
// attention, over N = batch x beam rows.
//
// Replaces two Pallas kernels of variational_mmt_tpu/ops/pallas/decode_step.py:
//   _step_kernel  (decode_step_pallas, pallas_call at :176)
//   _chain_kernel (gru_chain_pallas,   pallas_call at :118)
// and computes, with every tensor in one compute dtype T (float, bfloat16
// or float16), biases and mask_bias in f32, state and gate math in f32:
//   x0 = emb_proj + feed @ Wfeed;         h0' = GRU(x0, h0 @ Wh0 + bh0, h0)
//   x1 = h0' @ Wmid + bmid;               h1' = GRU(x1, h1 @ Wh1 + bh1, h1)
//   probs = softmax(h1' . keys + mask_bias)        (decode step only)
//   attn  = tanh(sum_s probs . mem_v + h1' @ Wc_q)  (decode step only)
// Every product takes its operands in T and accumulates in f32; each
// elementwise product of the attention contractions is rounded to T before
// its f32 sum, as the Pallas body does.
//
// On the TPU one launch held the five weight blocks in VMEM and ran the
// whole chain per row chunk. On the H100 the chain has dependencies across
// all N rows (GRU1 needs every column of h0', attention all of h1'), which a
// block-parallel grid cannot meet without a grid-wide sync, so one call runs
// four kernels in order on the stream:
//   (a) cell_mma_kernel for GRU0 and (b) the same kernel for GRU1: a CTA
//       owns a tile of 64 rows x 32 hidden units and forms both of the
//       cell's products for the three gate column blocks of its units
//       (feed @ Wfeed and h0 @ Wh0; h0' @ Wmid and h1 @ Wh1), operands
//       staged by cp.async into shared memory, double-buffered along K. In
//       bf16 eight warps run mma.sync m16n8k16 (16 rows x 16 units x 3 gates
//       a warp, six f32 fragment sets per product, operands by ldmatrix); in
//       f32 each thread does FMAs for 4 rows x 2 units, never TF32. The
//       epilogue's inputs (the tile's columns of x and h, the biases) are
//       copied into shared memory with the first chunk; it does the gate
//       math in f32 and writes h' in T;
//   (c) h1' @ Wc_q by the same kernel with one product and one column
//       block (32 columns a CTA) into an f32 scratch (N,H);
//   (d) step_attn_kernel, one block per row: scores with keys read as
//       16-byte vectors of the row's flat (S,H) block (one warp a source
//       position), masked softmax, then the context with mem_v read 4
//       values a thread (8 bytes in bf16: rows of H=500 bf16 are not 16-byte
//       aligned), two halves of the positions summed in a fixed order, and
//       tanh.
// The chain variant (row 4) runs (a) and (b) only.
//
// What bounds it on the H100: at N=1024, S=24, H=500 in bf16 the step moves
// about 65 MB (keys and mem_v are 49 MB of it) and does 7.2 GFLOP: its bytes
// bound it at about 19 us, the chain's at 6 us. With the products on the
// tensor cores, what is left in the cells is the staging of their operands
// from L2 (every CTA reads its 64 rows of both operands and its 96 columns
// of both weights, about 80 MB a cell, with 8-byte copies: rows of 500 bf16
// are 8-byte but not 16-byte aligned, which also rules out TMA) overlapped
// with the mma.sync loop, each of the two taking most of a launch; in the
// attention, the one pass over keys and mem_v from device memory. The
// shapes the design cannot hold (H not a multiple of 4: the cp.async copies
// are 4 values wide) are refused by the wrapper's launch plan
// (step_cell_plan in ops/decode_step.py).
//
// float16 takes bf16's path throughout (is_mma in tile_gemm.cuh: the same
// mma.sync fragments and ldmatrix with f16 operands, the same strides and
// shared memory); what this file says of bf16 holds for both. mask_bias
// stays f32 in every dtype: its -1e9 is -inf in float16.

#include "tile_gemm.cuh"  // mma16, is_mma

namespace {

constexpr int kCellRows = 64;                // rows of a CTA's tile
constexpr int kCellUnits = 32;               // hidden units of a CTA's tile
constexpr int kCellCols = 3 * kCellUnits;    // gate-unit columns of each weight
constexpr int kCellBK = 32;                  // reduction chunk
constexpr int kCellThreads = 256;
constexpr int kCellVec = 4;                  // values per cp.async (8 B bf16, 16 B f32)

// A CTA's tile of kCellRows rows and its shared memory: two stages of K
// chunks (double buffering). Row strides (elements) of the staged operands:
// bf16 rows of 40 and 104 halves keep ldmatrix free of bank conflicts; f32
// rows of 36 and 100 floats keep the copies 16-byte aligned.
template <typename T>
struct CellSmem {
  static constexpr int kStages = 2;
  static constexpr int LDA = is_mma<T>() ? kCellBK + 8 : kCellBK + 4;
  static constexpr int LDW = is_mma<T>() ? kCellCols + 8 : kCellCols + 4;
  // one stage: a and h (kCellRows, LDA), wa and wh (kCellBK, LDW)
  static constexpr int kStage = 2 * kCellRows * LDA + 2 * kCellBK * LDW;
  static constexpr size_t kPipe = kStages * (size_t)kStage * sizeof(T);
  // then the epilogue's inputs of the tile, staged once: xbase's three gate
  // columns (kCellRows, kCellCols) and h's (kCellRows, kCellUnits) in T; bh and
  // xbias (2, kCellCols) f32
  static constexpr size_t kBytes =
      kPipe + (size_t)kCellRows * (kCellCols + kCellUnits) * sizeof(T) +
      2 * kCellCols * sizeof(float);
};

// Copies kCellVec values of T from global src to shared dst, or zeros
// them when !valid (src is then not read).
template <typename T>
__device__ __forceinline__ void cp_async_vec(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  constexpr int kBytes = kCellVec * (int)sizeof(T);
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Runs compute(c) over the K chunks c of a tile, the copies of the next
// kStages - 1 chunks in flight while it computes; load(c) issues chunk c's
// copies into its stage (c % kStages).
template <int kStages, typename Load, typename Compute>
__device__ __forceinline__ void chunk_pipeline(int chunks, Load load, Compute compute) {
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has arrived; the stage of chunk c - 1 is free
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    compute(c);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// kGru: GRU cell over N rows, hn (N,H) = GRU(x, round(h) @ wh + bh, h)
// with x = [xbase +] round(a) @ wa [+ xbias]; a, h, hn (N,H) and xbase
// (N,3H) contiguous in T, wa and wh (H,3H) in T, xbias and bh (3H) f32.
// !kGru: the product alone, out (N,H) f32 = round(a) @ wa with wa (H,H) in
// T (h, wh, bh, xbase and xbias unused): the same tiles with one gate
// block and one product. Grid ((H + 31) / 32, (N + 63) / 64), kCellThreads
// threads, CellSmem bytes.
template <typename T, bool kGru>
__global__ void __launch_bounds__(kCellThreads)
cell_mma_kernel(const T* __restrict__ xbase, const float* __restrict__ xbias,
                const T* __restrict__ a, const T* __restrict__ wa, const T* __restrict__ h,
                const T* __restrict__ wh, const float* __restrict__ bh, T* __restrict__ hn,
                float* __restrict__ out, int N, int H) {
  using SM = CellSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kCellUnits, row0 = blockIdx.y * kCellRows;
  constexpr int kGates = kGru ? 3 : 1;
  const int ldw = kGates * H, chunks = (H + kCellBK - 1) / kCellBK;

  auto stage_at = [&](int c) { return smem + (c % SM::kStages) * SM::kStage; };
  auto load = [&](int c) {
    T* as = stage_at(c);
    T* hs = as + kCellRows * SM::LDA;
    T* was = hs + kCellRows * SM::LDA;
    T* whs = was + kCellBK * SM::LDW;
    const int k0 = c * kCellBK;
    constexpr int kRowVecs = kCellBK / kCellVec;
    for (int i = tid; i < kCellRows * kRowVecs; i += kCellThreads) {
      const int r = i / kRowVecs, kk = (i % kRowVecs) * kCellVec;
      const int row = row0 + r, k = k0 + kk;
      const bool ok = row < N && k < H;
      const size_t off = ok ? (size_t)row * H + k : 0;
      cp_async_vec(as + r * SM::LDA + kk, a + off, ok);
      if constexpr (kGru) cp_async_vec(hs + r * SM::LDA + kk, h + off, ok);
    }
    constexpr int kColVecs = kGates * kCellUnits / kCellVec;
    for (int i = tid; i < kCellBK * kColVecs; i += kCellThreads) {
      const int kk = i / kColVecs, cc = (i % kColVecs) * kCellVec;
      const int g = cc / kCellUnits, j = u0 + cc % kCellUnits, k = k0 + kk;
      const bool ok = k < H && j < H;
      const size_t off = ok ? (size_t)k * ldw + (size_t)g * H + j : 0;
      cp_async_vec(was + kk * SM::LDW + cc, wa + off, ok);
      if constexpr (kGru) cp_async_vec(whs + kk * SM::LDW + cc, wh + off, ok);
    }
  };

  // the epilogue's inputs, copied with the first chunk (cell only)
  T* xe_s = reinterpret_cast<T*>(smem_raw + SM::kPipe);
  T* he_s = xe_s + kCellRows * kCellCols;
  float* be_s = reinterpret_cast<float*>(he_s + kCellRows * kCellUnits);
  if constexpr (kGru) {
    constexpr int kXVecs = kCellCols / kCellVec, kHVecs = kCellUnits / kCellVec;
    for (int i = tid; xbase != nullptr && i < kCellRows * kXVecs; i += kCellThreads) {
      const int r = i / kXVecs, cc = (i % kXVecs) * kCellVec, row = row0 + r;
      const int j = u0 + cc % kCellUnits;
      const bool ok = row < N && j < H;
      const size_t off = ok ? (size_t)row * 3 * H + (size_t)(cc / kCellUnits) * H + j : 0;
      cp_async_vec(xe_s + r * kCellCols + cc, xbase + off, ok);
    }
    for (int i = tid; i < kCellRows * kHVecs; i += kCellThreads) {
      const int r = i / kHVecs, cc = (i % kHVecs) * kCellVec, row = row0 + r;
      const bool ok = row < N && u0 + cc < H;
      cp_async_vec(he_s + r * kCellUnits + cc, h + (ok ? (size_t)row * H + u0 + cc : 0), ok);
    }
    for (int c = tid; c < kCellCols; c += kCellThreads) {
      const int j = u0 + c % kCellUnits, col = (c / kCellUnits) * H + j;
      be_s[c] = j < H ? bh[col] : 0.f;
      be_s[kCellCols + c] = j < H && xbias != nullptr ? xbias[col] : 0.f;
    }
  }
  // h' of tile row r, unit u from its products, as the Pallas body:
  // x = [xbase +] ax [+ xbias], hp = ah + bh, gates in f32, h' in T
  auto emit = [&](int r, int u, const float (&ax3)[3], const float (&ah3)[3]) {
    const int row = row0 + r, j = u0 + u;
    if (row >= N || j >= H) return;
    float x[3], hp[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int c = g * kCellUnits + u;
      x[g] = ax3[g];
      if (xbase != nullptr) x[g] = to_f(xe_s[r * kCellCols + c]) + x[g];
      if (xbias != nullptr) x[g] = x[g] + be_s[kCellCols + c];
      hp[g] = ah3[g] + be_s[c];
    }
    const float rg = sigmoid_f(x[0] + hp[0]);
    const float zg = sigmoid_f(x[1] + hp[1]);
    const float ng = tanhf(x[2] + rg * hp[2]);
    const float h_prev = to_f(he_s[r * kCellUnits + u]);
    hn[(size_t)row * H + j] = from_f<T>((1.f - zg) * ng + zg * h_prev);
  };

  const int lane = tid & 31, warp = tid >> 5;
  if constexpr (is_mma<T>()) {
    // warp (wm, wn): rows wm*16.., units wn*16.. of every gate; fragment
    // sets [gate][n-tile of 8 units]
    const int wm = warp >> 1, wn = warp & 1;
    float ax[3][2][4] = {}, ah[3][2][4] = {};
    chunk_pipeline<SM::kStages>(chunks, load, [&](int c) {
      const T* as = stage_at(c);
      const T* hs = as + kCellRows * SM::LDA;
      const T* was = hs + kCellRows * SM::LDA;
      const T* whs = was + kCellBK * SM::LDW;
#pragma unroll
      for (int kk = 0; kk < kCellBK; kk += 16) {
        uint32_t fa[4], fh[4];
        const int ar = wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ac = kk + (lane >> 4) * 8;
        ldmatrix_x4(fa, as + ar * SM::LDA + ac);
        if constexpr (kGru) ldmatrix_x4(fh, hs + ar * SM::LDA + ac);
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          uint32_t ba[4], bw[4];
          const int bo = (kk + (lane & 15)) * SM::LDW + g * kCellUnits + wn * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(ba, was + bo);
          if constexpr (kGru) ldmatrix_x4_trans(bw, whs + bo);
          mma16<T>(ax[g][0], fa, ba[0], ba[1]);
          mma16<T>(ax[g][1], fa, ba[2], ba[3]);
          if constexpr (kGru) {
            mma16<T>(ah[g][0], fh, bw[0], bw[1]);
            mma16<T>(ah[g][1], fh, bw[2], bw[3]);
          }
        }
      }
    });
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 16 + gq + (e >> 1) * 8;
        const int u = wn * 16 + nt * 8 + 2 * tq + (e & 1);
        if constexpr (kGru) {
          const float x3[3] = {ax[0][nt][e], ax[1][nt][e], ax[2][nt][e]};
          const float h3[3] = {ah[0][nt][e], ah[1][nt][e], ah[2][nt][e]};
          emit(r, u, x3, h3);
        } else if (row0 + r < N && u0 + u < H) {
          out[(size_t)(row0 + r) * H + u0 + u] = ax[0][nt][e];
        }
      }
  } else {
    // thread: rows rg*4 .. rg*4+3, units ug*2 and ug*2+1
    const int rg = tid / 16, ug = tid % 16;
    float ax[4][2][3] = {}, ah[4][2][3] = {};
    chunk_pipeline<SM::kStages>(chunks, load, [&](int c) {
      const T* as = stage_at(c);
      const T* hs = as + kCellRows * SM::LDA;
      const T* was = hs + kCellRows * SM::LDA;
      const T* whs = was + kCellBK * SM::LDW;
#pragma unroll 4
      for (int kk = 0; kk < kCellBK; ++kk) {
        float av[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = to_f(as[(rg * 4 + i) * SM::LDA + kk]);
          hv[i] = kGru ? to_f(hs[(rg * 4 + i) * SM::LDA + kk]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          const int wo = kk * SM::LDW + g * kCellUnits + ug * 2;
          const float2 wv = *reinterpret_cast<const float2*>(was + wo);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ax[i][0][g] = fmaf(av[i], wv.x, ax[i][0][g]);
            ax[i][1][g] = fmaf(av[i], wv.y, ax[i][1][g]);
          }
          if constexpr (kGru) {
            const float2 vv = *reinterpret_cast<const float2*>(whs + wo);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i][0][g] = fmaf(hv[i], vv.x, ah[i][0][g]);
              ah[i][1][g] = fmaf(hv[i], vv.y, ah[i][1][g]);
            }
          }
        }
      }
    });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + rg * 4 + i, j = u0 + ug * 2 + e;
        if constexpr (kGru) {
          emit(rg * 4 + i, ug * 2 + e, ax[i][e], ah[i][e]);
        } else if (row < N && j < H) {
          out[(size_t)row * H + j] = ax[i][e][0];
        }
      }
  }
}

// kCellVec values of T at p as floats (p aligned to their size)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  static_assert(is_mma<T>(), "load4 of a 16-bit type");
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = unpack2<T>(q.x);
  const float2 hi = unpack2<T>(q.y);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// 16 bytes of T at element c * V of p as floats, V = 16 / sizeof(T); the
// elements at and past `total` read as zero (the tensor's end).
template <typename T, int V = 16 / (int)sizeof(T)>
__device__ __forceinline__ void load16(const T* __restrict__ p, size_t c, size_t total,
                                       float (&v)[V]) {
  if ((c + 1) * V <= total) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = c * V + i < total ? to_f(p[c * V + i]) : 0.f;
}

// Attention of the decode step, one block of kAttnThreads per row n: the
// query h1 (N,H) in T, keys and mem_v (N,S,H) in T (16-byte aligned),
// qw = h1 @ Wc_q (N,H) f32, mask_bias (N,S) f32. Writes probs (N,S) and
// attn (N,H) in T. Dynamic shared memory: (3H + S) floats.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
step_attn_kernel(const T* __restrict__ h1, const T* __restrict__ keys,
                 const T* __restrict__ mem_v, const float* __restrict__ qw,
                 const float* __restrict__ mask_bias, T* __restrict__ attn, T* __restrict__ probs,
                 int S, int H) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ float sm[];
  float* q = sm;                // (H) the query
  float* p = sm + H;            // (S) scores, then probs rounded to T
  float* ctx = sm + H + S;      // (2, H) context partial sums of the two halves
  const int n = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int k = tid; k < H; k += blockDim.x) q[k] = to_f(h1[(size_t)n * H + k]);
  __syncthreads();

  // scores: warp per position s over the 16-byte chunks that overlap its
  // row of the flat (N*S*H) keys; a chunk at a row's edge is read by both
  // rows' warps, each taking its own elements
  const size_t total = (size_t)gridDim.x * S * H;
  for (int s = warp; s < S; s += n_warps) {
    const size_t beg = ((size_t)n * S + s) * H, end = beg + H;
    float acc = 0.f;
#pragma unroll 2
    for (size_t c = beg / V + lane; c * V < end; c += 32) {
      float v[V];
      load16<T>(keys, c, total, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const size_t e = c * V + i;
        if (e >= beg && e < end) acc += round_as<T>(q[e - beg] * v[i]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) p[s] = acc + mask_bias[(size_t)n * S + s];
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, p[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(p[s] - mx);
      p[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      const float pr = p[s] / sum;
      probs[(size_t)n * S + s] = from_f<T>(pr);
      p[s] = round_as<T>(pr);
    }
  }
  __syncthreads();

  // context: a thread owns 4 units for half of the positions
  const int half = tid / (kAttnThreads / 2), quad0 = tid % (kAttnThreads / 2);
  const int s_mid = (S + 1) / 2, s0 = half ? s_mid : 0, s1 = half ? S : s_mid;
  for (int j = quad0 * kCellVec; j < H; j += (kAttnThreads / 2) * kCellVec) {
    float c4[kCellVec] = {};
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      float v[kCellVec];
      load4(mem_v + ((size_t)n * S + s) * H + j, v);
#pragma unroll
      for (int i = 0; i < kCellVec; ++i) c4[i] += round_as<T>(p[s] * v[i]);
    }
#pragma unroll
    for (int i = 0; i < kCellVec; ++i) ctx[half * H + j + i] = c4[i];
  }
  __syncthreads();
  for (int j = tid; j < H; j += blockDim.x) {
    const float v = tanhf((ctx[j] + ctx[H + j]) + qw[(size_t)n * H + j]);
    attn[(size_t)n * H + j] = from_f<T>(v);
  }
}

template <typename T>
void launch_chain(const void* emb_proj, const void* h0, const void* h1, const void* feed,
                  const void* wfeed, const void* wh0, const void* bh0, const void* wmid,
                  const void* bmid, const void* wh1, const void* bh1, void* h0n, void* h1n,
                  int N, int H, cudaStream_t stream) {
  const dim3 grid((H + kCellUnits - 1) / kCellUnits,
                  (N + kCellRows - 1) / kCellRows);
  const int smem = (int)CellSmem<T>::kBytes;
  allow_smem(cell_mma_kernel<T, true>, smem);
  cell_mma_kernel<T, true><<<grid, kCellThreads, smem, stream>>>(
      static_cast<const T*>(emb_proj), nullptr, static_cast<const T*>(feed),
      static_cast<const T*>(wfeed), static_cast<const T*>(h0), static_cast<const T*>(wh0),
      static_cast<const float*>(bh0), static_cast<T*>(h0n), nullptr, N, H);
  cell_mma_kernel<T, true><<<grid, kCellThreads, smem, stream>>>(
      nullptr, static_cast<const float*>(bmid), static_cast<const T*>(h0n),
      static_cast<const T*>(wmid), static_cast<const T*>(h1), static_cast<const T*>(wh1),
      static_cast<const float*>(bh1), static_cast<T*>(h1n), nullptr, N, H);
}

template <typename T>
void launch_attn(const void* h1n, const void* keys, const void* mem_v, const void* wcq,
                 const void* mask_bias, void* attn, void* probs, void* qw, int N, int S,
                 int H, cudaStream_t stream) {
  const dim3 grid((H + kCellUnits - 1) / kCellUnits,
                  (N + kCellRows - 1) / kCellRows);
  const int cell_smem = (int)CellSmem<T>::kBytes;
  allow_smem(cell_mma_kernel<T, false>, cell_smem);
  cell_mma_kernel<T, false><<<grid, kCellThreads, cell_smem, stream>>>(
      nullptr, nullptr, static_cast<const T*>(h1n), static_cast<const T*>(wcq), nullptr, nullptr,
      nullptr, nullptr, static_cast<float*>(qw), N, H);
  const int smem = (3 * H + S) * (int)sizeof(float);
  allow_smem(step_attn_kernel<T>, smem);
  step_attn_kernel<T><<<N, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(h1n), static_cast<const T*>(keys), static_cast<const T*>(mem_v),
      static_cast<const float*>(qw), static_cast<const float*>(mask_bias), static_cast<T*>(attn),
      static_cast<T*>(probs), S, H);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 for every tensor but the
// biases and mask_bias (f32); any other code is cudaErrorInvalidValue, in
// every entry. Requires H % 4 == 0 and every tensor 16-byte aligned.
extern "C" int vmmt_gru_chain(int dtype, const void* emb_proj, const void* h0,
                              const void* h1, const void* feed, const void* wfeed,
                              const void* wh0, const void* bh0, const void* wmid,
                              const void* bmid, const void* wh1, const void* bh1,
                              void* h0n, void* h1n, int N, int H, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (H < 1 || H % kCellVec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_dtype(dtype, [&](auto zero) {
    launch_chain<decltype(zero)>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1, bh1,
                                 h0n, h1n, N, H, s);
    return 0;
  });
  return (int)cudaGetLastError();
}

// qw: f32 scratch (N,H) for h1' @ Wc_q.
extern "C" int vmmt_decode_step(int dtype, const void* emb_proj, const void* h0,
                                const void* h1, const void* feed, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* mask_bias, void* h0n, void* h1n, void* attn,
                                void* probs, void* qw, int N, int S, int H, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (H < 1 || H % kCellVec != 0 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    launch_chain<T>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1, bh1, h0n, h1n, N,
                    H, s);
    launch_attn<T>(h1n, keys, mem_v, wcq, mask_bias, attn, probs, qw, N, S, H, s);
    return 0;
  });
  return (int)cudaGetLastError();
}

// How many CTAs of the GRU cell kernel one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the dynamic shared
// memory of one CTA.
extern "C" int vmmt_step_cell_occupancy(int dtype, int* ctas_per_sm, int* smem_bytes) {
  auto query = [&](auto zero) {
    using T = decltype(zero);
    const int smem = (int)CellSmem<T>::kBytes;
    allow_smem(cell_mma_kernel<T, true>, smem);
    *smem_bytes = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, cell_mma_kernel<T, true>,
                                                         kCellThreads, smem);
  };
  return by_dtype(dtype, query);
}
