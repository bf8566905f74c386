// A tiled product for the training backward kernels: the gate products
// that gru_scan.cu and decoder.cu hoist out of their serial loops, and
// gru_scan.cu's weight gradient dWh.
//
// out(m, n) = sum_k A(m, k) B(k, n), f32 accumulation. An operation Op
// says where A and B come from and where each result goes, so one kernel
// serves row gathers (the previous state of each (row, t)), transposed
// operands (dWh = h_prev^T dh_proj) and epilogues with a bias or an added
// stream. Op provides:
//   int M, N, K;
//   static constexpr bool kAFastK, kBFastK: the operand is contiguous
//       along k in memory (else along m or n);
//   void load_a(int m, int k, float (&v)[16]), load_b(int k, int n, ...):
//       16 consecutive operand values along the operand's contiguous axis
//       from (m, k) or (k, n), zero outside the operand;
//   void out(int m, int n, float v): the result;
//   int extra_blocks(), void extra(int blk): blocks launched after the
//       tiles for a side reduction (gru_scan.cu's dbh), or none.
// Operands are stored in shared memory in the compute dtype T, which rounds
// them to T as the Pallas bodies round every product operand.
//
// A block of 128 threads computes a 64 x 64 tile in chunks of 32 along K,
// loading the next chunk into registers (16 contiguous values of each
// operand a thread) while it computes the current one. bfloat16 and
// float16 run on the tensor cores (mma.sync m16n8k16, 16-bit inputs, f32
// accumulators; 4 warps of 32 x 32); float32 runs FMAs on the CUDA cores
// (8 x 4 outputs a thread), never TF32. A product with few tiles and a long K (dWh) splits K
// over `splits` blocks a tile: each writes its partial tile, and the last
// to finish (an atomic count a tile) adds the partials in split order, so
// the result does not depend on which block finishes last.
//
// blockIdx.z selects one of NOps operations of the same type, so several
// independent products share one launch.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kGemmBM = 64;  // rows of a tile
constexpr int kGemmBN = 64;  // columns of a tile
constexpr int kGemmBK = 32;  // reduction chunk
constexpr int kGemmThreads = 128;

// Whether T is a 16-bit tensor-core type (bfloat16 or float16): its
// products run mma.sync m16n8k16 on 2-byte operands with one fragment
// layout; float32 runs FMAs. kernels.mma_dtype mirrors it for the launch
// plans.
template <typename T>
__host__ __device__ constexpr bool is_mma() {
  return std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;
}

// Shared-memory operand type and row stride: 16-bit rows of 40 halves (20
// words) keep the mma fragment reads free of bank conflicts; f32 rows of 33.
template <typename T>
struct GemmSmem {
  using S = T;
  static constexpr int LD = is_mma<T>() ? kGemmBK + 8 : kGemmBK + 1;
};

// c += a b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8,
// both of T (bfloat16 or float16); c 16x8 f32.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  static_assert(is_mma<T>(), "mma16 takes bfloat16 or float16");
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two consecutive 16-bit values as one 32-bit register (the lower address
// in the low half, as mma.sync reads a pair)
template <typename S>
__device__ __forceinline__ uint32_t pair_at(const S* p) {
  static_assert(sizeof(S) == 2, "pair_at reads 16-bit values");
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values rounded to a 16-bit T (to nearest even) as one 32-bit
// register, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  } else {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
}

// A 32-bit register of two 16-bit T values as two f32 values.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ int pad16(int k) { return (k + 15) & ~15; }

// Row stride of an mma operand held whole in shared memory: 16-bit rows of K
// (padded to 16) whose length in 32-bit words is 4 more than a multiple of
// 32, so that the eight rows a fragment reads fall in distinct banks.
template <typename T>
__host__ __device__ int slice_ld(int K) {
  const int k = pad16(K);
  return is_mma<T>() ? k + (72 - k % 64) % 64 : k;
}

template <typename Op, int NOps>
struct OpArray {
  Op v[NOps];
};

// Stores 16 values as T at dst[0..15] (contiguous) or dst[0], dst[ld], ...
template <typename S>
__device__ __forceinline__ void stash16(S* dst, int ld, bool contiguous, const float (&v)[16]) {
  if constexpr (is_mma<S>()) {
    if (contiguous) {
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = pack2<S>(v[2 * i], v[2 * i + 1]);
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[contiguous ? i : i * ld] = from_f<S>(v[i]);
}

// Loads n (at most 16) contiguous values from p, zero after them; a full
// segment at an aligned address in 16-byte (f32) or 4-byte (16-bit) words.
__device__ __forceinline__ void seg_load(const float* __restrict__ p, int n, float (&v)[16]) {
  if (n == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < n ? p[i] : 0.f;
}

template <typename S>
__device__ __forceinline__ void seg_load(const S* __restrict__ p, int n, float (&v)[16]) {
  static_assert(is_mma<S>(), "seg_load of a 16-bit type");
  if (n == 16 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 q = unpack2<S>(reinterpret_cast<const uint32_t*>(p)[i]);
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < n ? to_f(p[i]) : 0.f;
}

template <typename T, typename Op, int NOps>
__global__ void __launch_bounds__(kGemmThreads)
tile_gemm_kernel(OpArray<Op, NOps> ops, int splits, float* partial, int* counters) {
  using S = typename GemmSmem<T>::S;
  constexpr int LD = GemmSmem<T>::LD;
  __shared__ __align__(16) S a_s[kGemmBM][LD];  // (m, k)
  __shared__ __align__(16) S b_s[kGemmBN][LD];  // (n, k)
  __shared__ int last;
  const Op& op = ops.v[blockIdx.z];
  const int n_tiles = (op.N + kGemmBN - 1) / kGemmBN;
  const int tiles = n_tiles * ((op.M + kGemmBM - 1) / kGemmBM);
  if ((int)blockIdx.x >= tiles * splits) {
    op.extra(blockIdx.x - tiles * splits);
    return;
  }
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int m0 = (tile / n_tiles) * kGemmBM, n0 = (tile % n_tiles) * kGemmBN;
  const int chunks = (op.K + kGemmBK - 1) / kGemmBK;
  const int c0 = split * chunks / splits, c1 = (split + 1) * chunks / splits;
  const int tid = threadIdx.x;
  // this thread's 16-value segments of the A and B chunks
  const int am = Op::kAFastK ? tid >> 1 : (tid & 3) * 16;
  const int ak = Op::kAFastK ? (tid & 1) * 16 : tid >> 2;
  const int bn = Op::kBFastK ? tid >> 1 : (tid & 3) * 16;
  const int bk = Op::kBFastK ? (tid & 1) * 16 : tid >> 2;
  float ra[16], rb[16];
  auto fetch = [&](int c) {
    op.load_a(m0 + am, c * kGemmBK + ak, ra);
    op.load_b(c * kGemmBK + bk, n0 + bn, rb);
  };
  auto stash = [&]() {
    stash16<S>(&a_s[am][ak], LD, Op::kAFastK, ra);
    stash16<S>(&b_s[bn][bk], LD, Op::kBFastK, rb);
  };
  // acc[e]: the thread's 32 outputs; at(e, m, n) gives their positions
  float acc[32] = {};
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row group, pair index
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  auto at = [&](int e, int& m, int& n) {
    if constexpr (is_mma<T>()) {
      // e = (mi * 4 + ni) * 4 + c, c the mma accumulator index
      m = m0 + wm + (e >> 4) * 16 + gq + ((e >> 1) & 1) * 8;
      n = n0 + wn + ((e >> 2) & 3) * 8 + 2 * tq + (e & 1);
    } else {
      m = m0 + (tid / 16) * 8 + (e >> 2);
      n = n0 + (tid % 16) * 4 + (e & 3);
    }
  };

  if (c0 < c1) fetch(c0);
  for (int c = c0; c < c1; ++c) {
    stash();
    __syncthreads();
    if (c + 1 < c1) fetch(c + 1);
    if constexpr (is_mma<T>()) {
#pragma unroll
      for (int kk = 0; kk < kGemmBK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + gq;
          a[mi][0] = pair_at(&a_s[r][kk + 2 * tq]);
          a[mi][1] = pair_at(&a_s[r + 8][kk + 2 * tq]);
          a[mi][2] = pair_at(&a_s[r][kk + 2 * tq + 8]);
          a[mi][3] = pair_at(&a_s[r + 8][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn + ni * 8 + gq;
          const uint32_t b0 = pair_at(&b_s[n][kk + 2 * tq]);
          const uint32_t b1 = pair_at(&b_s[n][kk + 2 * tq + 8]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            float* c4 = &acc[(mi * 4 + ni) * 4];
            float cc[4] = {c4[0], c4[1], c4[2], c4[3]};
            mma16<T>(cc, a[mi], b0, b1);
            c4[0] = cc[0];
            c4[1] = cc[1];
            c4[2] = cc[2];
            c4[3] = cc[3];
          }
        }
      }
    } else {
      const int tx = tid % 16, ty = tid / 16;  // columns tx*4.., rows ty*8..
#pragma unroll 4
      for (int k = 0; k < kGemmBK; ++k) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = a_s[ty * 8 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[tx * 4 + j][k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
      }
    }
    __syncthreads();
  }

  if (splits > 1) {
    const size_t slot = (size_t)blockIdx.z * tiles + tile;
    float* mine = partial + (slot * splits + split) * (kGemmBM * kGemmBN);
#pragma unroll
    for (int e = 0; e < 32; ++e) mine[e * kGemmThreads + tid] = acc[e];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&counters[slot], 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* all = partial + slot * splits * (kGemmBM * kGemmBN);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float v = 0.f;
      for (int s = 0; s < splits; ++s)
        v += __ldcg(all + (size_t)s * kGemmBM * kGemmBN + e * kGemmThreads + tid);
      acc[e] = v;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int m, n;
    at(e, m, n);
    if (m < op.M && n < op.N) op.out(m, n, acc[e]);
  }
}

// Launches the NOps products of ops (all with the same M and N) with the
// extra blocks of the first. With splits > 1: partial holds splits * 64 *
// 64 floats a tile, and counters one int a tile, zero before the launch.
template <typename T, typename Op, int NOps>
void tile_gemm(const OpArray<Op, NOps>& ops, cudaStream_t stream, int splits = 1,
               float* partial = nullptr, int* counters = nullptr) {
  const Op& op = ops.v[0];
  const int tiles = ((op.M + kGemmBM - 1) / kGemmBM) * ((op.N + kGemmBN - 1) / kGemmBN);
  tile_gemm_kernel<T, Op, NOps><<<dim3(tiles * splits + op.extra_blocks(), 1, NOps),
                                  kGemmThreads, 0, stream>>>(ops, splits, partial, counters);
}

// The previous state of each (row, t) in forward processing order, as a
// product operand: the f32 initial state at the first step processed
// (init, rows H apart; a zero state when init is null), else the stream's
// value at the previous step (TS, rows T*H apart). prev_state gives unit k,
// prev_seg units k .. k+n-1 (n <= 16) and zeros after them.
template <typename TS>
__device__ __forceinline__ float prev_state(const float* __restrict__ init,
                                            const TS* __restrict__ stream, int row, int t,
                                            int T_len, int H, int k, bool reverse) {
  const bool first = reverse ? t == T_len - 1 : t == 0;
  if (first) return init != nullptr ? init[(size_t)row * H + k] : 0.f;
  const int tp = reverse ? t + 1 : t - 1;
  return to_f(stream[((size_t)row * T_len + tp) * H + k]);
}

template <typename TS>
__device__ __forceinline__ void prev_seg(const float* __restrict__ init,
                                         const TS* __restrict__ stream, int row, int t,
                                         int T_len, int H, int k, int n, bool reverse,
                                         float (&v)[16]) {
  const bool first = reverse ? t == T_len - 1 : t == 0;
  if (first) {
    if (init != nullptr) {
      seg_load(init + (size_t)row * H + k, n, v);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = 0.f;
    }
    return;
  }
  const int tp = reverse ? t + 1 : t - 1;
  seg_load(stream + ((size_t)row * T_len + tp) * H + k, n, v);
}

}  // namespace
