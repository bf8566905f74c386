// The product of the persistent cooperative kernels (decoder.cu, and
// gru_scan.cu's wide scans): a CTA's (rows, K) activations, read from L2,
// times the few weight columns it keeps in shared memory; the GRU cell on
// its results; the co-residency query of a cooperative launch.
//
// A persistent kernel's CTAs own a few hidden units each (8 in bf16: one
// mma.sync n-tile; 4 in f32, FMAs on the CUDA cores, never TF32) and keep
// those units' weight slices in shared memory for the whole call. The
// other CTAs' results reach them as T-rounded copies in global memory,
// rows padded to 32 (zero past K), read with ld.global.cg past the L1,
// which is not coherent across SMs, after a grid barrier.

#pragma once

#include "tile_gemm.cuh"

namespace {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecUnitsMma = 8;  // units of a CTA in bf16: one mma n-tile
constexpr int kDecUnitsFma = 4;  // most units of a CTA in f32

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

// Rows of one n-tile of a weight slice: the mma's 8 columns in bf16, the
// FMA path's units in f32.
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return is_bf16<T>() ? kDecUnitsMma : kDecUnitsFma;
}

// prod[m * 8 NT + n * 8 + u] = sum_k act[r0 + m, k] w_s[n * tile_rows + u,
// k] for m < nr, u < nu and the NT n-tiles n of a weight slice: act in T
// rows lda apart (columns K..lda zero, lda a multiple of 32), w_s in shared
// memory, rows ldw apart. bf16: mma.sync over 16-row tiles, the K range
// split across warps when there are fewer tiles than warps, partial sums
// added in a fixed order; each operand fragment serves the NT n-tiles.
// Each lane loads 16 bytes of a row per 32 columns, whole sectors: within a
// 32-column block, lane tq's columns 8tq .. 8tq+7 serve as the mma
// fragment's k = 2tq, 2tq+1, 2tq+8, 2tq+9 of two k-steps, in A and B alike,
// which permutes the sum over k and changes nothing else. f32: FMAs, a warp
// per row, lanes along K.
constexpr int kDecBatch = 12;  // 32-column blocks whose fragments a warp loads at once

template <typename T, int NT = 1>
__device__ void block_product(const T* act, int lda, int K, const T* w_s, int ldw, int nu,
                              int r0, int nr, float* prod) {
  constexpr int PS = kDecUnitsMma * NT;  // row stride of prod
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
      // uint4s from one n-tile's rows to the next's
      const size_t wtile = (size_t)kDecUnitsMma * ldw * sizeof(T) / sizeof(uint4);
      float c[NT][4] = {};
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
            const uint32_t lo[4] = {x0[i].x, x1[i].x, x0[i].y, x1[i].y};
            const uint32_t hi[4] = {x0[i].z, x1[i].z, x0[i].w, x1[i].w};
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const uint4 w = wb[n * wtile + (q + i) * 4];
              mma_bf16(c[n], lo, w.x, w.y);
              mma_bf16(c[n], hi, w.z, w.w);
            }
          }
        }
      }
      float* out = prod + (size_t)part * mt * 16 * PS;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        out[m0 * PS + n * 8 + 2 * tq] = c[n][0];
        out[m0 * PS + n * 8 + 2 * tq + 1] = c[n][1];
        out[m1 * PS + n * 8 + 2 * tq] = c[n][2];
        out[m1 * PS + n * 8 + 2 * tq + 1] = c[n][3];
      }
    }
    __syncthreads();
    if (kp > 1) {
      const int stride = mt * 16 * PS;
      for (int i = tid; i < stride; i += kDecThreads) {
        float v = prod[i];
        for (int part = 1; part < kp; ++part) v += prod[part * stride + i];
        prod[i] = v;
      }
      __syncthreads();
    }
  } else {
    for (int m = warp; m < nr; m += kDecWarps) {
      float acc[NT][kDecUnitsFma] = {};
      const float* a = reinterpret_cast<const float*>(act) + (size_t)(r0 + m) * lda;
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        const float av = __ldcg(a + k);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int u = 0; u < kDecUnitsFma; ++u)
            if (u < nu)
              acc[n][u] = fmaf(av, to_f(w_s[(n * kDecUnitsFma + u) * ldw + k]), acc[n][u]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int u = 0; u < kDecUnitsFma; ++u) {
          const float v = warp_sum(acc[n][u]);
          if (lane == 0) prod[m * PS + n * 8 + u] = v;
        }
    }
    __syncthreads();
  }
}

// The GRU cell from the gate inputs x [r|z|n] and the hidden products hp
// (bias included): h' = (1 - z) n + z h.
__device__ __forceinline__ float gru_cell(const float (&x)[3], const float* hp, float h) {
  const float r = sigmoid_f(x[0] + hp[0]);
  const float z = sigmoid_f(x[1] + hp[1]);
  const float n = tanhf(x[2] + r * hp[2]);
  return (1.f - z) * n + z * h;
}

// How many CTAs of `kernel` with `smem` bytes of dynamic shared memory the
// card holds at once.
template <typename Kernel>
cudaError_t co_resident(Kernel* kernel, size_t smem, int* max_blocks, int* smem_bytes) {
  *smem_bytes = (int)smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDecThreads, smem);
  *max_blocks = per_sm * sms;
  return err;
}

}  // namespace
