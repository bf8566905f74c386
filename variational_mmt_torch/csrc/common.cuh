// Device helpers and kernels shared by the port's CUDA sources.
//
// gru_scan.cu and decode_step.cu use the conversions and the warp
// reductions (the decode step's cells and attention are its own
// tensor-core and vector-load kernels). decoder.cu's forward (the
// teacher-forced sequence, one step at a time) runs its step from:
//   cell_fwd_kernel: a GRU cell over N rows, both products tiled through
//       shared memory, with the input product's operand optionally scaled
//       by a dropout mask (the decoder's dmid);
//   gemm_kernel:     h1' @ Wc_q;
//   attn_fwd_kernel: scores, masked softmax, context and tanh, one block
//       per row.
// They are templated on the compute dtype T of the weights and streams, on
// the dtype TS of the carried state (f32 for the sequence, which keeps it
// in f32 across time; a T state is read as is) and on the rows per thread.
//
// Numerics, as in the Pallas bodies: every product takes its operands
// rounded to T and accumulates in f32; each elementwise product of the
// attention contractions is rounded to T before its f32 sum. A value that
// is already a T (the decode step's state) is read as is.
//
// Each library is one translation unit that includes this header once, so
// its definitions live in an anonymous namespace like the sources' own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to the precision of T (the product operand dtype)
template <typename T>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<T>(v)); }

// v as a product operand of dtype T: rounded to T, which a value that is
// already a T skips
template <typename T, typename TV>
__device__ __forceinline__ float operand(TV v) {
  if constexpr (std::is_same<T, TV>::value) {
    return to_f(v);
  } else {
    return round_as<T>(to_f(v));
  }
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Tiles of the cells and products: a block of (kTU, kTY) threads covers
// kTU output columns and kTY * RPT rows, reducing in chunks of kKC.
constexpr int kTU = 32;  // hidden units (output columns) per block
constexpr int kTY = 8;   // row groups per block
constexpr int kKC = 32;  // reduction chunk
constexpr int kThreads = kTU * kTY;
constexpr int kAttnThreads = 256;

// The two products of a GRU cell for a (kTY*RPT rows x kTU units) tile:
//   ax = round(a [* amul]) @ wa  (skipped, left 0, when a is null)
//   ah = round(h) @ wh
// a (N,H) rows lda apart, amul (N,H) rows ldm apart or null, h rows ldh
// apart; wa, wh (H,3H). ax/ah[i][g] is row ty*RPT+i, gate g, unit u0+ux.
template <typename T, typename TA, typename TH, int RPT>
__device__ __forceinline__ void cell_products(const TA* __restrict__ a, int lda,
                                              const T* __restrict__ amul, int ldm,
                                              const T* __restrict__ wa,
                                              const TH* __restrict__ h, int ldh,
                                              const T* __restrict__ wh, int N, int H,
                                              float (&ax)[RPT][3], float (&ah)[RPT][3]) {
  constexpr int kTR = kTY * RPT;
  __shared__ float a_s[kTR][kKC];
  __shared__ float h_s[kTR][kKC];
  __shared__ float wa_s[kKC][3 * kTU];
  __shared__ float wh_s[kKC][3 * kTU];
  const int ux = threadIdx.x, ty = threadIdx.y, tid = ty * kTU + ux;
  const int u0 = blockIdx.x * kTU, row0 = blockIdx.y * kTR;
  const int H3 = 3 * H;
  const bool has_a = a != nullptr;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g) ax[i][g] = ah[i][g] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kKC) {
    for (int i = tid; i < kTR * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC, row = row0 + r, k = k0 + kk;
      const bool ok = row < N && k < H;
      float av = 0.f;
      if (ok && has_a) {
        av = amul != nullptr ? round_as<T>(to_f(amul[(size_t)row * ldm + k]) *
                                           to_f(a[(size_t)row * lda + k]))
                             : operand<T>(a[(size_t)row * lda + k]);
      }
      a_s[r][kk] = av;
      h_s[r][kk] = ok ? operand<T>(h[(size_t)row * ldh + k]) : 0.f;
    }
    for (int i = tid; i < kKC * 3 * kTU; i += kThreads) {
      const int kk = i / (3 * kTU), c = i % (3 * kTU);
      const int g = c / kTU, u = u0 + c % kTU, k = k0 + kk;
      const bool ok = k < H && u < H;
      const size_t off = (size_t)k * H3 + (size_t)g * H + u;
      if (has_a) wa_s[kk][c] = ok ? to_f(wa[off]) : 0.f;
      wh_s[kk][c] = ok ? to_f(wh[off]) : 0.f;
    }
    __syncthreads();
    if (has_a) {
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float wv[3], vv[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          wv[g] = wa_s[kk][g * kTU + ux];
          vv[g] = wh_s[kk][g * kTU + ux];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float av = a_s[ty * RPT + i][kk];
          const float hv = h_s[ty * RPT + i][kk];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            ax[i][g] = fmaf(av, wv[g], ax[i][g]);
            ah[i][g] = fmaf(hv, vv[g], ah[i][g]);
          }
        }
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float vv[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) vv[g] = wh_s[kk][g * kTU + ux];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float hv = h_s[ty * RPT + i][kk];
#pragma unroll
          for (int g = 0; g < 3; ++g) ah[i][g] = fmaf(hv, vv[g], ah[i][g]);
        }
      }
    }
    __syncthreads();
  }
}

// Gate pre-activations of one (row, unit): x = [xbase +] ax [+ xbias],
// hp = ah + bh.
template <typename T>
__device__ __forceinline__ void cell_inputs(const T* __restrict__ xbase, int ldx,
                                            const float* __restrict__ xbias,
                                            const float* __restrict__ bh, const float (&ax)[3],
                                            const float (&ah)[3], int row, int j, int H,
                                            float (&x)[3], float (&hp)[3]) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    x[g] = ax[g];
    if (xbase != nullptr) x[g] = to_f(xbase[(size_t)row * ldx + (size_t)g * H + j]) + x[g];
    if (xbias != nullptr) x[g] = x[g] + xbias[g * H + j];
    hp[g] = ah[g] + bh[g * H + j];
  }
}

// Forward GRU cell over N rows: hn (N,H) = GRU(x, h @ wh + bh, h) in the
// state dtype TS, with x = [xbase +] round(a [* amul]) @ wa [+ xbias];
// a and h (N,H) contiguous in TS, a may be null (no input product). When
// hs is not null, hn is also written rounded to T into the stream hs (rows
// lds apart). Grid ((H + kTU - 1) / kTU, (N + kTY*RPT - 1) / (kTY*RPT)),
// block (kTU, kTY).
template <typename T, typename TS, int RPT>
__global__ void __launch_bounds__(kThreads)
cell_fwd_kernel(const T* __restrict__ xbase, int ldx, const float* __restrict__ xbias,
                const TS* __restrict__ a, const T* __restrict__ amul, int ldm,
                const T* __restrict__ wa, const TS* __restrict__ h,
                const T* __restrict__ wh, const float* __restrict__ bh, TS* __restrict__ hn,
                T* __restrict__ hs, int lds, int N, int H) {
  float ax[RPT][3], ah[RPT][3];
  cell_products<T, TS, TS, RPT>(a, H, amul, ldm, wa, h, H, wh, N, H, ax, ah);
  const int j = blockIdx.x * kTU + threadIdx.x;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = blockIdx.y * kTY * RPT + threadIdx.y * RPT + i;
    if (row >= N) continue;
    float x[3], hp[3];
    cell_inputs<T>(xbase, ldx, xbias, bh, ax[i], ah[i], row, j, H, x, hp);
    const float r = sigmoid_f(x[0] + hp[0]);
    const float z = sigmoid_f(x[1] + hp[1]);
    const float n = tanhf(x[2] + r * hp[2]);
    const float h_prev = to_f(h[(size_t)row * H + j]);
    const float v = (1.f - z) * n + z * h_prev;
    hn[(size_t)row * H + j] = from_f<TS>(v);
    if (hs != nullptr) hs[(size_t)row * lds + j] = from_f<T>(v);
  }
}

// out (N,M) f32 = [mul *] (round(a) @ w) [+ add]: a (N,K) in TA rows lda
// apart, w (K,M) in T, mul (N,M) in T rows ldm apart or null, add (N,M) f32
// contiguous or null. Tiled like the cells.
template <typename T, typename TA, int RPT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a, int lda, const T* __restrict__ w,
            const T* __restrict__ mul, int ldm, const float* __restrict__ add,
            float* __restrict__ out, int N, int K, int M) {
  constexpr int kTR = kTY * RPT;
  __shared__ float a_s[kTR][kKC];
  __shared__ float w_s[kKC][kTU];
  const int ux = threadIdx.x, ty = threadIdx.y, tid = ty * kTU + ux;
  const int u0 = blockIdx.x * kTU, row0 = blockIdx.y * kTR;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int i = tid; i < kTR * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC, row = row0 + r, k = k0 + kk;
      a_s[r][kk] = (row < N && k < K) ? operand<T>(a[(size_t)row * lda + k]) : 0.f;
    }
    for (int i = tid; i < kKC * kTU; i += kThreads) {
      const int kk = i / kTU, u = u0 + i % kTU, k = k0 + kk;
      w_s[kk][i % kTU] = (k < K && u < M) ? to_f(w[(size_t)k * M + u]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      const float wv = w_s[kk][ux];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a_s[ty * RPT + i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  const int u = u0 + ux;
  if (u >= M) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + ty * RPT + i;
    if (row >= N) continue;
    float v = acc[i];
    if (mul != nullptr) v = to_f(mul[(size_t)row * ldm + u]) * v;
    if (add != nullptr) v = v + add[(size_t)row * M + u];
    out[(size_t)row * M + u] = v;
  }
}

// Attention forward, one block of kAttnThreads per row n: scores of the
// query h1 (N,H) in TS, rounded to T, against keys (N,S,H), masked softmax,
// context over mem_v (N,S,H), attn = tanh(ctx + qw). Writes probs (rows ldp
// apart) and attn (rows lda apart) in T and, when feed is not null, attn
// in f32 to feed (N,H). Dynamic shared memory: (H + S) floats.
template <typename T, typename TS>
__global__ void __launch_bounds__(kAttnThreads)
attn_fwd_kernel(const TS* __restrict__ h1, const T* __restrict__ keys,
                const T* __restrict__ mem_v, const float* __restrict__ qw,
                const float* __restrict__ mask_bias, float* __restrict__ feed,
                T* __restrict__ attn, int lda, T* __restrict__ probs, int ldp, int S, int H) {
  extern __shared__ float sm[];
  float* q = sm;      // (H) the query, rounded to T
  float* p = sm + H;  // (S) scores, then probs rounded to T
  const int n = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int k = tid; k < H; k += blockDim.x) q[k] = operand<T>(h1[(size_t)n * H + k]);
  __syncthreads();
  for (int s = warp; s < S; s += n_warps) {
    const T* kr = keys + ((size_t)n * S + s) * H;
    float acc = 0.f;
    for (int k = lane; k < H; k += 32) acc += round_as<T>(q[k] * to_f(kr[k]));
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
      probs[(size_t)n * ldp + s] = from_f<T>(pr);
      p[s] = round_as<T>(pr);
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += blockDim.x) {
    float c = 0.f;
    for (int s = 0; s < S; ++s) c += round_as<T>(p[s] * to_f(mem_v[((size_t)n * S + s) * H + j]));
    const float v = tanhf(c + qw[(size_t)n * H + j]);
    if (feed != nullptr) feed[(size_t)n * H + j] = v;
    attn[(size_t)n * lda + j] = from_f<T>(v);
  }
}

// Allows a dynamic shared-memory size above the 48 KB default.
template <typename Kernel>
void allow_smem(Kernel* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
}

}  // namespace

// The message of an error code that an entry point returned.
extern "C" const char* vmmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
