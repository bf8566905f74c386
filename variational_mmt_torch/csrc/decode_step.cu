// One beam-decode step of the 2-layer input-feed GRU decoder with general
// attention, over N = batch x beam rows.
//
// Replaces two Pallas kernels of variational_mmt_tpu/ops/pallas/decode_step.py:
//   _step_kernel  (decode_step_pallas, pallas_call at :176)
//   _chain_kernel (gru_chain_pallas,   pallas_call at :118)
// and computes, with every tensor in one compute dtype T (float or
// bfloat16), biases and mask_bias in f32, state and gate math in f32:
//   x0 = emb_proj + feed @ Wfeed;         h0' = GRU(x0, h0 @ Wh0 + bh0, h0)
//   x1 = h0' @ Wmid + bmid;               h1' = GRU(x1, h1 @ Wh1 + bh1, h1)
//   probs = softmax(h1' . keys + mask_bias)        (decode step only)
//   attn  = tanh(sum_s probs . mem_v + h1' @ Wc_q)  (decode step only)
//
// On the TPU one launch held the five weight blocks in VMEM and ran the
// whole chain per row chunk. On the H100 the chain has dependencies across
// all N rows (GRU1 needs every column of h0', attention all of h1'), which a
// block-parallel grid cannot meet without a grid-wide sync. So one call runs
// kernels in order on the stream:
//   (a) gru_cell_kernel: GRU0 for a tile of 32 rows x 32 hidden units, both
//       products tiled through shared memory, writes h0';
//   (b) gru_cell_kernel: GRU1 the same way from h0', writes h1';
//   (c) gemm_kernel: h1' @ Wc_q into an f32 scratch (N,H);
//   (d) attn_kernel: one block per row: scores, masked softmax, context,
//       tanh; writes probs and attn.
// The chain variant runs (a) and (b) only.
//
// What bounds it on the H100: at N=1024, S=24, H=500 in bf16 the step
// moves about 56 MB (keys and mem_v are 49 MB of it) and does 6.9 GFLOP.
// The bytes bound is about 17 us; the products run here on the CUDA cores
// in f32 (67 TFLOP/s peak, about 0.1 ms), not on the tensor cores, so this
// simple design is bound by FMA throughput. wgmma for (a)-(c) is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<T>(v)); }

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

constexpr int kTU = 32;           // hidden units (output columns) per block
constexpr int kTY = 8;            // row groups per block
constexpr int kRPT = 4;           // rows per thread
constexpr int kTR = kTY * kRPT;   // rows per block
constexpr int kKC = 32;           // reduction chunk
constexpr int kThreads = kTU * kTY;

// out = GRU(x, h @ wh + bh, h) with x = [xbase +] a @ wa [+ xbias], for a
// (kTR rows x kTU units) tile. a, h, out (N,H); wa, wh (H,3H); xbase (N,3H)
// or null; xbias, bh (3H) f32, xbias may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_cell_kernel(const T* __restrict__ xbase, const float* __restrict__ xbias,
                const T* __restrict__ a, const T* __restrict__ wa,
                const T* __restrict__ h, const T* __restrict__ wh,
                const float* __restrict__ bh, T* __restrict__ out, int N, int H) {
  __shared__ float a_s[kTR][kKC];
  __shared__ float h_s[kTR][kKC];
  __shared__ float wa_s[kKC][3 * kTU];
  __shared__ float wh_s[kKC][3 * kTU];
  const int ux = threadIdx.x, ty = threadIdx.y, tid = ty * kTU + ux;
  const int u0 = blockIdx.x * kTU, row0 = blockIdx.y * kTR;
  const int H3 = 3 * H;

  float ax[kRPT][3], ah[kRPT][3];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g) ax[i][g] = ah[i][g] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kKC) {
    for (int i = tid; i < kTR * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC, row = row0 + r, k = k0 + kk;
      const bool ok = row < N && k < H;
      a_s[r][kk] = ok ? to_f(a[(size_t)row * H + k]) : 0.f;
      h_s[r][kk] = ok ? to_f(h[(size_t)row * H + k]) : 0.f;
    }
    for (int i = tid; i < kKC * 3 * kTU; i += kThreads) {
      const int kk = i / (3 * kTU), c = i % (3 * kTU);
      const int g = c / kTU, u = u0 + c % kTU, k = k0 + kk;
      const bool ok = k < H && u < H;
      const size_t off = (size_t)k * H3 + (size_t)g * H + u;
      wa_s[kk][c] = ok ? to_f(wa[off]) : 0.f;
      wh_s[kk][c] = ok ? to_f(wh[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float wv[3], vv[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        wv[g] = wa_s[kk][g * kTU + ux];
        vv[g] = wh_s[kk][g * kTU + ux];
      }
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float av = a_s[ty * kRPT + i][kk];
        const float hv = h_s[ty * kRPT + i][kk];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          ax[i][g] = fmaf(av, wv[g], ax[i][g]);
          ah[i][g] = fmaf(hv, vv[g], ah[i][g]);
        }
      }
    }
    __syncthreads();
  }

  const int j = u0 + ux;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = row0 + ty * kRPT + i;
    if (row >= N) continue;
    float x[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      x[g] = ax[i][g];
      if (xbase != nullptr) x[g] = to_f(xbase[(size_t)row * H3 + (size_t)g * H + j]) + x[g];
      if (xbias != nullptr) x[g] = x[g] + xbias[g * H + j];
    }
    const float hr = ah[i][0] + bh[j];
    const float hz = ah[i][1] + bh[H + j];
    const float hn = ah[i][2] + bh[2 * H + j];
    const float r = sigmoid_f(x[0] + hr);
    const float z = sigmoid_f(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    const float h_prev = to_f(h[(size_t)row * H + j]);
    out[(size_t)row * H + j] = from_f<T>((1.f - z) * n + z * h_prev);
  }
}

// c (N,M) f32 = a (N,K) @ w (K,M), tiled like gru_cell_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ w, float* __restrict__ c,
            int N, int K, int M) {
  __shared__ float a_s[kTR][kKC];
  __shared__ float w_s[kKC][kTU];
  const int ux = threadIdx.x, ty = threadIdx.y, tid = ty * kTU + ux;
  const int u0 = blockIdx.x * kTU, row0 = blockIdx.y * kTR;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int i = tid; i < kTR * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC, row = row0 + r, k = k0 + kk;
      a_s[r][kk] = (row < N && k < K) ? to_f(a[(size_t)row * K + k]) : 0.f;
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
      for (int i = 0; i < kRPT; ++i) acc[i] = fmaf(a_s[ty * kRPT + i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  const int u = u0 + ux;
  if (u >= M) return;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = row0 + ty * kRPT + i;
    if (row < N) c[(size_t)row * M + u] = acc[i];
  }
}

constexpr int kAttnThreads = 256;

// One block per row n: scores over S source positions, masked softmax,
// context over mem_v, attn = tanh(ctx + qw). As in the Pallas body, each
// elementwise product of the two contractions is taken in T (rounded)
// and summed in f32. Dynamic shared memory: (H + S) floats.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attn_kernel(const T* __restrict__ h1, const T* __restrict__ keys,
            const T* __restrict__ mem_v, const float* __restrict__ qw,
            const float* __restrict__ mask_bias, T* __restrict__ attn,
            T* __restrict__ probs, int S, int H) {
  extern __shared__ float sm[];
  float* q = sm;      // (H) the query h1', in T precision
  float* p = sm + H;  // (S) scores, then probs rounded to T
  const int n = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  for (int k = tid; k < H; k += blockDim.x) q[k] = to_f(h1[(size_t)n * H + k]);
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
      probs[(size_t)n * S + s] = from_f<T>(pr);
      p[s] = round_as<T>(pr);
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += blockDim.x) {
    float c = 0.f;
    for (int s = 0; s < S; ++s) c += round_as<T>(p[s] * to_f(mem_v[((size_t)n * S + s) * H + j]));
    attn[(size_t)n * H + j] = from_f<T>(tanhf(c + qw[(size_t)n * H + j]));
  }
}

template <typename T>
void launch_chain(const void* emb_proj, const void* h0, const void* h1, const void* feed,
                  const void* wfeed, const void* wh0, const void* bh0, const void* wmid,
                  const void* bmid, const void* wh1, const void* bh1, void* h0n, void* h1n,
                  int N, int H, cudaStream_t stream) {
  const dim3 block(kTU, kTY);
  const dim3 grid((H + kTU - 1) / kTU, (N + kTR - 1) / kTR);
  gru_cell_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(emb_proj), nullptr, static_cast<const T*>(feed),
      static_cast<const T*>(wfeed), static_cast<const T*>(h0), static_cast<const T*>(wh0),
      static_cast<const float*>(bh0), static_cast<T*>(h0n), N, H);
  gru_cell_kernel<T><<<grid, block, 0, stream>>>(
      nullptr, static_cast<const float*>(bmid), static_cast<const T*>(h0n),
      static_cast<const T*>(wmid), static_cast<const T*>(h1), static_cast<const T*>(wh1),
      static_cast<const float*>(bh1), static_cast<T*>(h1n), N, H);
}

template <typename T>
void launch_attn(const void* h1n, const void* keys, const void* mem_v, const void* wcq,
                 const void* mask_bias, void* attn, void* probs, void* qw, int N, int S,
                 int H, cudaStream_t stream) {
  const dim3 block(kTU, kTY);
  const dim3 grid((H + kTU - 1) / kTU, (N + kTR - 1) / kTR);
  gemm_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(h1n),
                                              static_cast<const T*>(wcq),
                                              static_cast<float*>(qw), N, H, H);
  const int smem = (H + S) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  attn_kernel<T><<<N, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(h1n), static_cast<const T*>(keys), static_cast<const T*>(mem_v),
      static_cast<const float*>(qw), static_cast<const float*>(mask_bias),
      static_cast<T*>(attn), static_cast<T*>(probs), S, H);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for every tensor but the biases (f32).
extern "C" int vmmt_gru_chain(int dtype, const void* emb_proj, const void* h0,
                              const void* h1, const void* feed, const void* wfeed,
                              const void* wh0, const void* bh0, const void* wmid,
                              const void* bmid, const void* wh1, const void* bh1,
                              void* h0n, void* h1n, int N, int H, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_chain<__nv_bfloat16>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1,
                                bh1, h0n, h1n, N, H, s);
  } else {
    launch_chain<float>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1, bh1, h0n,
                        h1n, N, H, s);
  }
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
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_chain<__nv_bfloat16>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1,
                                bh1, h0n, h1n, N, H, s);
    launch_attn<__nv_bfloat16>(h1n, keys, mem_v, wcq, mask_bias, attn, probs, qw, N, S, H, s);
  } else {
    launch_chain<float>(emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1, bh1, h0n,
                        h1n, N, H, s);
    launch_attn<float>(h1n, keys, mem_v, wcq, mask_bias, attn, probs, qw, N, S, H, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vmmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
