// One GRU layer over a whole sequence, forward only.
//
// Replaces the Pallas kernel _gru_fwd_kernel of
// variational_mmt_tpu/ops/pallas/gru.py (gru_layer_scan, pallas_call at
// :165). Same contract: x_proj (B,T,3H) precomputed input projections in
// the compute dtype T (float or bfloat16), mask (B,T) f32, h0 (B,H) f32,
// Wh (H,3H) in T, bh (3H) f32. Gates [r|z|n] with the n-gate hidden bias
// inside r*(h@Whn+bhn); state and gate math in f32; the product h@Wh takes
// h rounded to T and accumulates in f32. A masked step passes the carry
// through, so the reverse direction is right over right padding. Writes
// outs (B,T,H) f32 and final (B,H) f32 (the state after the last step
// processed).
//
// On the TPU the time axis was a sequential grid with the state in VMEM
// scratch. Here a loop over t runs inside the block: one block owns
// kRows batch rows and keeps their state in shared memory for the whole
// sequence; thread j owns hidden unit j for all kRows rows. Each step reads
// all of Wh (375 KB in bf16 at H=250, more than one SM's shared memory)
// from global memory, where it stays in L2 across steps and blocks.
// The recurrence is serial, so the kernel is bound by the latency of T
// dependent steps, far above the bytes/FLOPs bound; splitting Wh across a
// cluster's shared memory is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// round an f32 value to the precision of T (the GEMM operand dtype)
template <typename T>
__device__ __forceinline__ float round_as(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

constexpr int kRows = 4;  // batch rows per block

template <typename T>
__global__ void __launch_bounds__(1024)
gru_scan_kernel(const T* __restrict__ x_proj, const float* __restrict__ mask,
                const float* __restrict__ h0, const T* __restrict__ wh,
                const float* __restrict__ bh, float* __restrict__ outs,
                float* __restrict__ final_h, int B, int T_len, int H, int reverse) {
  extern __shared__ float smem[];
  float* h = smem;              // (kRows, H) carry, f32
  float* hc = smem + kRows * H;  // (kRows, H) carry rounded to T
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;  // hidden unit
  const int H3 = 3 * H;

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H, row = row0 + r;
    const float v = row < B ? h0[(size_t)row * H + i % H] : 0.f;
    h[i] = v;
    hc[i] = round_as<T>(v);
  }
  __syncthreads();

  const bool unit = j < H;
  const float bhr = unit ? bh[j] : 0.f;
  const float bhz = unit ? bh[H + j] : 0.f;
  const float bhn = unit ? bh[2 * H + j] : 0.f;

  for (int step = 0; step < T_len; ++step) {
    const int t = reverse ? T_len - 1 - step : step;
    float acc[kRows][3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
    if (unit) {
      const T* w = wh + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wr = to_f(w[(size_t)k * H3]);
        const float wz = to_f(w[(size_t)k * H3 + H]);
        const float wn = to_f(w[(size_t)k * H3 + 2 * H]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = hc[r * H + k];
          acc[r][0] = fmaf(hv, wr, acc[r][0]);
          acc[r][1] = fmaf(hv, wz, acc[r][1]);
          acc[r][2] = fmaf(hv, wn, acc[r][2]);
        }
      }
    }
    float h_new[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      h_new[r] = 0.f;
      if (!unit || row >= B) continue;
      const T* xp = x_proj + ((size_t)row * T_len + t) * H3;
      const float h_prev = h[r * H + j];
      const float rg = sigmoid_f(to_f(xp[j]) + (acc[r][0] + bhr));
      const float zg = sigmoid_f(to_f(xp[H + j]) + (acc[r][1] + bhz));
      const float ng = tanhf(to_f(xp[2 * H + j]) + rg * (acc[r][2] + bhn));
      const float cand = (1.f - zg) * ng + zg * h_prev;
      h_new[r] = mask[(size_t)row * T_len + t] > 0.f ? cand : h_prev;
      outs[((size_t)row * T_len + t) * H + j] = h_new[r];
    }
    __syncthreads();  // every thread has finished reading hc for this step
    if (unit) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < B) {
          h[r * H + j] = h_new[r];
          hc[r * H + j] = round_as<T>(h_new[r]);
        }
      }
    }
    __syncthreads();
  }
  if (unit) {
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < B) final_h[(size_t)row * H + j] = h[r * H + j];
    }
  }
}

template <typename T>
void launch(const void* x_proj, const void* mask, const void* h0, const void* wh,
            const void* bh, void* outs, void* final_h, int B, int T_len, int H,
            int reverse, cudaStream_t stream) {
  const int threads = ((H + 31) / 32) * 32;
  const int smem = 2 * kRows * H * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const int blocks = (B + kRows - 1) / kRows;
  gru_scan_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const float*>(mask),
      static_cast<const float*>(h0), static_cast<const T*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(outs),
      static_cast<float*>(final_h), B, T_len, H, reverse);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x_proj and Wh). Requires 1 <= H <= 1024.
extern "C" int vmmt_gru_scan(int dtype, const void* x_proj, const void* mask,
                             const void* h0, const void* wh, const void* bh,
                             void* outs, void* final_h, int B, int T_len, int H,
                             int reverse, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(x_proj, mask, h0, wh, bh, outs, final_h, B, T_len, H, reverse, s);
  } else {
    launch<float>(x_proj, mask, h0, wh, bh, outs, final_h, B, T_len, H, reverse, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vmmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
