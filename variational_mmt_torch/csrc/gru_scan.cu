// One GRU layer over a whole sequence: the forward scan and its backward.
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
//
// The backward replaces _gru_bwd_kernel (_gru_scan_bwd_impl, pallas_call at
// :297) and runs in three kernels from one entry point:
//   (a) transpose_kernel: Wh (H,3H) -> Wh^T (3H,H) into a scratch buffer, so
//       that the per-step product dh_proj @ Wh^T reads it coalesced;
//   (b) gru_scan_bwd_kernel: the same block layout as the forward, looping
//       over time in reverse. Each step recomputes the gates from h_prev (the
//       previous step's output, or h0 at the first step processed), takes
//       dh from shared memory, passes it through masked steps, and emits
//       dx_proj and dh_proj (both f32) for the step; dh_prev gets
//       dh_proj @ Wh^T with dh_proj rounded to T (f32 accumulation);
//   (c) dwh_kernel: dWh = sum over (row, t) of h_prev^T dh_proj, a
//       shared-memory tiled product over K = B*T with both operands rounded
//       to T as the Pallas body rounds them, and dbh = the column sums of
//       dh_proj in f32 (bias_grad_kernel).
// The TPU kernel accumulated dWh and dbh in VMEM scratch across its grid;
// blocks here cannot share one accumulator without atomics, so (c) reduces
// the dh_proj stream that (b) writes, deterministically.

#include "common.cuh"

namespace {

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
  allow_smem(gru_scan_kernel<T>, smem);
  const int blocks = (B + kRows - 1) / kRows;
  gru_scan_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const float*>(mask),
      static_cast<const float*>(h0), static_cast<const T*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(outs),
      static_cast<float*>(final_h), B, T_len, H, reverse);
}

// Backward scan. g (B,T,H) f32 is the cotangent of outs, with the final
// state's cotangent already folded into the last step processed. Writes
// dx (B,T,3H) f32 = [dr_pre | dz_pre | dn_pre], dhp (B,T,3H) f32 =
// [dr_pre | dz_pre | dhn] and dh0 (B,H) f32.
template <typename T>
__global__ void __launch_bounds__(1024)
gru_scan_bwd_kernel(const T* __restrict__ x_proj, const float* __restrict__ mask,
                    const float* __restrict__ h0, const T* __restrict__ wh,
                    const T* __restrict__ wht, const float* __restrict__ bh,
                    const float* __restrict__ outs, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ dhp, float* __restrict__ dh0,
                    int B, int T_len, int H, int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* dh = smem;              // (kRows, H) carried dL/dh, f32
  float* hp = dh + kRows * H;    // (kRows, H) h_prev, f32
  float* hc = hp + kRows * H;    // (kRows, H) h_prev rounded to T
  float* dp = hc + kRows * H;    // (kRows, 3H) dh_proj rounded to T
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  const bool unit = j < H;

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) dh[i] = 0.f;
  const float bhr = unit ? bh[j] : 0.f;
  const float bhz = unit ? bh[H + j] : 0.f;
  const float bhn = unit ? bh[2 * H + j] : 0.f;

  for (int step = 0; step < T_len; ++step) {
    // this step undoes forward time t; the forward processed t_first first
    const int t = reverse ? step : T_len - 1 - step;
    const bool first = reverse ? (t == T_len - 1) : (t == 0);
    const int tp = reverse ? t + 1 : t - 1;
    for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
      const int r = i / H, k = i % H, row = row0 + r;
      float v = 0.f;
      if (row < B) v = first ? h0[(size_t)row * H + k] : outs[((size_t)row * T_len + tp) * H + k];
      hp[i] = v;
      hc[i] = round_as<T>(v);
    }
    __syncthreads();

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
    float dh_part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      dh_part[r] = 0.f;
      if (!unit || row >= B) {
        if (unit) dp[r * H3 + j] = dp[r * H3 + H + j] = dp[r * H3 + 2 * H + j] = 0.f;
        continue;
      }
      const size_t n = (size_t)row * T_len + t;
      const T* xp = x_proj + n * H3;
      const float h_prev = hp[r * H + j];
      const float hn = acc[r][2] + bhn;
      const float rg = sigmoid_f(to_f(xp[j]) + (acc[r][0] + bhr));
      const float zg = sigmoid_f(to_f(xp[H + j]) + (acc[r][1] + bhz));
      const float ng = tanhf(to_f(xp[2 * H + j]) + rg * hn);
      const float m = mask[n];
      const float dh_total = g[n * H + j] + dh[r * H + j];
      const float dhat = m * dh_total;
      const float dz = dhat * (h_prev - ng);
      const float dn = dhat * (1.f - zg);
      const float dn_pre = dn * (1.f - ng * ng);
      const float dr = dn_pre * hn;
      const float dhn = dn_pre * rg;
      const float dz_pre = dz * zg * (1.f - zg);
      const float dr_pre = dr * rg * (1.f - rg);
      dh_part[r] = (1.f - m) * dh_total + dhat * zg;
      float* dxr = dx + n * H3;
      float* dpr = dhp + n * H3;
      dxr[j] = dr_pre;
      dxr[H + j] = dz_pre;
      dxr[2 * H + j] = dn_pre;
      dpr[j] = dr_pre;
      dpr[H + j] = dz_pre;
      dpr[2 * H + j] = dhn;
      dp[r * H3 + j] = round_as<T>(dr_pre);
      dp[r * H3 + H + j] = round_as<T>(dz_pre);
      dp[r * H3 + 2 * H + j] = round_as<T>(dhn);
    }
    __syncthreads();  // dp complete for every row of the block

    if (unit) {
      float acc2[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc2[r] = 0.f;
      const T* w = wht + j;
#pragma unroll 4
      for (int c = 0; c < H3; ++c) {
        const float wv = to_f(w[(size_t)c * H]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc2[r] = fmaf(dp[r * H3 + c], wv, acc2[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh[r * H + j] = dh_part[r] + acc2[r];
    }
    // the next step's load is followed by a barrier before dp is rewritten
  }
  __syncthreads();
  if (unit) {
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < B) dh0[(size_t)row * H + j] = dh[r * H + j];
    }
  }
}

constexpr int kTile = 32;    // dWh output tile (H rows x 3H columns)
constexpr int kTileY = 8;    // thread rows; each thread owns kTile / kTileY outputs
constexpr int kTileKC = 32;  // reduction chunk over K = B*T

// dWh (H,3H) f32 = sum over n = (row, t) of round(h_prev[n,:])^T round(dhp[n,:]),
// h_prev[n] = h0[row] at the first step processed, else outs at the previous
// step of forward processing order.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileY)
dwh_kernel(const float* __restrict__ h0, const float* __restrict__ outs,
           const float* __restrict__ dhp, float* __restrict__ dwh, int B, int T_len, int H,
           int reverse) {
  __shared__ float a_s[kTileKC][kTile];  // h_prev chunk: (n, k)
  __shared__ float b_s[kTileKC][kTile];  // dh_proj chunk: (n, c)
  const int ux = threadIdx.x, ty = threadIdx.y, tid = ty * kTile + ux;
  const int c0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int H3 = 3 * H, K = B * T_len;
  constexpr int kPer = kTile / kTileY;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < K; n0 += kTileKC) {
    for (int i = tid; i < kTileKC * kTile; i += kTile * kTileY) {
      const int nn = i / kTile, kk = i % kTile, n = n0 + nn;
      float av = 0.f, bv = 0.f;
      if (n < K) {
        const int row = n / T_len, t = n % T_len;
        const bool first = reverse ? (t == T_len - 1) : (t == 0);
        const int tp = reverse ? t + 1 : t - 1;
        if (k0 + kk < H)
          av = first ? h0[(size_t)row * H + k0 + kk]
                     : outs[((size_t)row * T_len + tp) * H + k0 + kk];
        if (c0 + kk < H3) bv = dhp[(size_t)n * H3 + c0 + kk];
      }
      a_s[nn][kk] = round_as<T>(av);
      b_s[nn][kk] = round_as<T>(bv);
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTileKC; ++nn) {
      const float bv = b_s[nn][ux];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(a_s[nn][ty * kPer + i], bv, acc[i]);
    }
    __syncthreads();
  }
  const int c = c0 + ux;
  if (c >= H3) return;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = k0 + ty * kPer + i;
    if (k < H) dwh[(size_t)k * H3 + c] = acc[i];
  }
}

// dbh (M) f32 = column sums of dhp (K, M), unrounded.
__global__ void bias_grad_kernel(const float* __restrict__ dhp, float* __restrict__ dbh, int K,
                                 int M) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M) return;
  float s = 0.f;
  for (int n = 0; n < K; ++n) s += dhp[(size_t)n * M + c];
  dbh[c] = s;
}

template <typename T>
void launch_bwd(const void* x_proj, const void* mask, const void* h0, const void* wh,
                const void* bh, const void* outs, const void* g, void* dx, void* dhp, void* dh0,
                void* dwh, void* dbh, void* wht, int B, int T_len, int H, int reverse,
                cudaStream_t stream) {
  const int H3 = 3 * H;
  transpose_kernel<T><<<dim3((H3 + 31) / 32, (H + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(wh), static_cast<T*>(wht), H, H3);
  const int threads = ((H + 31) / 32) * 32;
  const int smem = 6 * kRows * H * (int)sizeof(float);
  allow_smem(gru_scan_bwd_kernel<T>, smem);
  gru_scan_bwd_kernel<T><<<(B + kRows - 1) / kRows, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const float*>(mask),
      static_cast<const float*>(h0), static_cast<const T*>(wh), static_cast<const T*>(wht),
      static_cast<const float*>(bh), static_cast<const float*>(outs),
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(dhp),
      static_cast<float*>(dh0), B, T_len, H, reverse);
  const dim3 dwh_grid((H3 + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  dwh_kernel<T><<<dwh_grid, dim3(kTile, kTileY), 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(outs),
      static_cast<const float*>(dhp), static_cast<float*>(dwh), B, T_len, H, reverse);
  bias_grad_kernel<<<(H3 + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(dhp),
                                                          static_cast<float*>(dbh), B * T_len,
                                                          H3);
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

// Backward of vmmt_gru_scan. x_proj, wh and the scratch wht (3H*H
// elements) in the compute dtype; mask, h0, bh, outs, g and every output
// f32: dx, dhp (B,T,3H), dh0 (B,H), dwh (H,3H), dbh (3H).
extern "C" int vmmt_gru_scan_bwd(int dtype, const void* x_proj, const void* mask,
                                 const void* h0, const void* wh, const void* bh,
                                 const void* outs, const void* g, void* dx, void* dhp,
                                 void* dh0, void* dwh, void* dbh, void* wht, int B, int T_len,
                                 int H, int reverse, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(x_proj, mask, h0, wh, bh, outs, g, dx, dhp, dh0, dwh, dbh, wht, B,
                              T_len, H, reverse, s);
  } else {
    launch_bwd<float>(x_proj, mask, h0, wh, bh, outs, g, dx, dhp, dh0, dwh, dbh, wht, B, T_len,
                      H, reverse, s);
  }
  return (int)cudaGetLastError();
}
