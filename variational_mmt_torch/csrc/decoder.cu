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
// The backward runs time in reverse, carrying (dh0, dh1, dfeed) in f32,
// recomputes the gates from the saved streams, and writes the local
// gradients dx0, dhp0, dx1, dhp1 (B,T,3H), pre (B,T,H), dscores (B,T,S) and
// dh00, dh01. The weight gradients are products over these streams outside
// (ops/decoder.py), as _pal_bwd computes them outside Pallas.
//
// On the TPU one grid step held the whole step with the weights resident in
// VMEM. On the H100 the step has grid-wide dependencies (GRU1 needs every
// column of h0', attention all of h1', the next step all of feed), so one
// entry point queues T steps of small kernels on the stream with no host
// synchronisation: forward 4 kernels per step (GRU0 cell, GRU1 cell,
// h1' @ Wc_q, attention), backward 5 weight transposes once and then 8
// kernels per step (attention backward, 5 products, 2 cell backwards). The
// forward's cell, product and attention kernels are the decode step's
// (common.cuh), with the dropout mask on GRU1's input and an f32 state;
// the backward's cell recomputes the gates through the same tiled products.
// The cells tile 16 rows x 32 hidden units per block and stage both products
// through shared memory; the products run on the CUDA cores in f32. At
// B=64, T=25, H=500 the work is tens of MFLOP per kernel, so each kernel is
// bound by its launch and the serial chain of 100 (forward) or 205
// (backward) dependent kernels, not by bytes or FLOPs.

#include "common.cuh"

namespace {

constexpr int kRPT = 2;          // rows per thread
constexpr int kTR = kTY * kRPT;  // rows per block

// Backward of one GRU cell application (gru_bwd_core): recomputes the gates
// and, from dhn (N,H) f32, writes dx = [dr_pre|dz_pre|dn_pre] and
// dhp = [dr_pre|dz_pre|dhn] (rows ldg apart) and dhprev = dhn * z, the part
// of dL/dh_prev without the Wh^T product.
template <typename T, typename TA, typename TH>
__global__ void __launch_bounds__(kThreads)
cell_bwd_kernel(const T* __restrict__ xbase, int ldx, const float* __restrict__ xbias,
                const TA* __restrict__ a, int lda, const T* __restrict__ amul, int ldm,
                const T* __restrict__ wa, const TH* __restrict__ h, int ldh,
                const T* __restrict__ wh, const float* __restrict__ bh,
                const float* __restrict__ dhn, float* __restrict__ dx, float* __restrict__ dhp,
                int ldg, float* __restrict__ dhprev, int N, int H) {
  float ax[kRPT][3], ah[kRPT][3];
  cell_products<T, TA, TH, kRPT>(a, lda, amul, ldm, wa, h, ldh, wh, N, H, ax, ah);
  const int j = blockIdx.x * kTU + threadIdx.x;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = blockIdx.y * kTR + threadIdx.y * kRPT + i;
    if (row >= N) continue;
    float x[3], hp[3];
    cell_inputs<T>(xbase, ldx, xbias, bh, ax[i], ah[i], row, j, H, x, hp);
    const float r = sigmoid_f(x[0] + hp[0]);
    const float z = sigmoid_f(x[1] + hp[1]);
    const float n = tanhf(x[2] + r * hp[2]);
    const float h_prev = to_f(h[(size_t)row * ldh + j]);
    const float dh = dhn[(size_t)row * H + j];
    const float dz = dh * (h_prev - n);
    const float dn = dh * (1.f - z);
    const float dn_pre = dn * (1.f - n * n);
    const float dr = dn_pre * hp[2];
    const float dhn_ = dn_pre * r;
    const float dz_pre = dz * z * (1.f - z);
    const float dr_pre = dr * r * (1.f - r);
    float* dxr = dx + (size_t)row * ldg;
    float* dpr = dhp + (size_t)row * ldg;
    dxr[j] = dr_pre;
    dxr[H + j] = dz_pre;
    dxr[2 * H + j] = dn_pre;
    dpr[j] = dr_pre;
    dpr[H + j] = dz_pre;
    dpr[2 * H + j] = dhn_;
    dhprev[(size_t)row * H + j] = dh * z;
  }
}

// Attention backward of step t, one block per row n:
//   pre = (1 - attn^2) * (d_attn[t] + dfeed)                -> pre[t]
//   dprobs = sum_h round(round(pre) * mem_v) + d_probs[t]
//   dscores = probs * (dprobs - sum_s dprobs * probs)       -> dscores[t]
//   out = sum_s round(round(dscores) * keys) + dh1
// (out + round(pre) @ Wc_q^T is dL/dh1' of the step). Dynamic shared
// memory: (H + 2S) floats.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_kernel(const T* __restrict__ attn_hs, const float* __restrict__ d_attn,
                const float* __restrict__ dfeed, const T* __restrict__ mem_v,
                const float* __restrict__ d_probs, const T* __restrict__ probs,
                const T* __restrict__ keys, const float* __restrict__ dh1,
                float* __restrict__ pre_out, float* __restrict__ dsc_out,
                float* __restrict__ out, int t, int T_len, int S, int H) {
  extern __shared__ float sm[];
  float* pr = sm;           // (H) pre rounded to T
  float* dp = sm + H;       // (S) dprobs
  float* ds = sm + H + S;   // (S) dscores rounded to T
  const int n = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const size_t nt = (size_t)n * T_len + t;
  for (int k = tid; k < H; k += blockDim.x) {
    const float a = to_f(attn_hs[nt * H + k]);
    const float da = d_attn[nt * H + k] + dfeed[(size_t)n * H + k];
    const float pre = (1.f - a * a) * da;
    pre_out[nt * H + k] = pre;
    pr[k] = round_as<T>(pre);
  }
  __syncthreads();
  for (int s = warp; s < S; s += n_warps) {
    const T* mv = mem_v + ((size_t)n * S + s) * H;
    float acc = 0.f;
    for (int k = lane; k < H; k += 32) acc += round_as<T>(pr[k] * to_f(mv[k]));
    acc = warp_sum(acc);
    if (lane == 0) dp[s] = acc + d_probs[nt * S + s];
  }
  __syncthreads();
  if (warp == 0) {
    float dot = 0.f;
    for (int s = lane; s < S; s += 32) dot += dp[s] * to_f(probs[nt * S + s]);
    dot = warp_sum(dot);
    for (int s = lane; s < S; s += 32) {
      const float prf = to_f(probs[nt * S + s]);
      const float d = prf * (dp[s] - dot);
      dsc_out[nt * S + s] = d;
      ds[s] = round_as<T>(d);
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += blockDim.x) {
    float c = 0.f;
    for (int s = 0; s < S; ++s) c += round_as<T>(ds[s] * to_f(keys[((size_t)n * S + s) * H + j]));
    out[(size_t)n * H + j] = c + dh1[(size_t)n * H + j];
  }
}

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
  void transpose(const T* in, T* out, int R, int C) const {
    transpose_kernel<T><<<dim3((C + 31) / 32, (R + 31) / 32), dim3(32, 8), 0, stream>>>(in, out,
                                                                                       R, C);
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

// cell backward at step t: the previous state is the f32 initial state at
// t == 0 and a saved T stream after it
template <typename T>
void cell_bwd(const Launch<T>& L, int t, const T* xbase, int ldx, const float* xbias,
              const T* a, int lda, const T* amul, int ldm, const T* wa, const float* h_init,
              const T* h_stream, int ld_stream, const T* wh, const float* bh, const float* dhn,
              float* dx, float* dhp, int ldg, float* dhprev) {
  if (t == 0) {
    cell_bwd_kernel<T, T, float><<<L.grid, L.block, 0, L.stream>>>(
        xbase, ldx, xbias, a, lda, amul, ldm, wa, h_init, L.H, wh, bh, dhn, dx, dhp, ldg, dhprev,
        L.N, L.H);
  } else {
    cell_bwd_kernel<T, T, T><<<L.grid, L.block, 0, L.stream>>>(
        xbase, ldx, xbias, a, lda, amul, ldm, wa, h_stream, ld_stream, wh, bh, dhn, dx, dhp,
        ldg, dhprev, L.N, L.H);
  }
}

template <typename T>
void decoder_bwd(const T* emb_proj, const T* dmid, const float* h00, const float* h01,
                 const T* wfeed, const T* wh0, const float* bh0, const T* wmid,
                 const float* bmid, const T* wh1, const float* bh1, const T* keys,
                 const T* mem_v, const T* wcq, const T* attn_hs, const T* h0s, const T* h1s,
                 const T* probs, const float* d_attn, const float* d_probs, float* dx0,
                 float* dhp0, float* dx1, float* dhp1, float* pre, float* dscores, float* dh00,
                 float* dh01, T* wt, float* scratch, int B, int T_len, int S, int H,
                 cudaStream_t stream) {
  const Launch<T> L(B, H, stream);
  const size_t BH = (size_t)B * H, W3 = (size_t)3 * H * H;
  const int H3 = 3 * H, ld3 = T_len * H3, ld1 = T_len * H;
  T* wfeed_t = wt;
  T* wh0_t = wt + W3;
  T* wmid_t = wt + 2 * W3;
  T* wh1_t = wt + 3 * W3;
  T* wcq_t = wt + 4 * W3;
  L.transpose(wfeed, wfeed_t, H, H3);
  L.transpose(wh0, wh0_t, H, H3);
  L.transpose(wmid, wmid_t, H, H3);
  L.transpose(wh1, wh1_t, H, H3);
  L.transpose(wcq, wcq_t, H, H);
  float* dfeed = scratch;
  float* dk = scratch + BH;         // attention part of dL/dh1' + dh1
  float* dh1n = scratch + 2 * BH;   // dL/dh1'
  float* dh1p = scratch + 3 * BH;   // dh1' * z1
  float* dh0n = scratch + 4 * BH;   // dL/dh0'
  float* dh0p = scratch + 5 * BH;   // dh0' * z0
  // dh00 / dh01 carry dh0 / dh1 across time and end as their gradients
  cudaMemsetAsync(dfeed, 0, BH * sizeof(float), stream);
  cudaMemsetAsync(dh00, 0, BH * sizeof(float), stream);
  cudaMemsetAsync(dh01, 0, BH * sizeof(float), stream);
  const int smem = (H + 2 * S) * (int)sizeof(float);
  allow_smem(attn_bwd_kernel<T>, smem);
  for (int t = T_len - 1; t >= 0; --t) {
    const size_t o1 = (size_t)t * H, o3 = (size_t)t * H3;
    attn_bwd_kernel<T><<<B, kAttnThreads, smem, stream>>>(attn_hs, d_attn, dfeed, mem_v, d_probs,
                                                          probs, keys, dh01, pre, dscores, dk, t,
                                                          T_len, S, H);
    L.gemm(pre + o1, ld1, wcq_t, nullptr, 0, dk, dh1n, H);
    cell_bwd<T>(L, t, nullptr, 0, bmid, h0s + o1, ld1, dmid + o1, ld1, wmid, h01,
                t > 0 ? h1s + o1 - H : nullptr, ld1, wh1, bh1, dh1n, dx1 + o3, dhp1 + o3, ld3,
                dh1p);
    L.gemm(dhp1 + o3, ld3, wh1_t, nullptr, 0, dh1p, dh01, H3);
    L.gemm(dx1 + o3, ld3, wmid_t, dmid + o1, ld1, dh00, dh0n, H3);
    cell_bwd<T>(L, t, emb_proj + o3, ld3, nullptr, t > 0 ? attn_hs + o1 - H : nullptr, ld1,
                nullptr, 0, wfeed, h00, t > 0 ? h0s + o1 - H : nullptr, ld1, wh0, bh0, dh0n,
                dx0 + o3, dhp0 + o3, ld3, dh0p);
    L.gemm(dhp0 + o3, ld3, wh0_t, nullptr, 0, dh0p, dh00, H3);
    L.gemm(dx0 + o3, ld3, wfeed_t, nullptr, 0, nullptr, dfeed, H3);
  }
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

// Backward over the sequence. Inputs as the forward's plus its four streams
// and d_attn (B,T,H), d_probs (B,T,S) in f32; writes dx0, dhp0, dx1, dhp1
// (B,T,3H), pre (B,T,H), dscores (B,T,S), dh00, dh01 (B,H), all f32.
// wt: 4*3H*H + H*H elements of the compute dtype; scratch: 6*B*H floats.
extern "C" int vmmt_decoder_bwd(int dtype, const void* emb_proj, const void* dmid,
                                const void* h00, const void* h01, const void* wfeed,
                                const void* wh0, const void* bh0, const void* wmid,
                                const void* bmid, const void* wh1, const void* bh1,
                                const void* keys, const void* mem_v, const void* wcq,
                                const void* attn_hs, const void* h0s, const void* h1s,
                                const void* probs, const void* d_attn, const void* d_probs,
                                void* dx0, void* dhp0, void* dx1, void* dhp1, void* pre,
                                void* dscores, void* dh00, void* dh01, void* wt, void* scratch,
                                int B, int T_len, int S, int H, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(h00), static_cast<const float*>(h01),
                      static_cast<const float*>(bh0), static_cast<const float*>(bmid),
                      static_cast<const float*>(bh1), static_cast<const float*>(d_attn),
                      static_cast<const float*>(d_probs)};
  float* o[] = {static_cast<float*>(dx0), static_cast<float*>(dhp0), static_cast<float*>(dx1),
                static_cast<float*>(dhp1), static_cast<float*>(pre),
                static_cast<float*>(dscores), static_cast<float*>(dh00),
                static_cast<float*>(dh01)};
  if (dtype == 1) {
    using T = __nv_bfloat16;
    decoder_bwd<T>(static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
                   static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2],
                   static_cast<const T*>(wmid), f[3], static_cast<const T*>(wh1), f[4],
                   static_cast<const T*>(keys), static_cast<const T*>(mem_v),
                   static_cast<const T*>(wcq), static_cast<const T*>(attn_hs),
                   static_cast<const T*>(h0s), static_cast<const T*>(h1s),
                   static_cast<const T*>(probs), f[5], f[6], o[0], o[1], o[2], o[3], o[4], o[5],
                   o[6], o[7], static_cast<T*>(wt), static_cast<float*>(scratch), B, T_len, S, H,
                   s);
  } else {
    using T = float;
    decoder_bwd<T>(static_cast<const T*>(emb_proj), static_cast<const T*>(dmid), f[0], f[1],
                   static_cast<const T*>(wfeed), static_cast<const T*>(wh0), f[2],
                   static_cast<const T*>(wmid), f[3], static_cast<const T*>(wh1), f[4],
                   static_cast<const T*>(keys), static_cast<const T*>(mem_v),
                   static_cast<const T*>(wcq), static_cast<const T*>(attn_hs),
                   static_cast<const T*>(h0s), static_cast<const T*>(h1s),
                   static_cast<const T*>(probs), f[5], f[6], o[0], o[1], o[2], o[3], o[4], o[5],
                   o[6], o[7], static_cast<T*>(wt), static_cast<float*>(scratch), B, T_len, S, H,
                   s);
  }
  return (int)cudaGetLastError();
}
