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
// kernels of common.cuh in order on the stream, the state in T:
//   (a) cell_fwd_kernel: GRU0 for a tile of 32 rows x 32 hidden units, both
//       products tiled through shared memory, writes h0';
//   (b) cell_fwd_kernel: GRU1 the same way from h0', writes h1';
//   (c) gemm_kernel: h1' @ Wc_q into an f32 scratch (N,H);
//   (d) attn_fwd_kernel: one block per row: scores, masked softmax,
//       context, tanh; writes probs and attn.
// The chain variant runs (a) and (b) only.
//
// What bounds it on the H100: at N=1024, S=24, H=500 in bf16 the step
// moves about 56 MB (keys and mem_v are 49 MB of it) and does 6.9 GFLOP.
// The bytes bound is about 17 us; the products run here on the CUDA cores
// in f32 (67 TFLOP/s peak, about 0.1 ms), not on the tensor cores, so this
// simple design is bound by FMA throughput. wgmma for (a)-(c) is the next
// step.

#include "common.cuh"

namespace {

constexpr int kRPT = 4;          // rows per thread
constexpr int kTR = kTY * kRPT;  // rows per block

template <typename T>
void launch_chain(const void* emb_proj, const void* h0, const void* h1, const void* feed,
                  const void* wfeed, const void* wh0, const void* bh0, const void* wmid,
                  const void* bmid, const void* wh1, const void* bh1, void* h0n, void* h1n,
                  int N, int H, cudaStream_t stream) {
  const dim3 block(kTU, kTY);
  const dim3 grid((H + kTU - 1) / kTU, (N + kTR - 1) / kTR);
  cell_fwd_kernel<T, T, kRPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(emb_proj), 3 * H, nullptr, static_cast<const T*>(feed), nullptr, 0,
      static_cast<const T*>(wfeed), static_cast<const T*>(h0), static_cast<const T*>(wh0),
      static_cast<const float*>(bh0), static_cast<T*>(h0n), nullptr, 0, N, H);
  cell_fwd_kernel<T, T, kRPT><<<grid, block, 0, stream>>>(
      nullptr, 0, static_cast<const float*>(bmid), static_cast<const T*>(h0n), nullptr, 0,
      static_cast<const T*>(wmid), static_cast<const T*>(h1), static_cast<const T*>(wh1),
      static_cast<const float*>(bh1), static_cast<T*>(h1n), nullptr, 0, N, H);
}

template <typename T>
void launch_attn(const void* h1n, const void* keys, const void* mem_v, const void* wcq,
                 const void* mask_bias, void* attn, void* probs, void* qw, int N, int S,
                 int H, cudaStream_t stream) {
  const dim3 block(kTU, kTY);
  const dim3 grid((H + kTU - 1) / kTU, (N + kTR - 1) / kTR);
  gemm_kernel<T, T, kRPT><<<grid, block, 0, stream>>>(static_cast<const T*>(h1n), H,
                                                      static_cast<const T*>(wcq), nullptr, 0,
                                                      nullptr, static_cast<float*>(qw), N, H, H);
  const int smem = (H + S) * (int)sizeof(float);
  allow_smem(attn_fwd_kernel<T, T>, smem);
  attn_fwd_kernel<T, T><<<N, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(h1n), static_cast<const T*>(keys), static_cast<const T*>(mem_v),
      static_cast<const float*>(qw), static_cast<const float*>(mask_bias), nullptr,
      static_cast<T*>(attn), H, static_cast<T*>(probs), S, S, H);
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
