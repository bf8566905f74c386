// One GRU layer over a whole sequence: the forward scan and its backward.
//
// The forward replaces the Pallas kernel _gru_fwd_kernel of
// variational_mmt_tpu/ops/pallas/gru.py (gru_layer_scan, pallas_call at
// :165). Same contract: x_proj (B,T,3H) precomputed input projections in
// the compute dtype T (float, bfloat16 or float16), mask (B,T) f32, h0 (B,H) f32,
// Wh (H,3H) in T, bh (3H) f32. Gates [r|z|n] with the n-gate hidden bias
// inside r*(h@Whn+bhn); state and gate math in f32; the product h@Wh takes
// h rounded to T and accumulates in f32. A masked step passes the carry
// through, so the reverse direction is right over right padding. Writes
// outs (B,T,H) f32 and final (B,H) f32 (the state after the last step
// processed). An optional reset (B,T) f32 stream (sequence packing, the
// Pallas has_reset branch, gru.py:68-71) multiplies the carry by 1 - reset
// before the cell of each step. Both scan kernels are instantiated with and
// without it (kReset); a null pointer launches the instantiation without,
// which is the code of the reset-free design.
//
// On the TPU the time axis was a sequential grid with the state in VMEM
// scratch. Here the loop over t runs inside the kernel. Its bytes and
// FLOPs bound it at a few microseconds; what bounds it on this card is the
// latency of T dependent steps, each a (rows, H) x (H, 3H) product whose
// h_prev is the kernel's own output, so the product cannot be hoisted as
// the backward's gate recompute is. The design keeps Wh next to the cores
// and the step short: one thread-block cluster of C CTAs per `rows` batch
// rows (C = 8 at H=250, 16 at H=512: clusters above 8 CTAs are
// non-portable and allowed on each kernel before its launch; rows 4 or 8, a
// launch-plan choice), CTA c owning hidden units [c*units, (c+1)*units),
// units <= 32. In f32 above 448 units a cluster of 4 rows keeps 4 row
// slots of the state in place of 8, which brings H = 512 within a CTA's
// shared memory. Once per call each CTA
// loads the columns of Wh for its units' three gates into shared memory
// (96 columns x H, 48 KB in bf16). Per step it
//   1. forms its units' round(h) @ Wh[:, r|z|n columns] from shared memory:
//      in bf16 on the tensor cores (mma.sync m16n8k16, the 96 gate-unit
//      columns as six 16-row tiles, the 8 batch-row slots as the tile's
//      columns, K split four ways over 12 warps), in f32 by FMAs (never
//      TF32);
//   2. applies the gates in f32 from x_proj, mask and reset prefetched a
//      step ahead into registers (the thread's own carry first scaled by
//      this step's 1 - reset), and writes outs;
//   3. pushes its units' round(h' * (1 - reset of the next step)) into
//      every peer's double-buffered shared copy of the state (distributed
//      shared memory), so the product of the next step reads the zeroed
//      carry at a segment start (buffer 0 is filled from h0 the same way);
//   4. waits at one cluster barrier.
// The backward scan below shares the cluster layout, the DSMEM push and
// the mma fragments.
//
// The backward replaces _gru_bwd_kernel (_gru_scan_bwd_impl, pallas_call at
// :297). Its serial part is T dependent steps of two (rows, H) x (H, 3H)
// products: the gate recompute round(h_prev) @ Wh and dh_proj @ Wh^T. At
// training's B=64, T=24, H=250 its bytes and FLOPs bound it at a few
// microseconds; what bounds it on this card is the latency of the serial
// chain. This design takes off the chain what does not belong there and
// keeps Wh next to the cores, in three launches:
//   (a) the gate recompute does not depend on the backward recurrence
//       (h_prev is the saved forward output), so one tiled product computes
//       hp = round(h_prev) @ Wh + bh for all B*T (row, t) at once before the
//       scan: in bf16 and f16 on wgmma_gemm.cuh (TMA and wgmma) from
//       operands an operand pass rounds once (the launch plan's engine
//       "wgmma"; see "(a) and (c) on the wgmma engine" below), in f32 on
//       tile_gemm.cuh (FMAs; engine "tile"): the dtype alone picks;
//   (b) the reverse scan runs on thread-block clusters: one cluster of C
//       CTAs per kScanRows batch rows (C = 8 at H=250: 128 CTAs at B=64;
//       2 rows in f32 where 4 rows of dh_proj buffers do not fit, H > 448),
//       CTA c owning hidden units [c*units, (c+1)*units). Each CTA loads its
//       rows of Wh (units x 3H, 48 KB in bf16) into shared memory once. Per
//       step it does the gate backward of its units from hp, pushes its
//       rounded slice of dh_proj into every peer's shared memory
//       (distributed shared memory, double-buffered), waits at one cluster
//       barrier and forms dh[units] = dh_part + dh_proj @ Wh[units, :]^T
//       from shared memory: in bf16 on the tensor cores (the units are the
//       16 rows of an mma tile, the batch rows its columns, four warps
//       splitting K for each tile), in f32 by FMAs. The next step's inputs
//       are loaded while the current one computes;
//   (c) dWh = sum over (row, t) of round(h_prev)^T round(dh_proj) is one
//       tiled product over K = B*T on the same engine as (a), K split over
//       several CTAs a tile where the tiles are too few to fill the card,
//       whose partials the last CTA adds in a fixed order; dbh, the
//       unrounded column sums of dh_proj, comes from the operand pass
//       (wgmma) or extra blocks of the same launch (tile). Deterministic.
// The scan writes dx_proj and only the third gate block of dh_proj (its
// first two equal dx_proj's), which (c) reads.
// With a reset stream (the Pallas has_reset branch, gru.py:205-210 and
// :244-245) every h_prev is the zeroed state h_prev * (1 - reset): in (a),
// in the scan's gate backward and in (c). The carry's cotangent does not
// cross a segment start: the scan multiplies each step's dh_prev by that
// step's 1 - reset where the next step (or dh0) reads it.
//
// Tiled plan of the forward (the launch plan's layout "tiled": above 512
// units, and below wherever the cluster plan's clusters would not all fit
// the card at once, as 16-CTA clusters do from 449 units at B >= 64). Past
// 512 units the three gate blocks of Wh no longer fit one cluster of 16
// CTAs (6.3 MB in bf16 at H = 1024), so the state crosses CTAs through
// global memory (L2) and each step ends at a grid barrier. Per step the
// serial part is h_proj = round(h) @ Wh + bh, a (B, H) x (H, 3H) product
// whose operand is the step before's own output, then the gates. Its FLOPs
// are few (0.4-6.4 GFLOP a step at B = 64-256, H = 1000-2048); what bounds
// it on this card is the bytes each SM pulls from L2 a step and the T grid
// barriers. Here the product is output-stationary, as the backward's tiled
// plan below: one persistent cooperative kernel a chunk of rows, CTA tiles
// of rows x units cells (rows 32, 64 or 128, units 8 to 128; N = 3 units,
// the r, z and n columns of the tile's own units, so the gates need nothing
// from another CTA). Each step's K = H moves through a ring of stages in
// shared memory filled by cp.async.cg (through L2, past the L1, which is not
// coherent across SMs) with round(h) rows from the exchange buffer and,
// where they do not stay resident, Wh's k-rows of the tile's columns, while
// the warps multiply the stage before; or, where the tile's columns of Wh
// stay resident and the CTA's whole K of its state rows fits beside them
// (kFwdWholeK), in one stage that the TMA unit fills with a bulk copy a
// row, completing on one mbarrier, with no barrier between K chunks. ldmatrix
// feeds mma.sync m16n8k16 in bf16 and f16 (Wh's (K, N) rows through
// ldmatrix.trans), float4 reads feed FMAs in f32 (never TF32), each warp a
// 32 x 48 of the tile (16 x 24 at 8 units, whose tile N is 24), so a step's
// state leaves L2 H / units times. Tiles of 8 units give each of 64 or more
// CTAs all of K at B = 64; where B leaves few tiles, a thread-block cluster
// of 2 or 4 CTAs splits K a tile and adds the partial products of the rows
// each CTA owns through distributed shared memory in rank order
// (deterministic). Each CTA keeps the f32 carry of its own cells and its
// units' biases in shared memory for the call; it writes outs, round(h' *
// keep of the next step) into the other exchange buffer and, at the last
// step, final. Where the tile's columns of Wh stay in shared memory for the
// call the partial products share the ring's bytes; else the ring brings
// them each step (the first stages' copies issued as soon as the product
// before is done: they do not wait for the state), with 2 stages in place of
// 4 where 4 do not fit. Wh is read in place where each gate's columns start
// on a 16-byte piece (H a multiple of 8 in 16 bits, 4 in f32), else from a
// copy the wrapper pads once a call. The gate inputs of a thread's first
// cells load under the product. Batches above a launch's rows run in
// chunks, one launch each; the launch is cooperative and clustered at once
// (cudaLaunchKernelEx with both attributes).
//
// Tiled plan of the backward (layout "tiled": above 512 units, and below
// wherever the cluster plan's clusters would not all fit the card at once).
// The backward's serial part (b) there, the reverse scan of
// _gru_bwd_kernel: per step the gate backward of every (row, unit) cell,
// then dh = dh_part + round(dh_proj) @ Wh^T, a (B, 3H) x (3H, H) product
// whose operand is the step's own output, so it cannot be hoisted. Its
// FLOPs are few (0.4-6.4 GFLOP a step at B = 64-256, H = 1000-2048); what
// bounds it on this card is how many bytes each SM pulls from L2 a step,
// and the T grid barriers. Here the product is output-stationary: one
// persistent cooperative kernel a chunk of rows, CTA tiles of rows x units
// cells (32 to 128 a side in 32 x 32 warp tiles, so a fragment of dh_proj
// serves 4 n-tiles and one of Wh 2 m-tiles; or the narrow tiles of 16 rows,
// or of 8 or 16 units, in 16 x 8 warp tiles, which give 64 or more CTAs all
// of K at B = 64 with no K split), so a step's dh_proj leaves L2 H / units
// times. Each step's K = 3H moves through a ring of kTiledStages stages in
// shared memory filled by cp.async.cg (through L2, past the L1, which is
// not coherent across SMs) while the warps multiply the stage before; or,
// where the tile's rows of Wh stay resident and the CTA's whole K of its
// rows of dh_proj fits beside them (kBwdWholeK), in one stage that the TMA
// unit fills with a bulk copy a row, completing on one mbarrier, with no
// barrier between K chunks (the warps' partial products then take the
// stage's bytes). ldmatrix feeds mma.sync m16n8k16 in bf16 and f16 (f32
// accumulators), float4 reads feed FMAs in f32 (never TF32). Where B leaves
// too few tiles to fill the card, a thread-block cluster of 2 or 4 CTAs
// splits K a tile: the launch is cooperative and clustered at once
// (cudaLaunchKernelEx with both attributes, checked on an H100: 30 clusters
// of 4 or 66 of 2 at once), each CTA reduces its K chunks, and each adds
// the cluster's partial products of the rows it owns (a quarter or half of
// the tile) through distributed shared memory in rank order, so the result
// does not depend on timing. Without a cluster there is no sums pass: the
// next step's gate backward adds the K groups' partial products, in group
// order, as it reads each cell's dh. The dh carry and dh_part of the cells
// a CTA owns stay in its shared memory for the call. Wh's rows are
// K-contiguous for this product: they are read in place where 3H elements
// are whole 16-byte pieces, else from a copy the wrapper pads once a call;
// where a CTA's rows of Wh over its K chunks fit its shared memory they stay
// there for the call (loaded once), else the ring brings them each step
// with the activations (from L2 where Wh fits the 50 MB, else from HBM),
// the first stages' copies issued before the gate backward, since they do
// not wait for the step. While the product runs, each CTA loads the next
// step's gate inputs of its cells (narrow tiles) or prefetches them into
// L2. The gate backward, round(dh_proj) in the two exchange buffers, one
// grid barrier a step, the reset stream and both directions are the
// cluster plan's; (a) and (c) are its tiled products, which take any shape.
// Batches above a launch's rows run in chunks, one launch each.
//
// float16 takes bf16's path on every plan (is_mma in tile_gemm.cuh): the
// same mma.sync m16n8k16 fragments with f16 operands, the same 2-byte
// strides, tilings and shared memory. What this file says of bf16 holds
// for both.

#include <cooperative_groups.h>

#include <type_traits>

#include "block_product.cuh"
#include "wgmma_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScanRows = 4;       // batch rows per cluster (2 in f32 where 4 do not fit)
constexpr int kScanUnits = 32;     // most hidden units one CTA owns
constexpr int kMaxCluster = 16;    // the largest (non-portable) cluster of the H100
constexpr int kScanThreads = 256;  // covers kScanRows x kScanUnits gate items
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kUnitsPerWarp = kScanUnits / kScanWarps;
constexpr int kScanParts = kScanWarps / 2;  // bf16: warps splitting K for one 16-unit tile

// ---------------------------------------------------------------------------
// Forward scan on clusters; see the note at the top.

constexpr int kFwdSlots = 8;                 // batch-row slots of the state (mma columns)
constexpr int kFwdFewSlots = 4;              // f32 where 8 slots do not fit (H > 448)
constexpr size_t kSmemPerBlock = 232448;     // dynamic shared memory a CTA may take
constexpr int kFwdCols = 3 * kScanUnits;     // gate-unit columns of Wh a CTA holds
constexpr int kFwdTiles = kFwdCols / 16;     // bf16: 16-row mma tiles of them
constexpr int kFwdParts = 4;                 // K split of the step's product
constexpr int kFwdThreads = kFwdCols * kFwdParts;  // f32: one (column, part) a thread
constexpr int kFwdWarps = kFwdThreads / 32;
static_assert(kFwdSlots * kScanUnits <= kFwdThreads, "a gate item per thread");

// Dynamic shared memory of the forward, one CTA: its columns of Wh and two
// state buffers in the compute dtype, then the K-split partial products
// (kFwdParts, kFwdCols, slots) in f32. Column c = gate * 32 + unit.
// bf16: Wh as (kFwdCols, ld) and the state as (slots, ld), K along
// rows at the mma stride, zero past H; f32: Wh as (H, kFwdCols) and the
// state as (H, slots), so that a warp reads 32 columns or one row's
// slots at once.
template <typename T>
struct FwdLayout {
  int ld, slots;
  size_t w, hb, buf, total;
  __host__ __device__ FwdLayout(int H, int slots_) : slots(slots_) {
    ld = is_mma<T>() ? slice_ld<T>(H) : H;
    buf = (size_t)slots * ld;  // elements of one state buffer
    w = align16((size_t)kFwdCols * ld * sizeof(T));
    hb = align16(2 * buf * sizeof(T));
    total = w + hb + (size_t)kFwdParts * kFwdCols * slots * sizeof(float);
  }
  // offset of (slot r, unit k) in a state buffer
  __host__ __device__ int at(int r, int k) const {
    return is_mma<T>() ? r * ld + k : k * slots + r;
  }
};

// Batch-row slots of the forward's state buffers for clusters of `rows`
// rows: 8 (the mma's columns in bf16); in f32 4 where clusters of at most 4
// rows would not fit a CTA's shared memory with 8 (which brings f32 at H =
// 512 within it).
template <typename T>
int fwd_slots(int H, int rows) {
  return !is_mma<T>() && rows <= kFwdFewSlots && FwdLayout<T>(H, kFwdSlots).total > kSmemPerBlock
             ? kFwdFewSlots
             : kFwdSlots;
}

// The inputs of one (row, unit) at one step, loaded a step ahead; keep =
// 1 - reset.
struct FwdIn {
  float x[3], m, keep;
};

// Forward scan over one cluster's `rows` (<= kSlots) batch rows; with
// kReset, reset is read, else it is ignored.
template <typename T, bool kReset, int kSlots>
__global__ void __launch_bounds__(kFwdThreads)
gru_scan_fwd_kernel(const T* __restrict__ x_proj, const float* __restrict__ mask,
                    const float* __restrict__ reset, const float* __restrict__ h0,
                    const T* __restrict__ wh, const float* __restrict__ bh,
                    float* __restrict__ outs, float* __restrict__ final_h, int B, int T_len, int H,
                    int units, int rows, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int H3 = 3 * H, tid = threadIdx.x;
  const int row0 = (blockIdx.x / C) * rows;
  const int j0 = rank * units, nu = max(0, min(units, H - j0));
  const FwdLayout<T> L(H, kSlots);
  const int ld = L.ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  T* h_s = reinterpret_cast<T*>(smem_raw + L.w);  // two state buffers
  float* red_s = reinterpret_cast<float*>(smem_raw + L.w + L.hb);

  // Wh[k, g*H + j0 + u] for the CTA's columns c = g*32 + u, zero past its
  // units and past H; read with u fastest (coalesced)
  for (int i = tid; i < ld * kFwdCols; i += kFwdThreads) {
    const int k = i / kFwdCols, c = i % kFwdCols, g = c / kScanUnits, u = c % kScanUnits;
    const T v = u < nu && k < H ? wh[(size_t)k * H3 + g * H + j0 + u] : from_f<T>(0.f);
    w_s[is_mma<T>() ? c * ld + k : k * kFwdCols + c] = v;
  }
  // 1 - reset at (row, t)
  auto keep_at = [&](int row, int t) { return 1.f - reset[(size_t)row * T_len + t]; };
  // buffer 0 holds round(h0) of the cluster's rows (times the keep of the
  // first step processed), the rest is zero
  const int t_first = reverse ? T_len - 1 : 0;
  for (int i = tid; i < 2 * (int)L.buf; i += kFwdThreads) {
    const int b = i / (int)L.buf, e = i % (int)L.buf;
    const int r = is_mma<T>() ? e / ld : e % kSlots;
    const int k = is_mma<T>() ? e % ld : e / kSlots;
    const int row = row0 + r;
    const bool in = b == 0 && r < rows && row < B && k < H;
    float v = in ? h0[(size_t)row * H + k] : 0.f;
    if constexpr (kReset) v = in ? v * keep_at(row, t_first) : 0.f;
    h_s[i] = from_f<T>(v);
  }

  // this thread's gate item: (row0 + r, j0 + u), tid = r * 32 + u
  const int r = tid / kScanUnits, u = tid % kScanUnits, row = row0 + r, j = j0 + u;
  const bool item = r < rows && u < nu;
  const bool live = item && row < B;
  float h_prev = live ? h0[(size_t)row * H + j] : 0.f;
  const float bhr = item ? bh[j] : 0.f;
  const float bhz = item ? bh[H + j] : 0.f;
  const float bhn = item ? bh[2 * H + j] : 0.f;
  auto load = [&](int step, FwdIn& in) {
    const int t = reverse ? T_len - 1 - step : step;
    const size_t n = (size_t)row * T_len + t;
#pragma unroll
    for (int q = 0; q < 3; ++q) in.x[q] = to_f(x_proj[n * H3 + q * H + j]);
    in.m = mask[n];
    if constexpr (kReset) in.keep = keep_at(row, t);
  };
  FwdIn cur{}, nxt{};
  if (live) load(0, cur);
  cluster.sync();  // every peer runs, and its buffers are set, before the first push

  const int lane = tid & 31, warp = tid >> 5;
  for (int step = 0; step < T_len; ++step) {
    const int t = reverse ? T_len - 1 - step : step;
    if (live && step + 1 < T_len) load(step + 1, nxt);
    const T* hb = h_s + (step & 1) * L.buf;

    // red[part][c][slot] = sum over the part's k of hb[slot, k] Wh[k, c]
    if constexpr (is_mma<T>()) {
      const int gq = lane >> 2, tq = lane & 3;
      const int ks = pad16(H) / 16;
      const T* db = hb + (size_t)gq * ld + 2 * tq;
      for (int job = warp; job < kFwdTiles * kFwdParts; job += kFwdWarps) {
        const int tile = job % kFwdTiles, part = job / kFwdTiles;
        const T* wa = w_s + (size_t)(tile * 16 + gq) * ld + 2 * tq;
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int s = part * ks / kFwdParts; s < (part + 1) * ks / kFwdParts; ++s) {
          const int k = s * 16;
          const uint32_t a[4] = {pair_at(wa + k), pair_at(wa + 8 * ld + k), pair_at(wa + k + 8),
                                 pair_at(wa + 8 * ld + k + 8)};
          mma16<T>(c4, a, pair_at(db + k), pair_at(db + k + 8));
        }
        float* red = red_s + ((size_t)part * kFwdCols + tile * 16 + gq) * kSlots + 2 * tq;
        red[0] = c4[0];
        red[1] = c4[1];
        red[8 * kSlots] = c4[2];
        red[8 * kSlots + 1] = c4[3];
      }
    } else {
      const int c = tid % kFwdCols, part = tid / kFwdCols;
      float acc[kSlots] = {};
      for (int k = part * H / kFwdParts; k < (part + 1) * H / kFwdParts; ++k) {
        const float w = to_f(w_s[k * kFwdCols + c]);
        float hv[kSlots];
#pragma unroll
        for (int q = 0; q < kSlots / 4; ++q) {
          const float4 v4 = reinterpret_cast<const float4*>(hb + k * kSlots)[q];
          hv[4 * q] = v4.x;
          hv[4 * q + 1] = v4.y;
          hv[4 * q + 2] = v4.z;
          hv[4 * q + 3] = v4.w;
        }
#pragma unroll
        for (int s = 0; s < kSlots; ++s) acc[s] = fmaf(hv[s], w, acc[s]);
      }
      float* red = red_s + ((size_t)part * kFwdCols + c) * kSlots;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) red[s] = acc[s];
    }
    __syncthreads();  // every partial product is in red_s

    if (live) {
      if constexpr (kReset) h_prev *= cur.keep;  // as the product read it: zero at a start
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < kFwdParts; ++p)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          acc[g] += red_s[((size_t)p * kFwdCols + g * kScanUnits + u) * kSlots + r];
      const float rg = sigmoid_f(cur.x[0] + (acc[0] + bhr));
      const float zg = sigmoid_f(cur.x[1] + (acc[1] + bhz));
      const float ng = tanhf(cur.x[2] + rg * (acc[2] + bhn));
      const float cand = (1.f - zg) * ng + zg * h_prev;
      h_prev = cur.m > 0.f ? cand : h_prev;
      outs[((size_t)row * T_len + t) * H + j] = h_prev;
      if (step + 1 < T_len) {
        // rows past B are never pushed: their slots stay zero
        T* nb = h_s + ((step + 1) & 1) * L.buf + L.at(r, j);
        const T v = from_f<T>(kReset ? h_prev * nxt.keep : h_prev);
        for (int p = 0; p < C; ++p) *cluster.map_shared_rank(nb, p) = v;
      }
    }
    cluster.sync();  // every slice of h' has arrived; red_s may be rewritten
    cur = nxt;
  }
  if (live) final_h[(size_t)row * H + j] = h_prev;
}

// Clusters above 8 CTAs are non-portable: the kernel must allow them
// before a launch or an occupancy query.
template <typename Kernel>
void allow_cluster(Kernel kernel, int cluster, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cluster > 8)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The forward's kernel for a reset stream (or none) and clusters of `rows`
// rows (the instantiations have one function type).
template <typename T>
auto fwd_kernel(bool reset, int H, int rows) {
  if constexpr (!is_mma<T>()) {
    if (fwd_slots<T>(H, rows) == kFwdFewSlots)
      return reset ? gru_scan_fwd_kernel<T, true, kFwdFewSlots>
                   : gru_scan_fwd_kernel<T, false, kFwdFewSlots>;
  }
  return reset ? gru_scan_fwd_kernel<T, true, kFwdSlots>
               : gru_scan_fwd_kernel<T, false, kFwdSlots>;
}

template <typename T, typename Kernel>
cudaLaunchConfig_t scan_fwd_config(Kernel kernel, int B, int H, int cluster, int rows,
                                   cudaLaunchAttribute* attr, cudaStream_t stream) {
  const size_t smem = FwdLayout<T>(H, fwd_slots<T>(H, rows)).total;
  allow_cluster(kernel, cluster, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch_fwd(const void* x_proj, const void* mask, const void* reset, const void* h0,
               const void* wh, const void* bh, void* outs, void* final_h, int B, int T_len,
               int H, int reverse, int cluster, int units, int rows, cudaStream_t stream) {
  const auto kernel = fwd_kernel<T>(reset != nullptr, H, rows);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = scan_fwd_config<T>(kernel, B, H, cluster, rows, attr, stream);
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x_proj),
      static_cast<const float*>(mask), static_cast<const float*>(reset),
      static_cast<const float*>(h0), static_cast<const T*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(outs), static_cast<float*>(final_h), B, T_len, H, units, rows, reverse);
}

// Dynamic shared memory of the scan, one CTA of a cluster of `rows` batch
// rows: its rows of Wh (wrows, ld) and two dh_proj buffers (rows, ld) in
// the compute dtype, then dh and dh_part (rows, units) and, in bf16, the
// partial products of the warps (kScanParts, kScanUnits, rows) in f32. In
// bf16 the rows are mma operands: 32 rows (two 16-unit tiles) of
// conflict-free stride, zero past the CTA's units and 3H.
template <typename T>
struct ScanLayout {
  int wrows, ld;
  size_t w, dp, total;
  __host__ __device__ ScanLayout(int H, int units, int rows) {
    wrows = is_mma<T>() ? kScanUnits : units;
    ld = is_mma<T>() ? slice_ld<T>(3 * H) : 3 * H;
    w = align16((size_t)wrows * ld * sizeof(T));
    dp = align16((size_t)2 * rows * ld * sizeof(T));
    total = w + dp + (size_t)2 * rows * units * sizeof(float) +
            (is_mma<T>() ? (size_t)kScanParts * kScanUnits * rows * sizeof(float) : 0);
  }
};

// Multiplies v by 1 - reset[i], the keep of flat (row, t) index i (nothing
// without a reset stream).
__device__ __forceinline__ void apply_keep(const float* __restrict__ reset, int i,
                                           float (&v)[16]) {
  if (reset == nullptr) return;
  const float keep = 1.f - reset[i];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] *= keep;
}

// hp (B*T, 3H) f32 = round(h_prev) @ Wh + bh, h_prev zeroed at resets
template <typename T>
struct ScanHoist {
  int M, N, K;
  const float* __restrict__ h0;
  const float* __restrict__ outs;
  const float* __restrict__ reset;
  const T* __restrict__ wh;
  const float* __restrict__ bh;
  float* __restrict__ hp;
  int T_len, H, reverse;
  static constexpr bool kAFastK = true, kBFastK = false;
  __device__ void load_a(int m, int k, float (&v)[16]) const {
    prev_seg<float>(h0, outs, m / T_len, m % T_len, T_len, H, k, m < M ? min(16, K - k) : 0,
                    reverse, v);
    if (m < M) apply_keep(reset, m, v);
  }
  __device__ void load_b(int k, int n, float (&v)[16]) const {
    seg_load(wh + (size_t)k * N + n, k < K ? min(16, N - n) : 0, v);
  }
  __device__ void out(int m, int n, float v) const { hp[(size_t)m * N + n] = v + bh[n]; }
  int extra_blocks() const { return 0; }
  __device__ void extra(int) const {}
};

// dWh (H, 3H) = sum over (row, t) of round(h_prev)^T round(dh_proj), with
// dh_proj = [dx[:, :2H] | dhn] and h_prev zeroed at resets; the extra blocks
// write dbh (3H), 32 columns a block.
template <typename T>
struct ScanDWh {
  int M, N, K;
  const float* __restrict__ h0;
  const float* __restrict__ outs;
  const float* __restrict__ reset;
  const float* __restrict__ dx;
  const float* __restrict__ dhn;
  float* __restrict__ dwh;
  float* __restrict__ dbh;
  int T_len, H, reverse;
  static constexpr bool kAFastK = false, kBFastK = false;
  __device__ float dhp(int k, int n) const {
    return n < 2 * H ? dx[(size_t)k * N + n] : dhn[(size_t)k * H + n - 2 * H];
  }
  __device__ void load_a(int m, int k, float (&v)[16]) const {
    prev_seg<float>(h0, outs, k / T_len, k % T_len, T_len, H, m, k < K ? min(16, M - m) : 0,
                    reverse, v);
    if (k < K) apply_keep(reset, k, v);
  }
  __device__ void load_b(int k, int n, float (&v)[16]) const {
    const int len = k < K ? min(16, N - n) : 0;
    if (n + len <= 2 * H) {
      seg_load(dx + (size_t)k * N + n, len, v);
    } else if (n >= 2 * H) {
      seg_load(dhn + (size_t)k * H + n - 2 * H, len, v);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = i < len ? dhp(k, n + i) : 0.f;
    }
  }
  __device__ void out(int m, int n, float v) const { dwh[(size_t)m * N + n] = v; }
  int extra_blocks() const { return (N + 31) / 32; }
  __device__ void extra(int blk) const {
    __shared__ float part[kGemmThreads / 32][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = blk * 32 + lane;
    float s = 0.f;
    if (n < N) {
#pragma unroll 8
      for (int k = warp; k < K; k += kGemmThreads / 32) s += dhp(k, n);
    }
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && n < N) {
      float v = 0.f;
      for (int w = 0; w < kGemmThreads / 32; ++w) v += part[w][lane];
      dbh[n] = v;
    }
  }
};

// ---------------------------------------------------------------------------
// (a) and (c) on the wgmma engine (the launch plan's engine "wgmma",
// bfloat16 and float16; wgmma_gemm.cuh). An operand pass writes the
// rounded operands once, in the compute dtype, rows padded to a multiple of
// 8 values so that TMA can address them: before (a), Hs (B*T, pad8(H)) =
// round(h_prev * keep), which (a) and (c) share, and Wh's copy with rows of
// pad8(3H) where its own rows are not whole 16-byte pieces; after the scan,
// dP (B*T, pad8(3H)) = round(dh_proj) and dbh, the unrounded column sums of
// dh_proj, in a fixed order. Then (a) hp = Hs @ Wh + bh and (c) dWh = Hs^T
// dP, each one launch of wgmma_gemm. The pass moves about 300 MB at B = 256,
// T = 24, H = 2048 (0.09 ms at 3.35 TB/s); the f32 operands that
// tile_gemm.cuh gathers cross device memory at twice the bytes, twice.

constexpr int kOperandRows = 128;  // rows of dh_proj whose column sums one block of the dP pass adds
constexpr int kOperandThreads = 256;

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

// Hs (B*T, pad8(H)) = round(h_prev * keep), zero past H, a block a row;
// blocks after the B*T rows copy Wh (H, 3H) to wp, rows pad8(3H) apart,
// zero past 3H (no blocks where wp is null).
template <typename T>
__global__ void __launch_bounds__(kOperandThreads)
scan_hs_kernel(const float* __restrict__ h0, const float* __restrict__ outs,
               const float* __restrict__ reset, const T* __restrict__ wh, T* __restrict__ hs,
               T* __restrict__ wp, int B, int T_len, int H, int reverse) {
  const int m = blockIdx.x;
  if (m < B * T_len) {
    const int ldh = pad8(H), row = m / T_len, t = m % T_len;
    const float keep = reset != nullptr ? 1.f - reset[m] : 1.f;
    for (int k = 2 * threadIdx.x; k < ldh; k += 2 * kOperandThreads) {
      const float v0 = k < H ? prev_state(h0, outs, row, t, T_len, H, k, reverse) * keep : 0.f;
      const float v1 =
          k + 1 < H ? prev_state(h0, outs, row, t, T_len, H, k + 1, reverse) * keep : 0.f;
      *reinterpret_cast<uint32_t*>(hs + (size_t)m * ldh + k) = pack2<T>(v0, v1);
    }
    return;
  }
  const int k = m - B * T_len, N = 3 * H, ld = pad8(N);
  for (int n = threadIdx.x; n < ld; n += kOperandThreads)
    wp[(size_t)k * ld + n] = n < N ? wh[(size_t)k * N + n] : from_f<T>(0.f);
}

// dP (B*T, pad8(3H)) = round([dx[:, :2H] | dhn]), zero past 3H; block
// (x, y) covers columns 32x .. 32x + 31 of rows 128y .. 128y + 127 (a warp
// a row at a time, a lane a column) and writes its column sums to partial
// (y, n); the last block of a column strip to finish (an atomic count a
// strip) adds the strip's partial sums in row order into dbh.
template <typename T>
__global__ void __launch_bounds__(kOperandThreads)
scan_dp_kernel(const float* __restrict__ dx, const float* __restrict__ dhn, T* __restrict__ dp,
               float* __restrict__ dbh, float* __restrict__ partial, int* __restrict__ counters,
               int M, int H) {
  constexpr int kWarps = kOperandThreads / 32;
  __shared__ float part[kWarps][32];
  __shared__ int last;
  const int N = 3 * H, ld = pad8(N), lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int r1 = min(M, ((int)blockIdx.y + 1) * kOperandRows);
  auto at = [&](int m) {
    if (n >= N) return 0.f;
    return n < 2 * H ? dx[(size_t)m * N + n] : dhn[(size_t)m * H + n - 2 * H];
  };
  float sum = 0.f;
  for (int m = (int)blockIdx.y * kOperandRows + warp; m < r1; m += 4 * kWarps) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = m + q * kWarps < r1 ? at(m + q * kWarps) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (m + q * kWarps < r1 && n < ld) dp[(size_t)(m + q * kWarps) * ld + n] = from_f<T>(v[q]);
      sum += v[q];
    }
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && n < N) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += part[w][lane];
    partial[(size_t)blockIdx.y * N + n] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last || warp != 0 || n >= N) return;
  __threadfence();
  float v = 0.f;
  for (int c = 0; c < (int)gridDim.y; ++c) v += __ldcg(&partial[(size_t)c * N + n]);
  dbh[n] = v;
}

// What the wgmma engine's products read and write. hs (B*T, pad8(H)) and
// dp (B*T, pad8(3H)) in the compute dtype; wp: null, or (H, pad8(3H)) for
// the operand pass to fill with Wh; (a)'s B operand wb (Wh, wp or the
// tiled plan's padded copy), rows ldb apart; partial and counters: dWh's
// split (splits * 128 * bn floats and an int a tile) and, in the same
// bytes before it, the dP pass's column sums (an int a strip after dWh's).
struct Products {
  const float* h0;
  const float* outs;
  const float* reset;
  const void* wh;
  const float* bh;
  const float* dx;
  const float* dhn;
  float* hp;
  float* dwh;
  float* dbh;
  void* hs;
  void* dp;
  void* wp;
  const void* wb;
  int ldb;
  float* partial;
  int* counters;
  int B, T_len, H, reverse, splits, bn, stages;
};

// Whether the products take p: 16-bit, tiles of 128 or 256 columns, a ring
// that fits a CTA's shared memory, the scratch given, at least one K slice
// a split.
bool products_valid(const Products& p) {
  const int kb = (p.B * p.T_len + kWgBK - 1) / kWgBK;
  return (p.bn == 128 || p.bn == 256) && p.stages >= 2 &&
         wg_smem(p.bn, p.stages) <= (int)kSmemPerBlock && p.splits >= 1 && p.splits <= kb &&
         p.hs != nullptr && p.dp != nullptr && p.partial != nullptr && p.counters != nullptr;
}

// The operand pass before the scan, then (a).
template <typename T>
int launch_hoist(const Products& p, cudaStream_t stream) {
  if constexpr (!is_mma<T>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int M = p.B * p.T_len, H = p.H;
    scan_hs_kernel<T><<<M + (p.wp != nullptr ? H : 0), kOperandThreads, 0, stream>>>(
        p.h0, p.outs, p.reset, static_cast<const T*>(p.wh), static_cast<T*>(p.hs),
        static_cast<T*>(p.wp), p.B, p.T_len, H, p.reverse);
    CUtensorMap ta, tb;
    int err = tensor_map<T>(&ta, p.hs, M, H, pad8(H), kWgBM);
    if (err == 0) err = tensor_map<T>(&tb, p.wb, H, 3 * H, p.ldb, 64);
    if (err != 0) return err;
    const WgGemm g = {M, 3 * H, H, p.hp, 3 * H, p.bh, 1, nullptr, nullptr, p.stages};
    return wgmma_gemm<T>(ta, tb, false, p.bn, g, stream);
  }
}

// The operand pass after the scan (dP and dbh), then (c).
template <typename T>
int launch_dwh(const Products& p, cudaStream_t stream) {
  if constexpr (!is_mma<T>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int M = p.B * p.T_len, H = p.H, N = 3 * H;
    const int tiles = ((H + kWgBM - 1) / kWgBM) * ((N + p.bn - 1) / p.bn);
    const dim3 grid((pad8(N) + 31) / 32, (M + kOperandRows - 1) / kOperandRows);
    scan_dp_kernel<T><<<grid, kOperandThreads, 0, stream>>>(p.dx, p.dhn, static_cast<T*>(p.dp),
                                                            p.dbh, p.partial, p.counters + tiles,
                                                            M, H);
    CUtensorMap ta, tb;
    int err = tensor_map<T>(&ta, p.hs, M, H, pad8(H), 64);
    if (err == 0) err = tensor_map<T>(&tb, p.dp, M, N, pad8(N), 64);
    if (err != 0) return err;
    const WgGemm g = {H, N, M, p.dwh, N, nullptr, p.splits, p.partial, p.counters, p.stages};
    return wgmma_gemm<T>(ta, tb, true, p.bn, g, stream);
  }
}

// The inputs of one (row, unit) at one step, loaded a step ahead; keep =
// 1 - reset, h_prev already multiplied by it.
struct ScanIn {
  float hp[3], x[3], g, m, h_prev, keep;
};

// Reverse scan over one cluster's kRows rows; see the note at the top.
// g (B,T,H) is the cotangent of outs with the final state's folded in.
// Writes dx (B,T,3H) = [dr_pre | dz_pre | dn_pre], dhn (B,T,H) (the third
// block of dh_proj) and dh0 (B,H), all f32.
template <typename T, bool kReset, int kRows>
__global__ void __launch_bounds__(kScanThreads)
gru_scan_bwd_kernel(const T* __restrict__ x_proj, const float* __restrict__ mask,
                    const float* __restrict__ reset, const float* __restrict__ h0,
                    const float* __restrict__ outs, const float* __restrict__ g,
                    const float* __restrict__ hp, const T* __restrict__ wh, float* __restrict__ dx,
                    float* __restrict__ dhn, float* __restrict__ dh0, int B, int T_len, int H,
                    int units, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int H3 = 3 * H, tid = threadIdx.x;
  const int row0 = (blockIdx.x / C) * kRows;
  const int j0 = rank * units, nu = max(0, min(units, H - j0));
  const ScanLayout<T> L(H, units, kRows);
  const int ld = L.ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // (wrows, ld): Wh[j0 + u, :]
  T* dp_s = reinterpret_cast<T*>(smem_raw + L.w);
  float* dh_s = reinterpret_cast<float*>(smem_raw + L.w + L.dp);
  float* part_s = dh_s + kRows * units;   // dh_part of the step
  float* red_s = part_s + kRows * units;  // bf16: (kScanParts, kScanUnits, kRows)
  for (int i = tid; i < L.wrows * ld; i += kScanThreads) {
    const int uu = i / ld, c = i % ld;
    w_s[i] = uu < nu && c < H3 ? wh[(size_t)(j0 + uu) * H3 + c] : from_f<T>(0.f);
  }
  for (int i = tid; i < 2 * kRows * ld; i += kScanThreads) dp_s[i] = from_f<T>(0.f);
  for (int i = tid; i < kRows * units; i += kScanThreads) dh_s[i] = part_s[i] = 0.f;

  // this thread's gate item: (row0 + r, j0 + u), tid = r * units + u
  const int r = tid / units, u = tid % units, row = row0 + r, j = j0 + u;
  const bool item = tid < kRows * units && j < H;
  const bool live = item && row < B;
  auto load = [&](int step, ScanIn& in) {
    const int t = reverse ? step : T_len - 1 - step;
    const size_t n = (size_t)row * T_len + t;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      in.hp[q] = hp[n * H3 + q * H + j];
      in.x[q] = to_f(x_proj[n * H3 + q * H + j]);
    }
    in.g = g[n * H + j];
    in.m = mask[n];
    in.h_prev = prev_state<float>(h0, outs, row, t, T_len, H, j, reverse);
    if constexpr (kReset) {
      in.keep = 1.f - reset[n];
      in.h_prev *= in.keep;
    }
  };
  ScanIn cur{}, nxt{};
  if (live) load(0, cur);
  // dh_s holds the dh_prev of the step processed before, not yet multiplied
  // by that step's keep: its reader applies it
  float keep_prev = 1.f;
  cluster.sync();  // every peer runs, and Wh is in shared memory, before the first push

  const int lane = tid & 31, warp = tid >> 5;
  for (int step = 0; step < T_len; ++step) {
    const int t = reverse ? step : T_len - 1 - step;
    if (live && step + 1 < T_len) load(step + 1, nxt);
    T* dp = dp_s + (step & 1) * kRows * ld;
    if (item) {
      float v[3] = {0.f, 0.f, 0.f};
      if (live) {
        const size_t n = (size_t)row * T_len + t;
        const float hn = cur.hp[2];
        const float rg = sigmoid_f(cur.x[0] + cur.hp[0]);
        const float zg = sigmoid_f(cur.x[1] + cur.hp[1]);
        const float ng = tanhf(cur.x[2] + rg * hn);
        const float dh_total = cur.g + (kReset ? dh_s[tid] * keep_prev : dh_s[tid]);
        const float dhat = cur.m * dh_total;
        const float dz = dhat * (cur.h_prev - ng);
        const float dn = dhat * (1.f - zg);
        const float dn_pre = dn * (1.f - ng * ng);
        const float dr = dn_pre * hn;
        const float dhn_ = dn_pre * rg;
        const float dz_pre = dz * zg * (1.f - zg);
        const float dr_pre = dr * rg * (1.f - rg);
        part_s[tid] = (1.f - cur.m) * dh_total + dhat * zg;
        float* dxr = dx + n * H3;
        dxr[j] = dr_pre;
        dxr[H + j] = dz_pre;
        dxr[2 * H + j] = dn_pre;
        dhn[n * H + j] = dhn_;
        v[0] = dr_pre;
        v[1] = dz_pre;
        v[2] = dhn_;
      }
      // rows past B push zeros, so the product below reads defined values
      for (int p = 0; p < C; ++p) {
        T* peer = cluster.map_shared_rank(dp, p);
#pragma unroll
        for (int q = 0; q < 3; ++q) peer[r * ld + q * H + j] = from_f<T>(v[q]);
      }
    }
    cluster.sync();  // every slice of dh_proj has arrived

    // dh[r, u] = dh_part[r, u] + sum_c dp[r, c] Wh[j0 + u, c]
    if constexpr (is_mma<T>()) {
      // mma: units are the 16 rows of a tile (two tiles), batch rows the 8
      // columns (kRows real); each pair of warps splits K in four
      const int gq = lane >> 2, tq = lane & 3, tile = warp & 1, part = warp >> 1;
      const int ks = pad16(H3) / 16;
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      const T* wa = w_s + (size_t)(tile * 16 + gq) * ld + 2 * tq;
      const T* db = dp + (size_t)gq * ld + 2 * tq;
#pragma unroll 4
      for (int s = part * ks / kScanParts; s < (part + 1) * ks / kScanParts; ++s) {
        const int k = s * 16;
        const uint32_t a[4] = {pair_at(wa + k), pair_at(wa + 8 * ld + k), pair_at(wa + k + 8),
                               pair_at(wa + 8 * ld + k + 8)};
        const uint32_t b0 = gq < kRows ? pair_at(db + k) : 0u;
        const uint32_t b1 = gq < kRows ? pair_at(db + k + 8) : 0u;
        mma16<T>(c4, a, b0, b1);
      }
      if (tq < kRows / 2) {
        float* red = red_s + (size_t)part * kScanUnits * kRows;
        const int u_lo = tile * 16 + gq, u_hi = u_lo + 8;
        red[u_lo * kRows + 2 * tq] = c4[0];
        red[u_lo * kRows + 2 * tq + 1] = c4[1];
        red[u_hi * kRows + 2 * tq] = c4[2];
        red[u_hi * kRows + 2 * tq + 1] = c4[3];
      }
      __syncthreads();
      if (tid < kRows * units) {
        const int rr = tid / units, uu = tid % units;
        float s = part_s[tid];
#pragma unroll
        for (int p = 0; p < kScanParts; ++p) s += red_s[(p * kScanUnits + uu) * kRows + rr];
        dh_s[tid] = s;
      }
    } else {
      float acc[kUnitsPerWarp][kRows] = {};
      for (int c = lane; c < H3; c += 32) {
        float d[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) d[rr] = to_f(dp[rr * ld + c]);
#pragma unroll
        for (int q = 0; q < kUnitsPerWarp; ++q) {
          const int uu = warp + q * kScanWarps;
          if (uu < nu) {
            const float w = to_f(w_s[uu * ld + c]);
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr) acc[q][rr] = fmaf(d[rr], w, acc[q][rr]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUnitsPerWarp; ++q) {
        const int uu = warp + q * kScanWarps;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float s = warp_sum(acc[q][rr]);
          if (lane == 0 && uu < nu) dh_s[rr * units + uu] = part_s[rr * units + uu] + s;
        }
      }
    }
    __syncthreads();  // dh complete; dh_part may be rewritten
    if constexpr (kReset) keep_prev = cur.keep;
    cur = nxt;
  }
  if (live) dh0[(size_t)row * H + j] = kReset ? dh_s[tid] * keep_prev : dh_s[tid];
}

// The backward scan's kernel for a reset stream (or none) and clusters of
// `rows` rows: 4, or 2 in f32 (the instantiations have one function type).
template <typename T>
auto bwd_kernel(bool reset, int rows) {
  if constexpr (!is_mma<T>()) {
    if (rows == 2)
      return reset ? gru_scan_bwd_kernel<T, true, 2> : gru_scan_bwd_kernel<T, false, 2>;
  }
  return reset ? gru_scan_bwd_kernel<T, true, kScanRows>
               : gru_scan_bwd_kernel<T, false, kScanRows>;
}

template <typename T, typename Kernel>
cudaLaunchConfig_t scan_bwd_config(Kernel kernel, int B, int H, int cluster, int units, int rows,
                                   cudaLaunchAttribute* attr, cudaStream_t stream) {
  const size_t smem = ScanLayout<T>(H, units, rows).total;
  allow_cluster(kernel, cluster, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (a) before the scan and (c) after it: on the wgmma engine in bf16 and
// f16, on tile_gemm.cuh in f32.
template <typename T>
int hoist_products(const Products& p, cudaStream_t stream) {
  if constexpr (is_mma<T>()) {
    return launch_hoist<T>(p, stream);
  } else {
    OpArray<ScanHoist<T>, 1> hoist{{{p.B * p.T_len, 3 * p.H, p.H, p.h0, p.outs, p.reset,
                                     static_cast<const T*>(p.wh), p.bh, p.hp, p.T_len, p.H,
                                     p.reverse}}};
    tile_gemm<T>(hoist, stream);
    return 0;
  }
}

template <typename T>
int dwh_products(const Products& p, cudaStream_t stream) {
  if constexpr (is_mma<T>()) {
    return launch_dwh<T>(p, stream);
  } else {
    OpArray<ScanDWh<T>, 1> dw{{{p.H, 3 * p.H, p.B * p.T_len, p.h0, p.outs, p.reset, p.dx,
                                p.dhn, p.dwh, p.dbh, p.T_len, p.H, p.reverse}}};
    tile_gemm<T>(dw, stream, p.splits, p.partial, p.counters);
    return 0;
  }
}

template <typename T>
int launch_bwd(const void* x_proj, const void* mask, const void* g, void* dx, void* dh0,
               void* dhn, const Products& q, int cluster, int units, int rows,
               cudaStream_t stream) {
  const int err = hoist_products<T>(q, stream);
  if (err != 0) return err;
  const auto kernel = bwd_kernel<T>(q.reset != nullptr, rows);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      scan_bwd_config<T>(kernel, q.B, q.H, cluster, units, rows, attr, stream);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x_proj), static_cast<const float*>(mask), q.reset,
      q.h0, q.outs, static_cast<const float*>(g), static_cast<const float*>(q.hp),
      static_cast<const T*>(q.wh), static_cast<float*>(dx), static_cast<float*>(dhn),
      static_cast<float*>(dh0), q.B, q.T_len, q.H, units, q.reverse);
  if (launched != cudaSuccess) return (int)launched;
  return dwh_products<T>(q, stream);
}

// The products' arguments of an entry point: Hs, dP, Wh's copy wp (null:
// none) and (a)'s B operand wb, rows ldb apart.
Products products_of(const void* h0, const void* outs, const void* reset, const void* wh,
                     const void* bh, const void* dx, const void* dhn, void* hp, void* dwh,
                     void* dbh, void* hs, void* dp, void* wp, const void* wb, int ldb,
                     void* partial, void* counters, int B, int T_len, int H, int reverse,
                     int splits, int bn, int stages) {
  Products p = {};
  p.h0 = static_cast<const float*>(h0);
  p.outs = static_cast<const float*>(outs);
  p.reset = static_cast<const float*>(reset);
  p.wh = wh;
  p.bh = static_cast<const float*>(bh);
  p.dx = static_cast<const float*>(dx);
  p.dhn = static_cast<const float*>(dhn);
  p.hp = static_cast<float*>(hp);
  p.dwh = static_cast<float*>(dwh);
  p.dbh = static_cast<float*>(dbh);
  p.hs = hs;
  p.dp = dp;
  p.wp = wp;
  p.wb = wb;
  p.ldb = ldb;
  p.partial = static_cast<float*>(partial);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.T_len = T_len;
  p.H = H;
  p.reverse = reverse;
  p.splits = splits;
  p.bn = bn;
  p.stages = stages;
  return p;
}

// Whether an entry point takes products p: in f32 (tile_gemm.cuh) any; in
// bf16 and f16 (wgmma) those products_valid takes, where (a) reads wb in
// place when wp is null, which needs whole 16-byte rows.
bool products_take(int dtype, const Products& p) {
  return dtype == 0 || (products_valid(p) && p.ldb % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(p.wb) % 16 == 0);
}

// ---------------------------------------------------------------------------
// The tiled plans above 512 units: the backward's reverse scan, then the
// forward; see the notes at the top. The ring, its copies and ldmatrix are
// shared by both.

constexpr int kTiledThreads = 256;
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kTiledWarpTile = 32;             // a warp's rows and units of the step's product
constexpr int kTiledStages = 4;                // stages of the K ring
constexpr int kTiledChunk = 128;               // bytes of one row's K chunk in a stage
constexpr int kTiledPitch = kTiledChunk + 16;  // bytes from one row of a stage to the next
constexpr int kTiledGate = 4;                  // cells whose gate inputs a thread loads at once

// Elements of one row's K chunk, and the row stride of the exchange buffers
// and of laid-out weights: 3H padded to a whole chunk.
template <typename T>
__host__ __device__ constexpr int tiled_kc() {
  return kTiledChunk / (int)sizeof(T);
}
template <typename T>
__host__ __device__ int tiled_ld(int H) {
  return (3 * H + tiled_kc<T>() - 1) / tiled_kc<T>() * tiled_kc<T>();
}

// the backward's "ring" of one stage: the CTA's whole K of the tile's rows
// of round(dh_proj) in shared memory, brought by the TMA unit's bulk
// copies, a row each
constexpr int kBwdWholeK = 1;

// A backward warp's tile of the step's product: 32 rows x 32 units (2 mma
// m-tiles x 4 n-tiles), or on the narrow tiles (16 rows, or 8 or 16 units)
// 16 x 8 (one m16n8k16), so that a CTA of 256 to 1024 cells still gives
// each of its eight warps a K group or a tile of its own.
__host__ __device__ constexpr bool bwd_narrow(int rows, int units) {
  return rows < 32 || units < 32;
}
__host__ __device__ constexpr int bwd_warp_m(bool narrow) { return narrow ? 16 : 32; }
__host__ __device__ constexpr int bwd_warp_n(bool narrow) { return narrow ? 8 : 32; }

// The tiles a CTA may own: rows and units 32, 64 or 128 (at most 8192
// cells) in whole 32 x 32 warp tiles, or the narrow tiles 16 x 16, 16 x 32,
// 32 x 8, 32 x 16, 64 x 8 and 64 x 16 in 16 x 8 warp tiles; the eight warps
// split K in wk = 8 / warp tiles groups (a chunk holds 4 k16 steps of the
// mma, 8 float4 steps of the FMAs), at most 4 in a cluster of 2 or 4 CTAs
// (the sums pass), 8 (32 x 32) without one; a ring of kTiledStages stages
// or kBwdWholeK.
bool valid_tile(int rows, int units, int cluster, int stages) {
  auto side = [](int v) { return v == 32 || v == 64 || v == 128; };
  const bool narrow = bwd_narrow(rows, units);
  const bool tile = narrow ? (rows == 16 && (units == 16 || units == 32)) ||
                                 ((rows == 32 || rows == 64) && (units == 8 || units == 16))
                           : side(rows) && side(units) && rows * units <= 8192;
  if (!tile || !(stages == kTiledStages || stages == kBwdWholeK)) return false;
  const int wk = kTiledWarps / ((rows / bwd_warp_m(narrow)) * (units / bwd_warp_n(narrow)));
  return cluster == 1 || (wk <= 4 && (cluster == 2 || cluster == 4));
}

// Dynamic shared memory of a tiled CTA, the same bytes in every dtype:
// with `resident`, the CTA's rows of Wh over its K chunks (units rows of
// kc_own chunks, w_pitch = kc_own * kTiledChunk + 16 bytes apart) for the
// call; the ring (kTiledStages stages of `rows` rows of round(dh_proj),
// then, without `resident`, `units` rows of Wh, one K chunk each,
// kTiledPitch apart; with kBwdWholeK and `resident`, one stage of the rows
// over all kc_own chunks, a_pitch = w_pitch apart); the warps' partial
// products (wk, rows, units + 4) in f32, which with kBwdWholeK take the
// stage's bytes; the dh carry and dh_part of the own = rows / cluster x
// units cells the CTA owns; with kBwdWholeK the bulk copies' mbarrier.
struct TiledLayout {
  int wk, red_ld, own, w_pitch, a_pitch;
  size_t stage, ring, red, cells, bar, total;
  __host__ __device__ TiledLayout(int rows, int units, int cluster, bool resident, int stages,
                                  int kc_own) {
    const bool whole = stages == kBwdWholeK, narrow = bwd_narrow(rows, units);
    wk = kTiledWarps / ((rows / bwd_warp_m(narrow)) * (units / bwd_warp_n(narrow)));
    red_ld = units + 4;
    own = rows / cluster * units;
    w_pitch = kc_own * kTiledChunk + 16;
    a_pitch = whole ? w_pitch : kTiledPitch;
    stage = whole ? (size_t)rows * a_pitch
                  : (size_t)(rows + (resident ? 0 : units)) * kTiledPitch;
    ring = resident ? (size_t)units * w_pitch : 0;
    const size_t red_bytes = (size_t)wk * rows * red_ld * sizeof(float);
    red = whole ? ring : ring + kTiledStages * stage;
    cells = whole ? ring + (stage > red_bytes ? stage : red_bytes) : red + red_bytes;
    total = cells + 2 * (size_t)own * sizeof(float);
    bar = (total + 15) / 16 * 16;
    if (whole) total = bar + 16;
  }
};

// The most K chunks one CTA of a cluster of `cluster` reduces a step.
template <typename T>
__host__ __device__ int tiled_kc_own(int H, int cluster) {
  const int nk = (3 * H + tiled_kc<T>() - 1) / tiled_kc<T>();
  return (nk + cluster - 1) / cluster;
}

// Arguments of the tiled kernel for one launch over B rows (a chunk of the
// call's rows: the pointers start at its first row).
template <typename T>
struct Tiled {
  const T* x_proj;
  const float *mask, *reset, *h0, *outs, *g, *hp;  // reset null: no reset stream
  // Wh's rows over K = 3H, ldw apart: Wh itself (ldw = 3H), or laid out at
  // ldw = tiled_ld(H), zero past 3H; 16-byte aligned
  const T* w;
  float *dx, *dhn, *dh0;
  // two (B, ldx) buffers of round(dh_proj), ldx = tiled_ld(H), zero past
  // 3H; written and read inside the kernel across CTAs, read through L2
  // (cp.async.cg)
  T* xch;
  long long* probe;  // null, or 1 + 4 * T_len globaltimer stamps of CTA 0
  int B, T_len, H, reverse, rows, units, ldw, ldx;
  int resident;  // Wh's rows held in shared memory for the call
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory (through L2, not L1) into shared memory;
// src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA unit, completing that many bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders the global memory this thread observes through the generic proxy
// (the peers' stores, after a grid barrier) before its async proxy's (the
// TMA unit's) reads that follow
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// four 8 x 8 matrices of 16-bit values from shared memory, row addresses
// given by lanes 8i .. 8i + 7 for matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// two 8 x 8 matrices of 16-bit values, row addresses from lanes 0 .. 15
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Per step: the gate backward of the CTA's own cells into the step's
// exchange buffer, one grid barrier, then the tile's dh_proj @ Wh[units,
// :]^T over the CTA's K chunks, through the ring or the whole-K stage (S =
// kBwdWholeK), and the partial products added across the warps and the
// cluster in a fixed order: dh = (dh_part + product) * keep of the step for
// the own cells. In a cluster a sums pass adds the peers' partials after
// the product; without one the next step's gate backward adds the K
// groups' (in group order) as it reads dh (kFold, which the launch takes
// for clusters of one CTA). kNarrow: the 16 x 8 warp tiles.
template <typename T, int S, bool kNarrow, bool kFold>
__global__ void __launch_bounds__(kTiledThreads, 1) gru_tiled_bwd_kernel(Tiled<T> p) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int B = p.B, T_len = p.T_len, H = p.H, H3 = 3 * H, rows = p.rows, units = p.units;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool whole = S == kBwdWholeK;
  const bool resident = p.resident != 0;
  const TiledLayout L(rows, units, C, resident, S, tiled_kc_own<T>(H, C));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + L.ring;  // after the resident weights, if any
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* dh_s = reinterpret_cast<float*>(smem_raw + L.cells);
  float* part_s = dh_s + L.own;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bar);  // kBwdWholeK's bulk copies
  const int unit_tiles = (H + units - 1) / units, tile = blockIdx.x / C;
  const int r0 = (tile / unit_tiles) * rows, u0 = (tile % unit_tiles) * units;
  const int nu = min(units, H - u0);
  const int ulog = __ffs(units) - 1;  // units is a power of two: own cell i is (i >> ulog, i & (units - 1))
  // the CTA owns the cells of tile rows [or0, or0 + rows / C)
  const int or0 = rank * (rows / C);
  // its K chunks: [c0, c1) of nk
  constexpr int kc = tiled_kc<T>();
  const int nk = (H3 + kc - 1) / kc;
  const int c0 = rank * nk / C, c1 = (rank + 1) * nk / C;
  // this warp's wt_m x wt_n of the tile and its K-split group
  constexpr int wt_m = bwd_warp_m(kNarrow), wt_n = bwd_warp_n(kNarrow);
  constexpr int kAcc = wt_m * wt_n / 32;  // accumulators a thread
  const int wn_n = units / wt_n, wmn = (rows / wt_m) * wn_n;
  const int wk = warp / wmn, wm = (warp % wmn) / wn_n, wn = warp % wn_n;
  const bool reset = p.reset != nullptr;
  // without a cluster the gates add the K groups' partial products
  constexpr bool fold = kFold;
  const size_t xn = (size_t)B * p.ldx;
  // the partial products of the cluster's CTAs, in rank order
  const float* peer_red[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    peer_red[q] = q >= C || q == rank ? red : cluster.map_shared_rank(red, q);
  auto keep_at = [&](int row, int t) {
    return reset ? 1.f - p.reset[(size_t)row * T_len + t] : 1.f;
  };
  auto time_of = [&](int step) { return p.reverse ? step : T_len - 1 - step; };
  // without a cluster, the dh carry of own cell i after the step at time t:
  // its dh_part and the K groups' partial products of that step, added in
  // group order, times the step's keep
  auto folded = [&](int i, int row, int t) {
    const size_t at = (size_t)(or0 + (i >> ulog)) * L.red_ld + (i & (units - 1));
    float s = part_s[i];
    for (int w = 0; w < L.wk; ++w) s += red[at + (size_t)w * rows * L.red_ld];
    return s * keep_at(row, t);
  };

  const size_t gtid = (size_t)blockIdx.x * kTiledThreads + tid;
  for (size_t i = gtid; i < 2 * xn; i += (size_t)gridDim.x * kTiledThreads)
    p.xch[i] = from_f<T>(0.f);
  for (int i = tid; i < L.own; i += kTiledThreads) dh_s[i] = 0.f;
  if (resident) {
    // Wh's rows u0.. over this CTA's K chunks, once for the call
    constexpr int per = 16 / (int)sizeof(T);
    const int pieces = (c1 - c0) * 8;
    for (int i = tid; i < units * pieces; i += kTiledThreads) {
      const int u = i / pieces, e = i % pieces, k = (c0 + e / 8) * kc + (e % 8) * per;
      const bool in = u0 + u < H && k < p.ldw;
      cp_async16(smem_raw + u * L.w_pitch + e * 16, in ? p.w + (size_t)(u0 + u) * p.ldw + k : p.w,
                 in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (whole && tid == 0) {  // kBwdWholeK takes Wh resident
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  grid.sync();

  // the gate backward of own cells i = tid, tid + 256, ... (units fastest),
  // kTiledGate cells' inputs loaded at once: gate_load the inputs of the
  // batch of cells from `base` at `step`, gate_cell the rest of a batch
  struct GateIn {
    float hp[3], x[3], g, m, h_prev, keep;
  };
  auto gate_load = [&](int step, int base, GateIn (&in)[kTiledGate]) {
    const int t = time_of(step);
#pragma unroll
    for (int q = 0; q < kTiledGate; ++q) {
      const int i = base + q * kTiledThreads;
      const int row = r0 + or0 + (i >> ulog), j = u0 + (i & (units - 1));
      if (i >= L.own || row >= B || j >= H) continue;
      const size_t n = (size_t)row * T_len + t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        in[q].hp[k] = p.hp[n * H3 + k * H + j];
        in[q].x[k] = to_f(p.x_proj[n * H3 + k * H + j]);
      }
      in[q].g = p.g[n * H + j];
      in[q].m = p.mask[n];
      in[q].keep = keep_at(row, t);
      in[q].h_prev = prev_state<float>(p.h0, p.outs, row, t, T_len, H, j, p.reverse);
    }
  };
  auto gate_cells = [&](int step, int base, const GateIn (&in)[kTiledGate], T* dp) {
    const int t = time_of(step);
#pragma unroll
    for (int q = 0; q < kTiledGate; ++q) {
      const int i = base + q * kTiledThreads;
      const int row = r0 + or0 + (i >> ulog), j = u0 + (i & (units - 1));
      if (i >= L.own || row >= B || j >= H) continue;
      const size_t n = (size_t)row * T_len + t;
      const float hn = in[q].hp[2];
      const float rg = sigmoid_f(in[q].x[0] + in[q].hp[0]);
      const float zg = sigmoid_f(in[q].x[1] + in[q].hp[1]);
      const float ng = tanhf(in[q].x[2] + rg * hn);
      const float dh = !fold ? dh_s[i] : step == 0 ? 0.f : folded(i, row, time_of(step - 1));
      const float dh_total = in[q].g + dh;
      const float dhat = in[q].m * dh_total;
      const float dn_pre = dhat * (1.f - zg) * (1.f - ng * ng);
      const float dz_pre = dhat * (in[q].h_prev * in[q].keep - ng) * zg * (1.f - zg);
      const float dr_pre = dn_pre * hn * rg * (1.f - rg);
      const float dhn_ = dn_pre * rg;
      part_s[i] = (1.f - in[q].m) * dh_total + dhat * zg;
      float* dxr = p.dx + n * H3;
      dxr[j] = dr_pre;
      dxr[H + j] = dz_pre;
      dxr[2 * H + j] = dn_pre;
      p.dhn[n * H + j] = dhn_;
      T* out = dp + (size_t)row * p.ldx;
      out[j] = from_f<T>(dr_pre);
      out[H + j] = from_f<T>(dz_pre);
      out[2 * H + j] = from_f<T>(dhn_);
    }
  };
  // the first batch's inputs are loaded ahead: for step 0 here, for each
  // later step while the CTA multiplies (narrow tiles, all of whose cells
  // are in the first batch) or adds the step before's partial products
  GateIn first[kTiledGate];
  gate_load(0, tid, first);

  // the next step's gate inputs of the own rows into L2 while the product
  // runs: hp and x_proj (3 gates), g and the previous state, 128-byte lines
  auto prefetch = [&](int step) {
    const int t = time_of(step);
    const bool first = p.reverse ? t == T_len - 1 : t == 0;
    const int tp = p.reverse ? t + 1 : t - 1;
    const int lf = (nu * 4 + 127) / 128 + 1, lt = (nu * (int)sizeof(T) + 127) / 128 + 1;
    const int per_row = 5 * lf + 3 * lt;
    for (int i = tid; i < rows / C * per_row; i += kTiledThreads) {
      const int row = r0 + or0 + i / per_row;
      int e = i % per_row;
      if (row >= B) continue;
      const size_t n = (size_t)row * T_len + t;
      const char* seg;
      int len;
      if (e < 3 * lf) {
        seg = reinterpret_cast<const char*>(p.hp + n * H3 + (e / lf) * H + u0);
        len = nu * 4;
        e %= lf;
      } else if ((e -= 3 * lf) < 3 * lt) {
        seg = reinterpret_cast<const char*>(p.x_proj + n * H3 + (e / lt) * H + u0);
        len = nu * (int)sizeof(T);
        e %= lt;
      } else if ((e -= 3 * lt) < lf) {
        seg = reinterpret_cast<const char*>(p.g + n * H + u0);
        len = nu * 4;
      } else {
        if (first) continue;
        e -= lf;
        seg = reinterpret_cast<const char*>(p.outs + ((size_t)row * T_len + tp) * H + u0);
        len = nu * 4;
      }
      const uintptr_t line = (reinterpret_cast<uintptr_t>(seg) & ~(uintptr_t)127) + 128 * e;
      if (line < reinterpret_cast<uintptr_t>(seg) + len)
        prefetch_l2(reinterpret_cast<const void*>(line));
    }
  };

  // this thread's 16-byte pieces of a K chunk, fixed for the call: piece
  // tid + 256 j of the tile's rows of dp (rows * 8 pieces) and of Wh's rows
  // (units * 8): element offsets from the chunk's first column, whether the
  // row exists, and byte offsets in a stage
  constexpr int kPieces = 128 * 8 / kTiledThreads;
  constexpr int per = 16 / (int)sizeof(T);  // elements of a piece
  size_t a_off[kPieces], w_off[kPieces];
  int a_dst[kPieces], w_dst[kPieces], w_k[kPieces];
  bool a_ok[kPieces], w_ok[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = tid + j * kTiledThreads, rr = i >> 3, e = i & 7;
    a_ok[j] = rr < rows && r0 + rr < B;
    a_off[j] = (size_t)(r0 + rr) * p.ldx + e * per;
    a_dst[j] = rr * kTiledPitch + e * 16;
    w_ok[j] = rr < units && u0 + rr < H;
    w_off[j] = (size_t)(u0 + rr) * p.ldw + e * per;
    w_dst[j] = (rows + rr) * kTiledPitch + e * 16;
    w_k[j] = e * per;
  }
  // K chunk c of the tile's rows of dp, or of Wh's rows, into ring stage
  // `slot`; rows past B or H and columns past Wh's width are zero-filled
  auto load_chunk = [&](const T* dp, int c, int slot, bool weights) {
    unsigned char* st = ring + slot * L.stage;
    const int k0 = c * kc;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      // a narrow tile's rows fill part of a row of pieces: no copy past them
      if (tid + j * kTiledThreads >= (weights ? units : rows) * 8) break;
      if (weights) {
        const bool in = w_ok[j] && k0 + w_k[j] < p.ldw;
        cp_async16(st + w_dst[j], in ? p.w + w_off[j] + k0 : p.w, in ? 16 : 0);
      } else {
        cp_async16(st + a_dst[j], a_ok[j] ? dp + a_off[j] + k0 : p.w, a_ok[j] ? 16 : 0);
      }
    }
  };

  // acc += this warp's wt_m x wt_n of the product of K chunk c (ring stage
  // `slot`, or its place in the whole-K stage) over its K group's steps:
  // bf16 and f16 mma.sync m16n8k16 (acc[(mi * 4 + ni) * 4 + e]: m-tile mi,
  // n-tile ni, accumulator e; narrow: acc[e] of its one tile), f32 FMAs
  // (acc[i * wt_n / 4 + j]: row lane / 4 + 8i, unit lane % 4 + 4j)
  auto product = [&](int c, int slot, float (&acc)[kAcc]) {
    const int a_pitch = whole ? L.a_pitch : kTiledPitch;
    // the K groups take the CTA's k16 steps in turn across its chunks, so
    // that 8 groups (a power of two) share a chunk's 4 steps of the mma
    // over two chunks; with 4 or fewer each takes its own in every chunk
    const int k0 = L.wk > kc / 16 ? (wk - (c - c0) * (kc / 16)) & (L.wk - 1) : wk;
    const unsigned char* a_s =
        (whole ? ring + (size_t)(c - c0) * kTiledChunk : ring + slot * L.stage) +
        (size_t)wm * wt_m * a_pitch;
    // Wh's rows: resident (w_pitch apart, chunk c at its offset) or the stage's
    const int w_pitch = resident ? L.w_pitch : kTiledPitch;
    const unsigned char* w_s =
        resident ? smem_raw + (size_t)wn * wt_n * w_pitch + (c - c0) * kTiledChunk
                 : ring + slot * L.stage + (size_t)(rows + wn * wt_n) * kTiledPitch;
    if constexpr (is_mma<T>() && kNarrow) {
      for (int kk = k0; kk < kc / 16; kk += L.wk) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, a_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * a_pitch + kk * 32 +
                           (lane >> 4) * 16);
        ldmatrix_x2(b, w_s + (lane & 7) * w_pitch + kk * 32 + ((lane >> 3) & 1) * 16);
        float cc[4] = {acc[0], acc[1], acc[2], acc[3]};
        mma16<T>(cc, a, b[0], b[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = cc[e];
      }
    } else if constexpr (is_mma<T>()) {
      for (int kk = k0; kk < kc / 16; kk += L.wk) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], a_s + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * a_pitch +
                                 kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4(b[nj], w_s + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * w_pitch +
                                 kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float* c4 = acc + (mi * 4 + ni) * 4;
            float cc[4] = {c4[0], c4[1], c4[2], c4[3]};
            mma16<T>(cc, a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
            c4[0] = cc[0];
            c4[1] = cc[1];
            c4[2] = cc[2];
            c4[3] = cc[3];
          }
      }
    } else {
      constexpr int ni_m = wt_m / 8, ni_n = wt_n / 4;  // rows and units of a lane
      for (int kq = wk; kq < kc / 4; kq += L.wk) {
        float4 av[ni_m], wv[ni_n];
#pragma unroll
        for (int i = 0; i < ni_m; ++i)
          av[i] = *reinterpret_cast<const float4*>(a_s + ((lane >> 2) + 8 * i) * a_pitch +
                                                   kq * 16);
#pragma unroll
        for (int j = 0; j < ni_n; ++j)
          wv[j] = *reinterpret_cast<const float4*>(w_s + ((lane & 3) + 4 * j) * w_pitch +
                                                   kq * 16);
#pragma unroll
        for (int i = 0; i < ni_m; ++i)
#pragma unroll
          for (int j = 0; j < ni_n; ++j) {
            float v = acc[i * ni_n + j];
            v = fmaf(av[i].x, wv[j].x, v);
            v = fmaf(av[i].y, wv[j].y, v);
            v = fmaf(av[i].z, wv[j].z, v);
            v = fmaf(av[i].w, wv[j].w, v);
            acc[i * ni_n + j] = v;
          }
      }
    }
  };

  // globaltimer stamps of CTA 0 (p.probe, null: none): after the first grid
  // barrier, then a step's gate backward, grid barrier, product and sums
  auto stamp = [&](int i) {
    if (p.probe != nullptr && blockIdx.x == 0 && tid == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      p.probe[i] = (long long)ns;
    }
  };
  stamp(0);
  for (int step = 0; step < T_len; ++step) {
    const int t = time_of(step);
    T* dp = p.xch + (step & 1) * xn;
    // the first stages' weights do not wait for the step: their copies run
    // under the gate backward and the barrier
    for (int s = 0; s < kTiledStages - 1 && !whole && !resident; ++s)
      if (c0 + s < c1) load_chunk(dp, c0 + s, s, true);
    gate_cells(step, tid, first, dp);
    for (int base = tid + kTiledGate * kTiledThreads; base < L.own;
         base += kTiledGate * kTiledThreads) {
      GateIn in[kTiledGate];
      gate_load(step, base, in);
      gate_cells(step, base, in, dp);
    }
    stamp(1 + 4 * step);
    grid.sync();  // every cell's round(dh_proj) is in dp
    stamp(2 + 4 * step);

    float acc[kAcc] = {};
    if constexpr (whole) {
      // thread r: tile row r's K chunks [c0, c1) in one bulk copy (rows past
      // B are not copied: their products are never read); thread 0's
      // arrival holds the phase open until it has added the bytes to expect
      const int bytes = (c1 - c0) * kTiledChunk, n = min(rows, B - r0);
      if (tid < n) {
        fence_proxy_async_global();  // the peers' round(dh_proj), before the grid barrier, first
        bulk_load(ring + (size_t)tid * L.a_pitch, dp + (size_t)(r0 + tid) * p.ldx + c0 * kc,
                  bytes, bar);
      }
      if (tid == 0) mbar_expect_tx(bar, n * bytes);
      if (step + 1 < T_len) {
        if constexpr (kNarrow)
          gate_load(step + 1, tid, first);
        else
          prefetch(step + 1);
      }
      mbar_wait(bar, step & 1);
      for (int c = c0; c < c1; ++c) product(c, 0, acc);
      __syncthreads();  // every warp is done with the stage, whose bytes red takes
    } else {
      if (step + 1 < T_len) {
        if constexpr (kNarrow)
          gate_load(step + 1, tid, first);
        else
          prefetch(step + 1);
      }
      for (int s = 0; s < kTiledStages - 1; ++s) {
        if (c0 + s < c1) load_chunk(dp, c0 + s, s, false);
        cp_async_commit();
      }
      for (int c = c0; c < c1; ++c) {
        cp_async_wait<kTiledStages - 2>();
        __syncthreads();  // chunk c is in its stage; every warp is done with chunk c - 1's
        const int next = c + kTiledStages - 1;
        if (next < c1) {
          if (!resident) load_chunk(dp, next, (next - c0) % kTiledStages, true);
          load_chunk(dp, next, (next - c0) % kTiledStages, false);
        }
        cp_async_commit();
        product(c, (c - c0) % kTiledStages, acc);
      }
      cp_async_wait<0>();
    }
    stamp(3 + 4 * step);

    // the warp's partial products into red[wk]
    float* rb = red + (size_t)wk * rows * L.red_ld;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      int r, u;
      if constexpr (is_mma<T>() && kNarrow) {
        r = wm * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
        u = wn * 8 + 2 * (lane & 3) + (e & 1);
      } else if constexpr (is_mma<T>()) {
        r = wm * 32 + (e >> 4) * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
        u = wn * 32 + ((e >> 2) & 3) * 8 + 2 * (lane & 3) + (e & 1);
      } else {
        constexpr int ni_n = wt_n / 4;
        r = wm * wt_m + (lane >> 2) + 8 * (e / ni_n);
        u = wn * wt_n + (lane & 3) + 4 * (e % ni_n);
      }
      rb[r * L.red_ld + u] = acc[e];
    }
    // every partial product of the cluster is in its CTA's red (a cluster
    // of one CTA takes a CTA barrier on the whole-K stage; the ring's
    // kernels keep the cluster barrier)
    if (!whole || C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (!kNarrow && step + 1 < T_len) gate_load(step + 1, tid, first);
    if (!fold) {
      // the own cells' sums over the cluster's CTAs and the K groups, in
      // that order, each cell's partials loaded before its adds
      for (int i = tid; i < L.own; i += kTiledThreads) {
        const int tr = or0 + (i >> ulog), row = r0 + tr;
        const size_t at = (size_t)tr * L.red_ld + (i & (units - 1));
        float v[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (q < C && w < L.wk) v[q][w] = peer_red[q][at + (size_t)w * rows * L.red_ld];
        float s = part_s[i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (q < C && w < L.wk) s += v[q][w];
        dh_s[i] = row < B ? s * keep_at(row, t) : 0.f;
      }
    }
    stamp(4 + 4 * step);
  }
  for (int i = tid; i < L.own; i += kTiledThreads) {
    const int row = r0 + or0 + (i >> ulog), j = u0 + (i & (units - 1));
    if (row < B && j < H)
      p.dh0[(size_t)row * H + j] = fold ? folded(i, row, time_of(T_len - 1)) : dh_s[i];
  }
  if (C > 1) cluster.sync();  // no CTA leaves while a peer reads its partial products
}

cudaLaunchConfig_t tiled_config(int grid, int cluster, size_t smem, cudaLaunchAttribute* attr,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kTiledThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // cooperative: the launch is refused (cudaErrorCooperativeLaunchTooLarge)
  // unless every CTA of the grid is resident at once
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

// One cooperative, clustered launch of `kernel` (either pass's tiled
// kernel, with `smem` bytes of dynamic shared memory) a chunk of `rows *
// row_tiles` batch rows, the chunks in order on the stream. q holds the
// whole call's pointers; each chunk's are offset to its first row b0 here
// (x_proj, mask, reset, h0, outs; the probe to the first chunk only) and by
// `offset(p, q, b0, bt)` (bt = b0 * T) for the pass's own.
template <typename P, typename Kernel, typename Offset>
int launch_chunks(Kernel kernel, P q, size_t smem, int cluster, int row_tiles,
                  cudaStream_t stream, Offset offset) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int B = q.B, H = q.H, chunk = q.rows * row_tiles;
  const int unit_tiles = (H + q.units - 1) / q.units;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    P p = q;
    const size_t bt = (size_t)b0 * q.T_len;
    p.B = min(chunk, B - b0);
    p.x_proj = q.x_proj + bt * 3 * H;
    p.mask = q.mask + bt;
    p.reset = q.reset != nullptr ? q.reset + bt : nullptr;
    p.h0 = q.h0 + (size_t)b0 * H;
    p.outs = q.outs + bt * H;
    p.probe = b0 == 0 ? q.probe : nullptr;
    offset(p, q, b0, bt);
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = tiled_config(
        (p.B + q.rows - 1) / q.rows * unit_tiles * cluster, cluster, smem, attr, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The backward tiled kernel with a ring of kTiledStages stages or
// kBwdWholeK, on the narrow warp tiles or the 32 x 32 ones, folding the K
// groups' sums into the gates for clusters of one CTA.
template <typename T, int S, bool kNarrow>
auto tiled_bwd_kernel_of(int cluster) {
  return cluster == 1 ? gru_tiled_bwd_kernel<T, S, kNarrow, true>
                      : gru_tiled_bwd_kernel<T, S, kNarrow, false>;
}
template <typename T>
auto tiled_bwd_kernel(int stages, int rows, int units, int cluster) {
  const bool narrow = bwd_narrow(rows, units);
  return stages == kBwdWholeK
             ? (narrow ? tiled_bwd_kernel_of<T, kBwdWholeK, true>(cluster)
                       : tiled_bwd_kernel_of<T, kBwdWholeK, false>(cluster))
         : narrow ? tiled_bwd_kernel_of<T, kTiledStages, true>(cluster)
                  : tiled_bwd_kernel_of<T, kTiledStages, false>(cluster);
}

template <typename T>
size_t tiled_bwd_smem(int H, int rows, int units, int cluster, bool resident, int stages) {
  return TiledLayout(rows, units, cluster, resident, stages, tiled_kc_own<T>(H, cluster)).total;
}

template <typename T>
int launch_tiled(Tiled<T> q, int cluster, int row_tiles, int stages, cudaStream_t stream) {
  const size_t smem = tiled_bwd_smem<T>(q.H, q.rows, q.units, cluster, q.resident != 0, stages);
  const size_t H = q.H;
  return launch_chunks(tiled_bwd_kernel<T>(stages, q.rows, q.units, cluster), q, smem, cluster,
                       row_tiles, stream, [H](Tiled<T>& p, const Tiled<T>& q, int b0, size_t bt) {
                         p.g = q.g + bt * H;
                         p.hp = q.hp + bt * 3 * H;
                         p.dx = q.dx + bt * 3 * H;
                         p.dhn = q.dhn + bt * H;
                         p.dh0 = q.dh0 + b0 * H;
                       });
}

// ---------------------------------------------------------------------------
// The forward's tiled plan.

constexpr int kTiledFwdWarpN = 48;  // a forward warp's columns of the tile: 6 mma n-tiles
// a forward "ring" of one stage: the CTA's whole K of the tile's state rows
// in shared memory, brought by the TMA unit's bulk copies, a row each
constexpr int kFwdWholeK = 1;

// A forward warp's tile of the step's product: 32 rows x 48 columns (2 mma
// m-tiles x 6 n-tiles), or at 8 units, whose tile N is 24 columns, 16 rows
// x 24 (1 x 3), so that a tile of 32 rows still leaves each warp a K group
// of its own.
__host__ __device__ constexpr int fwd_warp_m(int units) { return units == 8 ? 16 : 32; }
__host__ __device__ constexpr int fwd_warp_n(int units) { return units == 8 ? 24 : 48; }

// The tiles a forward CTA may own: rows 32, 64 or 128 and units 8, 16, 32,
// 64 or 128 in 2, 4 or 8 warp tiles, the eight warps splitting K in wk = 8
// / warp tiles <= 4 groups (a chunk holds 4 k16 steps of the mma, 8 float4
// steps of the FMAs); clusters of 1, 2 or 4 CTAs; rings of 4 or 2 stages,
// or kFwdWholeK, which tiles of 8 units take.
bool valid_fwd_tile(int rows, int units, int cluster, int stages) {
  auto side = [](int v) { return v == 32 || v == 64 || v == 128; };
  const int warp_tiles = (rows / fwd_warp_m(units)) * (3 * units / fwd_warp_n(units));
  return side(rows) && (units == 8 || units == 16 || side(units)) &&
         (warp_tiles == 2 || warp_tiles == 4 || warp_tiles == 8) &&
         (cluster == 1 || cluster == 2 || cluster == 4) &&
         (stages == kFwdWholeK || (units != 8 && (stages == 2 || stages == 4)));
}

// Dynamic shared memory of a forward tiled CTA of `rows` x `units` cells in
// T: with `resident`, the tile's columns of Wh over the CTA's kc_own K
// chunks (kc_own * kc k-rows of 3 units elements, w_pitch bytes apart) for
// the call; the ring (`stages` stages of `rows` K-chunk rows of round(h),
// a_pitch = kTiledPitch apart, then, without `resident`, kc k-rows of Wh's
// columns, w_pitch apart; with kFwdWholeK and `resident`, one stage of the
// rows over all kc_own chunks, a_pitch = kc_own * kTiledChunk + 16 apart);
// the warps' partial products (wk, rows, 3 units + 4) in f32, which with
// `resident` take the ring's bytes; the units' biases (3 units) and the
// f32 carry of the own = rows / cluster x units cells; with kFwdWholeK the
// bulk copies' mbarrier.
template <typename T>
struct TiledFwdLayout {
  int wk, red_ld, own, w_pitch, a_pitch;
  size_t stage, ring, red, bias, bar, total;
  __host__ __device__ TiledFwdLayout(int rows, int units, int cluster, bool resident, int stages,
                                     int kc_own) {
    const bool whole = stages == kFwdWholeK;
    wk = kTiledWarps / ((rows / fwd_warp_m(units)) * (3 * units / fwd_warp_n(units)));
    red_ld = 3 * units + 4;
    own = rows / cluster * units;
    w_pitch = 3 * units * (int)sizeof(T) + 16;
    a_pitch = whole ? kc_own * kTiledChunk + 16 : kTiledPitch;
    stage = (size_t)rows * a_pitch + (resident ? 0 : (size_t)tiled_kc<T>() * w_pitch);
    ring = resident ? (size_t)kc_own * tiled_kc<T>() * w_pitch : 0;
    const size_t ring_bytes = stages * stage;
    const size_t red_bytes = (size_t)wk * rows * red_ld * sizeof(float);
    red = resident ? ring : ring + ring_bytes;
    bias = resident ? ring + (ring_bytes > red_bytes ? ring_bytes : red_bytes) : red + red_bytes;
    total = bias + (size_t)(3 * units + own) * sizeof(float);
    bar = (total + 15) / 16 * 16;
    if (whole) total = bar + 16;
  }
};

template <typename T>
size_t tiled_fwd_smem(int H, int rows, int units, int cluster, bool resident, int stages) {
  const int nk = (H + tiled_kc<T>() - 1) / tiled_kc<T>();
  return TiledFwdLayout<T>(rows, units, cluster, resident, stages, (nk + cluster - 1) / cluster)
      .total;
}

// Arguments of the forward tiled kernel for one launch over B rows (a chunk
// of the call's rows: the pointers start at its first row).
template <typename T>
struct TiledFwd {
  const T* x_proj;
  const float *mask, *reset, *h0, *bh;  // reset null: no reset stream
  // Wh's k-rows, ldw = 3 ldg apart, gate g's columns from g * ldg: Wh
  // itself (ldg = H) or padded (ldg = H rounded up to a 16-byte piece, zero
  // past H); 16-byte aligned
  const T* w;
  float *outs, *final_h;
  // two (B, ldx) buffers of round(h), ldx = H padded to a K chunk, zero
  // past H; written and read inside the kernel across CTAs, read through
  // L2 (cp.async.cg)
  T* xch;
  long long* probe;  // null, or 1 + 4 * T_len globaltimer stamps of CTA 0
  int B, T_len, H, reverse, rows, units, ldw, ldg, ldx;
  int resident;  // Wh's columns held in shared memory for the call
};

// ldmatrix_x4 transposed: lane l receives elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of each 8 x 8 matrix whose rows it was given, the
// mma's B fragment from a (K, N) row-major operand
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// the same for two 8 x 8 matrices, row addresses from lanes 0 .. 15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The %globaltimer (ns) of CTA 0's thread 0 into probe[i] (null: none).
__device__ __forceinline__ void globaltimer_stamp(long long* probe, int i) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    probe[i] = (long long)ns;
  }
}

// Per step: the tile's round(h) @ Wh[:, its r|z|n columns] over the CTA's K
// chunks through the ring, the partial products added across the cluster
// and the K groups in a fixed order, the gates of the own cells from those
// sums, the biases and the carry, their h' into outs and (times the next
// step's keep) the other exchange buffer, then one grid barrier.
template <typename T, int S, bool kNarrow>
__global__ void __launch_bounds__(kTiledThreads, 1) gru_tiled_fwd_kernel(TiledFwd<T> p) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int B = p.B, T_len = p.T_len, H = p.H, H3 = 3 * H, rows = p.rows, units = p.units;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool resident = p.resident != 0;
  constexpr bool whole = S == kFwdWholeK;
  constexpr int kc = tiled_kc<T>();
  constexpr int per = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  // the CTA's K chunks: [c0, c1) of nk
  const int nk = (H + kc - 1) / kc;
  const int c0 = rank * nk / C, c1 = (rank + 1) * nk / C;
  const TiledFwdLayout<T> L(rows, units, C, resident, S, (nk + C - 1) / C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + L.ring;  // after the resident weights, if any
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* bias_s = reinterpret_cast<float*>(smem_raw + L.bias);
  float* carry = bias_s + 3 * units;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bar);  // kFwdWholeK's bulk copies
  const int unit_tiles = (H + units - 1) / units, tile = blockIdx.x / C;
  const int r0 = (tile / unit_tiles) * rows, u0 = (tile % unit_tiles) * units;
  const int nu = min(units, H - u0);
  const int ulog = __ffs(units) - 1;  // units is a power of two: own cell i is (i >> ulog, i & (units - 1))
  // the CTA owns the cells of tile rows [or0, or0 + rows / C)
  const int or0 = rank * (rows / C);
  // this warp's wt_m x wt_n of the tile (mi_n x ni_n mma tiles) and its
  // K-split group (kNarrow: units is 8)
  constexpr int wt_m = fwd_warp_m(kNarrow ? 8 : 16), wt_n = fwd_warp_n(kNarrow ? 8 : 16);
  constexpr int mi_n = wt_m / 16, ni_n = wt_n / 8;
  const int wn_n = 3 * units / wt_n, wmn = (rows / wt_m) * wn_n;
  const int wk = warp / wmn, wm = (warp % wmn) / wn_n, wn = warp % wn_n;
  const bool reset = p.reset != nullptr;
  const size_t xn = (size_t)B * p.ldx;
  // the partial products of the cluster's CTAs, in rank order
  const float* peer_red[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    peer_red[q] = q >= C || q == rank ? red : cluster.map_shared_rank(red, q);
  auto keep_at = [&](int row, int t) {
    return reset ? 1.f - p.reset[(size_t)row * T_len + t] : 1.f;
  };
  auto time_of = [&](int step) { return p.reverse ? T_len - 1 - step : step; };

  // one 16-byte piece of Wh's k-row k: piece e of the tile's 3 units
  // columns (gate e / ppg), zero past H rows and units
  const int ppg = units * (int)sizeof(T) / 16, ppr = 3 * ppg;
  auto w_piece = [&](unsigned char* dst, int k, int e) {
    const int g = e / ppg, u = (e - g * ppg) * per;
    const bool in = k < H && u0 + u < H;
    cp_async16(dst, in ? p.w + (size_t)k * p.ldw + (size_t)g * p.ldg + u0 + u : p.w, in ? 16 : 0);
  };
  // K chunk c of Wh's k-rows into ring stage `slot`: piece i is gate i /
  // (kc ppg), k-row (i / ppg) % kc, piece i % ppg of the gate's units (ppg
  // and kc powers of two)
  const int pg_log = __ffs(ppg) - 1;
  constexpr int kc_log = kc == 64 ? 6 : 5;
  static_assert(kc == 1 << kc_log, "a K chunk of 64 or 32 elements");
  auto load_w = [&](int c, int slot) {
    unsigned char* st = ring + slot * L.stage + (size_t)rows * kTiledPitch;
    for (int i = tid; i < 3 * kc * ppg; i += kTiledThreads) {
      const int g = i >> (kc_log + pg_log), kr = (i >> pg_log) & (kc - 1);
      const int e = g * ppg + (i & (ppg - 1)), u = (i & (ppg - 1)) * per, k = c * kc + kr;
      const bool in = k < H && u0 + u < H;
      cp_async16(st + kr * L.w_pitch + e * 16,
                 in ? p.w + (size_t)k * p.ldw + (size_t)g * p.ldg + u0 + u : p.w, in ? 16 : 0);
    }
  };

  // buffer 0: round(h0 * keep of the first step), zero past H; buffer 1
  // zero (its columns past H stay so)
  const int t_first = time_of(0);
  const size_t gtid = (size_t)blockIdx.x * kTiledThreads + tid;
  for (size_t i = gtid; i < 2 * xn; i += (size_t)gridDim.x * kTiledThreads) {
    const int k = (int)(i % p.ldx), row = (int)((i / p.ldx) % B);
    const float v = i < xn && k < H ? p.h0[(size_t)row * H + k] * keep_at(row, t_first) : 0.f;
    p.xch[i] = from_f<T>(v);
  }
  for (int i = tid; i < 3 * units; i += kTiledThreads) {
    const int g = i / units, u = i - g * units;
    bias_s[i] = u0 + u < H ? p.bh[g * H + u0 + u] : 0.f;
  }
  for (int i = tid; i < L.own; i += kTiledThreads) {
    const int row = r0 + or0 + (i >> ulog), j = u0 + (i & (units - 1));
    carry[i] = row < B && j < H ? p.h0[(size_t)row * H + j] : 0.f;
  }
  if (resident) {
    // the tile's columns of Wh over this CTA's K chunks, once for the call
    for (int i = tid; i < (c1 - c0) * kc * ppr; i += kTiledThreads) {
      const int kr = i / ppr, e = i - kr * ppr;
      w_piece(smem_raw + (size_t)kr * L.w_pitch + e * 16, c0 * kc + kr, e);
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (whole && tid == 0) {  // kFwdWholeK takes Wh resident
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else {
    // step 0's first stages of weights, committed with its first state chunk
    for (int s = 0; s < S - 1; ++s)
      if (c0 + s < c1) load_w(c0 + s, s);
  }
  grid.sync();

  // the gate inputs of own cells i = base, base + 256, ... (kTiledGate at
  // once), as loaded (nothing waits for them until the gates): x_proj, the
  // mask, and the resets of the step and the next (whose keep scales the h'
  // the next step's product reads)
  struct GateIn {
    T x[3];
    float m, r, r_next;
  };
  auto gate_load = [&](int step, int base, GateIn (&in)[kTiledGate]) {
    const int t = time_of(step), t_next = time_of(step + 1);
#pragma unroll
    for (int q = 0; q < kTiledGate; ++q) {
      const int i = base + q * kTiledThreads;
      const int row = r0 + or0 + (i >> ulog), j = u0 + (i & (units - 1));
      if (i >= L.own || row >= B || j >= H) continue;
      const size_t n = (size_t)row * T_len + t;
#pragma unroll
      for (int g = 0; g < 3; ++g) in[q].x[g] = p.x_proj[n * H3 + g * H + j];
      in[q].m = p.mask[n];
      in[q].r = reset ? p.reset[n] : 0.f;
      in[q].r_next = reset && step + 1 < T_len ? p.reset[(size_t)row * T_len + t_next] : 0.f;
    }
  };
  // the gates of a batch of own cells from their sums (group 0 of red at
  // the own rows; with `fold`, a CTA without a cluster whose warps split K,
  // the K groups' partial products, added here in group order), the biases
  // and the carry
  auto gate_cells = [&](auto fold, int step, int base, const GateIn (&in)[kTiledGate],
                        T* nxt) {
    const int t = time_of(step);
#pragma unroll
    for (int q = 0; q < kTiledGate; ++q) {
      const int i = base + q * kTiledThreads;
      const int tr = or0 + (i >> ulog), u = i & (units - 1), row = r0 + tr, j = u0 + u;
      if (i >= L.own || row >= B || j >= H) continue;
      const float* s = red + (size_t)tr * L.red_ld + u;
      float sum[3] = {s[0], s[units], s[2 * units]};
      if constexpr (decltype(fold)::value)
        for (int w = 1; w < L.wk; ++w)
#pragma unroll
          for (int g = 0; g < 3; ++g) sum[g] += s[(size_t)w * rows * L.red_ld + g * units];
      const float hp[3] = {sum[0] + bias_s[u], sum[1] + bias_s[units + u],
                           sum[2] + bias_s[2 * units + u]};
      const float x[3] = {to_f(in[q].x[0]), to_f(in[q].x[1]), to_f(in[q].x[2])};
      float h = carry[i] * (1.f - in[q].r);  // the carry the product read: zero at a segment start
      h = in[q].m > 0.f ? gru_cell(x, hp, h) : h;
      carry[i] = h;
      p.outs[((size_t)row * T_len + t) * H + j] = h;
      if (step + 1 < T_len)
        nxt[(size_t)row * p.ldx + j] = from_f<T>(h * (1.f - in[q].r_next));
      else
        p.final_h[(size_t)row * H + j] = h;
    }
  };

  // this thread's 16-byte pieces of a K chunk of the tile's state rows,
  // fixed for the call: piece tid + 256 j of rows * 8
  constexpr int kPieces = 128 * 8 / kTiledThreads;
  size_t a_off[kPieces];
  int a_dst[kPieces];
  bool a_ok[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = tid + j * kTiledThreads, rr = i >> 3, e = i & 7;
    a_ok[j] = rr < rows && r0 + rr < B;
    a_off[j] = (size_t)(r0 + rr) * p.ldx + e * per;
    a_dst[j] = rr * kTiledPitch + e * 16;
  }
  // K chunk c of the tile's rows of the state h into ring stage `slot`;
  // rows past B are zero-filled
  auto load_h = [&](const T* h, int c, int slot) {
    unsigned char* st = ring + slot * L.stage;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      if (j * kTiledThreads >= rows * 8) break;
      cp_async16(st + a_dst[j], a_ok[j] ? h + a_off[j] + c * kc : p.w, a_ok[j] ? 16 : 0);
    }
  };

  // acc += this warp's wt_m x wt_n of the stage's product over its K
  // group's steps: bf16 and f16 mma.sync m16n8k16 (acc[(mi * 6 + ni) * 4 +
  // e]: m-tile mi < mi_n, n-tile ni < ni_n, accumulator e; Wh's k-rows
  // through ldmatrix.trans), f32 FMAs (acc[i * 12 + j]: row lane / 4 + 8i,
  // column wt_n / 4 (lane % 4) + j, i < wt_m / 8, j < wt_n / 4)
  // (K chunk c of the state rows at a, a_pitch apart)
  auto product = [&](int c, const unsigned char* a, int slot, float (&acc)[48]) {
    const int a_pitch = whole ? L.a_pitch : kTiledPitch;  // a constant in a ring's kernels
    const unsigned char* a_s = a + (size_t)wm * wt_m * a_pitch;
    const unsigned char* w_s =
        (resident ? smem_raw + (size_t)(c - c0) * kc * L.w_pitch
                  : ring + slot * L.stage + (size_t)rows * kTiledPitch) +
        wn * wt_n * (int)sizeof(T);
    if constexpr (is_mma<T>()) {
      for (int kk = wk; kk < kc / 16; kk += L.wk) {
        uint32_t a[2][4], b[3][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (mi < mi_n)
            ldmatrix_x4(a[mi], a_s + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * a_pitch +
                                   kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) {
          const unsigned char* at = w_s + (size_t)(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                              L.w_pitch + (nj * 16 + (lane >> 4) * 8) * 2;
          if (2 * nj + 1 < ni_n)
            ldmatrix_x4_trans(b[nj], at);
          else if (2 * nj < ni_n)  // the last of an odd count of n-tiles
            ldmatrix_x2_trans(b[nj], at);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 6; ++ni) {
            if (mi >= mi_n || ni >= ni_n) continue;
            float* c4 = acc + (mi * 6 + ni) * 4;
            float cc[4] = {c4[0], c4[1], c4[2], c4[3]};
            mma16<T>(cc, a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
            c4[0] = cc[0];
            c4[1] = cc[1];
            c4[2] = cc[2];
            c4[3] = cc[3];
          }
      }
    } else if constexpr (kNarrow) {  // 16 x 24: rows lane / 4 + 8i, columns 6 (lane % 4) + j
      for (int kq = wk; kq < kc / 4; kq += L.wk) {
        float4 av[2];
        float2 wv[4][3];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          av[i] = *reinterpret_cast<const float4*>(a_s + ((lane >> 2) + 8 * i) * a_pitch +
                                                   kq * 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            wv[kk][j] = *reinterpret_cast<const float2*>(
                w_s + (size_t)(kq * 4 + kk) * L.w_pitch + ((lane & 3) * 6 + 2 * j) * 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              float* c2 = acc + i * 12 + j * 2;
              c2[0] = fmaf(a4[kk], wv[kk][j].x, c2[0]);
              c2[1] = fmaf(a4[kk], wv[kk][j].y, c2[1]);
            }
        }
      }
    } else {
      for (int kq = wk; kq < kc / 4; kq += L.wk) {
        float4 av[4], wv[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(a_s + ((lane >> 2) + 8 * i) * a_pitch +
                                                   kq * 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            wv[kk][j] = *reinterpret_cast<const float4*>(
                w_s + (size_t)(kq * 4 + kk) * L.w_pitch + ((lane & 3) * 12 + 4 * j) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              float* c4 = acc + i * 12 + j * 4;
              c4[0] = fmaf(a4[kk], wv[kk][j].x, c4[0]);
              c4[1] = fmaf(a4[kk], wv[kk][j].y, c4[1]);
              c4[2] = fmaf(a4[kk], wv[kk][j].z, c4[2]);
              c4[3] = fmaf(a4[kk], wv[kk][j].w, c4[3]);
            }
        }
      }
    }
  };

  globaltimer_stamp(p.probe, 0);
  for (int step = 0; step < T_len; ++step) {
    const T* cur = p.xch + (step & 1) * xn;
    T* nxt = p.xch + ((step + 1) & 1) * xn;
    if constexpr (whole) {
      // thread r: tile row r's K chunks [c0, c1) in one bulk copy (rows past
      // B are not copied: their products are never read); thread 0's
      // arrival holds the phase open until it has added the bytes to expect
      const int bytes = (c1 - c0) * kTiledChunk, n = min(rows, B - r0);
      if (tid < n) {
        fence_proxy_async_global();  // the peers' round(h), before the grid barrier, first
        bulk_load(ring + (size_t)tid * L.a_pitch, cur + (size_t)(r0 + tid) * p.ldx + c0 * kc,
                  bytes, bar);
      }
      if (tid == 0) mbar_expect_tx(bar, n * bytes);
    } else {
      for (int s = 0; s < S - 1; ++s) {
        if (c0 + s < c1) load_h(cur, c0 + s, s);
        cp_async_commit();
      }
    }
    // the first batch's gate inputs load under the product
    GateIn first[kTiledGate];
    gate_load(step, tid, first);
    float acc[48] = {};
    if constexpr (whole) {
      mbar_wait(bar, step & 1);
      for (int c = c0; c < c1; ++c) product(c, ring + (size_t)(c - c0) * kTiledChunk, 0, acc);
    } else {
      for (int c = c0; c < c1; ++c) {
        cp_async_wait<S - 2>();
        __syncthreads();  // chunk c is in its stage; every warp is done with chunk c - 1's
        const int next = c + S - 1;
        if (next < c1) {
          if (!resident) load_w(next, (next - c0) % S);
          load_h(cur, next, (next - c0) % S);
        }
        cp_async_commit();
        product(c, ring + (size_t)((c - c0) % S) * L.stage, (c - c0) % S, acc);
      }
      cp_async_wait<0>();
    }
    __syncthreads();  // every warp is done with the ring, which red may share
    // the next step's first stages of weights do not wait for its state:
    // their copies run under the sums, the gates and the barrier
    if (!resident && step + 1 < T_len)
      for (int s = 0; s < S - 1; ++s)
        if (c0 + s < c1) load_w(c0 + s, s);
    globaltimer_stamp(p.probe, 1 + 4 * step);

    // the warp's partial products into red[wk]; in a cluster, then the own
    // cells' sums over the cluster's CTAs and the K groups, in that fixed
    // order, into group 0 of this CTA's red (a peer reads only the rows it
    // owns); without one the gates add the K groups
    float* rb = red + (size_t)wk * rows * L.red_ld;
#pragma unroll
    for (int e = 0; e < 48; ++e) {
      int r, n;
      if constexpr (is_mma<T>()) {
        const int mi = (e >> 2) / 6, ni = (e >> 2) % 6;
        if (mi >= mi_n || ni >= ni_n) continue;
        r = wm * wt_m + mi * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
        n = wn * wt_n + ni * 8 + 2 * (lane & 3) + (e & 1);
      } else {
        const int i = e / 12, j = e % 12;
        if (8 * i >= wt_m || 4 * j >= wt_n) continue;
        r = wm * wt_m + (lane >> 2) + 8 * i;
        n = wn * wt_n + (lane & 3) * (wt_n / 4) + j;
      }
      rb[r * L.red_ld + n] = acc[e];
    }
    // every partial product of the cluster is in its CTA's red (a
    // cluster of one CTA takes a CTA barrier where the step is short, on
    // the whole-K stage; a ring's kernels ran faster with the cluster
    // barrier alone)
    if (!whole || C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (C > 1) {
      // four units of an own row a thread, 16 bytes a partial (from the
      // peers' shared memory), a gate's adds before its store
      for (int i = tid; i < L.own / 4; i += kTiledThreads) {
        const size_t at = (size_t)(or0 + (i >> (ulog - 2))) * L.red_ld + (i & (units / 4 - 1)) * 4;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const size_t ag = at + (size_t)g * units;
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              if (q < C && w < L.wk) {
                const float4 v = *reinterpret_cast<const float4*>(
                    peer_red[q] + ag + (size_t)w * rows * L.red_ld);
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
              }
          *reinterpret_cast<float4*>(red + ag) = s;
        }
      }
      __syncthreads();  // another thread's gates read each sum
    }
    globaltimer_stamp(p.probe, 2 + 4 * step);

    auto gates = [&](auto fold) {
      gate_cells(fold, step, tid, first, nxt);
      for (int base = tid + kTiledGate * kTiledThreads; base < L.own;
           base += kTiledGate * kTiledThreads) {
        GateIn in[kTiledGate];
        gate_load(step, base, in);
        gate_cells(fold, step, base, in, nxt);
      }
    };
    if (C == 1 && L.wk > 1)
      gates(std::true_type{});
    else
      gates(std::false_type{});
    globaltimer_stamp(p.probe, 3 + 4 * step);
    if (step + 1 < T_len) grid.sync();  // every cell's round(h') is in nxt
    globaltimer_stamp(p.probe, 4 + 4 * step);
  }
  if (!whole || C > 1) cluster.sync();  // no CTA leaves while a peer reads its partial products
}

// The forward tiled kernel with a ring of `stages` stages (4 or 2), or
// kFwdWholeK (the one that tiles of 8 units take).
template <typename T>
auto tiled_fwd_kernel(int stages, int units) {
  return stages == kFwdWholeK ? (units == 8 ? gru_tiled_fwd_kernel<T, kFwdWholeK, true>
                                            : gru_tiled_fwd_kernel<T, kFwdWholeK, false>)
         : stages == 2        ? gru_tiled_fwd_kernel<T, 2, false>
                              : gru_tiled_fwd_kernel<T, 4, false>;
}

template <typename T>
int launch_tiled_fwd(TiledFwd<T> q, int cluster, int row_tiles, int stages, cudaStream_t stream) {
  const size_t smem = tiled_fwd_smem<T>(q.H, q.rows, q.units, cluster, q.resident != 0, stages);
  const size_t H = q.H;
  return launch_chunks(tiled_fwd_kernel<T>(stages, q.units), q, smem, cluster, row_tiles, stream,
                       [H](TiledFwd<T>& p, const TiledFwd<T>& q, int b0, size_t) {
                         p.final_h = q.final_h + b0 * H;
                       });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x_proj and Wh); any
// other code is cudaErrorInvalidValue, in every entry. Forward scan on
// thread-block clusters of `cluster` CTAs, each owning `units` hidden units
// (cluster * units >= H, units <= 32, cluster <= 16) of `rows` (<= 8)
// batch rows. reset (B,T) f32 or null.
extern "C" int vmmt_gru_scan(int dtype, const void* x_proj, const void* mask,
                             const void* reset, const void* h0, const void* wh, const void* bh,
                             void* outs, void* final_h, int B, int T_len, int H,
                             int reverse, int cluster, int units, int rows, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  if (units < 1 || units > kScanUnits || cluster < 1 || cluster > kMaxCluster ||
      cluster * units < H || rows < 1 || rows > kFwdSlots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = by_dtype(dtype, [&](auto zero) {
    return launch_fwd<decltype(zero)>(x_proj, mask, reset, h0, wh, bh, outs, final_h, B, T_len,
                                      H, reverse, cluster, units, rows, s);
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many clusters of the forward scan's launch plan the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 when the card cannot hold one of
// that size), and the dynamic shared memory of one CTA.
extern "C" int vmmt_gru_scan_occupancy(int dtype, int H, int cluster, int rows,
                                       int* max_clusters, int* smem_bytes) {
  if (!known_dtype(dtype) || cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      rows > kFwdSlots)
    return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    cudaLaunchAttribute attr[1];
    const auto kernel = fwd_kernel<T>(false, H, rows);
    const cudaLaunchConfig_t cfg = scan_fwd_config<T>(kernel, rows, H, cluster, rows, attr, 0);
    *smem_bytes = (int)cfg.dynamicSmemBytes;
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  };
  return by_dtype(dtype, query);
}

// Backward of vmmt_gru_scan on thread-block clusters of `cluster` CTAs,
// each owning `units` hidden units (cluster * units >= H, units <= 32,
// cluster <= 16) of `rows` batch rows: 4, or 2 in f32. x_proj and wh in the compute dtype; mask,
// reset (null: none), h0, bh, outs, g and every output f32: dx (B,T,3H), dh0 (B,H), dwh (H,3H), dbh
// (3H). Scratch, f32: hp (B,T,3H), dhn (B,T,H). The hoisted products in
// f32 on tile_gemm.cuh (dWh splits its K = B*T over `splits` blocks a 64
// x 64 tile, with partial (splits * 4096 floats a tile) and counters (an
// int a tile, zero before the call); hs, dp and wp unused, bn and stages
// ignored), in bf16 and f16 on wgmma_gemm.cuh (Products, tiles of 128 x
// bn, a ring of `stages` stages, dWh's K split over `splits` CTAs a tile;
// hs (B*T, pad8(H)) and dp (B*T, pad8(3H)) in the compute dtype; wp null
// where 3H values are whole 16-byte pieces, else (H, pad8(3H)); partial
// the larger of splits * 128 * bn floats a tile and the dP pass's
// pad8(3H) / 32 * 32 x ceil(B*T / 128) sums, counters an int a tile and a
// 32-column strip, zero before the call).
extern "C" int vmmt_gru_scan_bwd(int dtype, const void* x_proj, const void* mask,
                                 const void* reset, const void* h0, const void* wh, const void* bh,
                                 const void* outs, const void* g, void* dx, void* dh0, void* dwh,
                                 void* dbh, void* hp, void* dhn, void* partial, void* counters,
                                 void* hs, void* dp, void* wp, int B, int T_len, int H,
                                 int reverse, int cluster, int units, int rows, int splits,
                                 int bn, int stages, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  const Products q = products_of(h0, outs, reset, wh, bh, dx, dhn, hp, dwh, dbh, hs, dp, wp,
                                 wp != nullptr ? wp : wh, wp != nullptr ? pad8(3 * H) : 3 * H,
                                 partial, counters, B, T_len, H, reverse, splits, bn, stages);
  if (units < 1 || units > kScanUnits || cluster < 1 || cluster > kMaxCluster ||
      cluster * units < H || splits < 1 || !(rows == kScanRows || (rows == 2 && dtype == 0)) ||
      !products_take(dtype, q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = by_dtype(dtype, [&](auto zero) {
    return launch_bwd<decltype(zero)>(x_proj, mask, g, dx, dh0, dhn, q, cluster, units, rows,
                                      s);
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// Row 2's hoisted products alone on the wgmma engine (bf16 and f16), from
// a backward's dx (B,T,3H) and dhn (B,T,H): the operand pass and (a) hp,
// then the operand pass and (c) dwh and dbh, as vmmt_gru_scan_bwd runs
// them around its scan; arguments as its own. For the card's checks and
// timings of the products beside their plain version.
extern "C" int vmmt_gru_bwd_products(int dtype, const void* h0, const void* outs,
                                     const void* reset, const void* wh, const void* bh,
                                     const void* dx, const void* dhn, void* hp, void* dwh,
                                     void* dbh, void* hs, void* dp, void* wp, void* partial,
                                     void* counters, int B, int T_len, int H, int reverse,
                                     int splits, int bn, int stages, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  const Products q = products_of(h0, outs, reset, wh, bh, dx, dhn, hp, dwh, dbh, hs, dp, wp,
                                 wp != nullptr ? wp : wh, wp != nullptr ? pad8(3 * H) : 3 * H,
                                 partial, counters, B, T_len, H, reverse, splits, bn, stages);
  if (H < 1 || dtype == 0 || !products_take(dtype, q)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    const int e = launch_hoist<T>(q, s);
    return e != 0 ? e : launch_dwh<T>(q, s);
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// CTAs of the wgmma products with tiles of 128 x bn and `stages` stages
// that an SM holds at once (0 where none fits), and the dynamic shared
// memory of one (wg_smem).
extern "C" int vmmt_gru_products_occupancy(int dtype, int bn, int stages, int* per_sm,
                                           int* smem_bytes) {
  if (!known_dtype(dtype) || dtype == 0 || (bn != 128 && bn != 256) || stages < 2)
    return (int)cudaErrorInvalidValue;
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    if constexpr (is_mma<T>()) {
      return wgmma_gemm_occupancy<T>(bn, stages, per_sm, smem_bytes);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}

// How many clusters of the backward scan's launch plan the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 when the card cannot hold one of
// that size), and the dynamic shared memory of one CTA.
extern "C" int vmmt_gru_scan_bwd_occupancy(int dtype, int H, int cluster, int units, int rows,
                                           int* max_clusters, int* smem_bytes) {
  if (!known_dtype(dtype) || cluster < 1 || cluster > kMaxCluster ||
      !(rows == kScanRows || (rows == 2 && dtype == 0)))
    return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    cudaLaunchAttribute attr[1];
    const auto kernel = bwd_kernel<T>(false, rows);
    const cudaLaunchConfig_t cfg =
        scan_bwd_config<T>(kernel, rows, H, cluster, units, rows, attr, 0);
    *smem_bytes = (int)cfg.dynamicSmemBytes;
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  };
  return by_dtype(dtype, query);
}

// Backward above 512 units, the tiled plan: the hoisted gate products and
// dWh as vmmt_gru_scan_bwd's (in bf16 and f16 (a)'s B operand is wt where
// given, else wh), the reverse
// scan on gru_tiled_bwd_kernel. Arguments as vmmt_gru_scan_bwd's (without
// wp), then xch:
// 2 * rows * row_tiles * tiled_ld(H) elements of the compute dtype; wt:
// null where the kernel reads wh in place (3H elements a whole number of
// 16-byte pieces), else wh padded to rows of tiled_ld(H), zero past 3H;
// CTAs of `rows` x `units` cells (valid_tile), `cluster` of them splitting K
// a tile, row_tiles row tiles a launch, one launch a chunk of rows *
// row_tiles rows, with `resident` each CTA's rows of Wh in its shared
// memory for the call, a ring of scan_stages = kTiledStages stages, or
// kBwdWholeK (with `resident` only: each step's K of the tile's rows of
// round(dh_proj) in one stage by bulk copies) (TiledLayout); dWh's K split
// over `splits` blocks;
// the products' bn and stages; probe: null, or 1 + 4
// * T int64 globaltimer stamps of the first launch's CTA 0 (after the first
// grid barrier, then each step's gate backward, barrier, product and sums).
// wh (or wt) and xch 16-byte aligned.
extern "C" int vmmt_gru_tiled_bwd(int dtype, const void* x_proj, const void* mask,
                                  const void* reset, const void* h0, const void* wh,
                                  const void* bh, const void* outs, const void* g, void* dx,
                                  void* dh0, void* dwh, void* dbh, void* hp, void* dhn,
                                  void* partial, void* counters, void* hs, void* dp, void* xch,
                                  const void* wt, int B, int T_len, int H, int reverse, int rows,
                                  int units, int cluster, int row_tiles, int resident,
                                  int scan_stages, int splits, int bn, int stages, void* probe,
                                  void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  if (H < 1 || !valid_tile(rows, units, cluster, scan_stages) || row_tiles < 1 || splits < 1 ||
      (scan_stages == kBwdWholeK && resident == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const int H3 = 3 * H;
    const void* w = wt != nullptr ? wt : wh;
    if ((wt == nullptr && H3 * sizeof(T) % 16 != 0) || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(xch) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const Products q = products_of(h0, outs, reset, wh, bh, dx, dhn, hp, dwh, dbh, hs, dp,
                                   nullptr, w, wt != nullptr ? tiled_ld<T>(H) : H3, partial,
                                   counters, B, T_len, H, reverse, splits, bn, stages);
    if (!products_take(dtype, q)) return (int)cudaErrorInvalidValue;
    int err = hoist_products<T>(q, s);
    if (err != 0) return err;
    Tiled<T> p = {};
    p.x_proj = static_cast<const T*>(x_proj);
    p.mask = static_cast<const float*>(mask);
    p.reset = q.reset;
    p.h0 = q.h0;
    p.outs = q.outs;
    p.g = static_cast<const float*>(g);
    p.hp = static_cast<const float*>(hp);
    p.w = static_cast<const T*>(w);
    p.dx = static_cast<float*>(dx);
    p.dhn = static_cast<float*>(dhn);
    p.dh0 = static_cast<float*>(dh0);
    p.xch = static_cast<T*>(xch);
    p.probe = static_cast<long long*>(probe);
    p.B = B;
    p.T_len = T_len;
    p.H = H;
    p.reverse = reverse;
    p.rows = rows;
    p.units = units;
    p.ldw = wt != nullptr ? tiled_ld<T>(H) : H3;
    p.ldx = tiled_ld<T>(H);
    p.resident = resident;
    err = launch_tiled<T>(p, cluster, row_tiles, scan_stages, s);
    return err != 0 ? err : dwh_products<T>(q, s);
  };
  const int err = by_dtype(dtype, run);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the tiled backward the card holds at once in clusters of
// `cluster` (cudaOccupancyMaxActiveClusters times cluster; 0 when it cannot
// hold one), and the dynamic shared memory of one CTA of the tiling and
// ring (TiledLayout) at H units.
extern "C" int vmmt_gru_tiled_bwd_occupancy(int dtype, int H, int rows, int units, int cluster,
                                            int resident, int stages, int* max_ctas,
                                            int* smem_bytes) {
  if (!known_dtype(dtype) || H < 1 || !valid_tile(rows, units, cluster, stages) ||
      (stages == kBwdWholeK && resident == 0))
    return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    const size_t smem = tiled_bwd_smem<T>(H, rows, units, cluster, resident != 0, stages);
    *smem_bytes = (int)smem;
    const auto kernel = tiled_bwd_kernel<T>(stages, rows, units, cluster);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = tiled_config(cluster, cluster, smem, attr, 0);
    cfg.numAttrs = 1;  // the cluster dimension alone
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *max_ctas = clusters * cluster;
    return err;
  };
  return by_dtype(dtype, query);
}

// Forward on the tiled plan (any H >= 1; the launch plan takes it above
// 512 units and wherever the cluster plan would run in waves): inputs and
// outputs as vmmt_gru_scan's, then xch: 2 * rows * row_tiles * ldx elements
// of the compute dtype (ldx = H padded to a K chunk); wt: null where the
// kernel reads wh in place (H a whole number of 16-byte pieces, so that
// each gate's columns start on one), else wh padded to (H, 3, ldg), ldg = H
// rounded up to a piece, zero past H; CTAs of `rows` x `units` cells,
// `cluster` of them splitting K a tile, row_tiles row tiles a launch, a ring
// of `stages` stages (4 or 2), or stages = 1 (kFwdWholeK, with `resident`
// only): each step's K of the tile's rows in one stage by bulk copies
// (valid_fwd_tile), one launch a chunk of rows * row_tiles rows, with
// `resident` each CTA's columns of Wh in its shared memory for the call
// (TiledFwdLayout); probe: null, or 1 + 4 * T int64
// globaltimer stamps of the first launch's CTA 0 (after the first grid
// barrier, then each step's product, sums, gates and grid barrier). wh (or
// wt) and xch 16-byte aligned.
extern "C" int vmmt_gru_tiled_fwd(int dtype, const void* x_proj, const void* mask,
                                  const void* reset, const void* h0, const void* wh,
                                  const void* bh, void* outs, void* final_h, void* xch,
                                  const void* wt, int B, int T_len, int H, int reverse, int rows,
                                  int units, int cluster, int row_tiles, int resident, int stages,
                                  void* probe, void* stream) {
  if (!known_dtype(dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return 0;
  if (H < 1 || !valid_fwd_tile(rows, units, cluster, stages) || row_tiles < 1 ||
      (stages == kFwdWholeK && resident == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    constexpr int per = 16 / (int)sizeof(T);
    const void* w = wt != nullptr ? wt : wh;
    if ((wt == nullptr && H % per != 0) || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(xch) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    TiledFwd<T> p = {};
    p.x_proj = static_cast<const T*>(x_proj);
    p.mask = static_cast<const float*>(mask);
    p.reset = static_cast<const float*>(reset);
    p.h0 = static_cast<const float*>(h0);
    p.bh = static_cast<const float*>(bh);
    p.w = static_cast<const T*>(w);
    p.outs = static_cast<float*>(outs);
    p.final_h = static_cast<float*>(final_h);
    p.xch = static_cast<T*>(xch);
    p.probe = static_cast<long long*>(probe);
    p.B = B;
    p.T_len = T_len;
    p.H = H;
    p.reverse = reverse;
    p.rows = rows;
    p.units = units;
    p.ldg = wt != nullptr ? (H + per - 1) / per * per : H;
    p.ldw = 3 * p.ldg;
    p.ldx = (H + tiled_kc<T>() - 1) / tiled_kc<T>() * tiled_kc<T>();
    p.resident = resident;
    return launch_tiled_fwd<T>(p, cluster, row_tiles, stages, s);
  };
  const int err = by_dtype(dtype, run);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the forward tiled kernel the card holds at once in
// clusters of `cluster` (cudaOccupancyMaxActiveClusters times cluster; 0
// when it cannot hold one), and the dynamic shared memory of one CTA of the
// tiling (TiledFwdLayout) at H units.
extern "C" int vmmt_gru_tiled_fwd_occupancy(int dtype, int H, int rows, int units, int cluster,
                                            int resident, int stages, int* max_ctas,
                                            int* smem_bytes) {
  if (!known_dtype(dtype) || H < 1 || !valid_fwd_tile(rows, units, cluster, stages) ||
      (stages == kFwdWholeK && resident == 0))
    return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    const size_t smem = tiled_fwd_smem<T>(H, rows, units, cluster, resident != 0, stages);
    *smem_bytes = (int)smem;
    const auto kernel = tiled_fwd_kernel<T>(stages, units);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = tiled_config(cluster, cluster, smem, attr, 0);
    cfg.numAttrs = 1;  // the cluster dimension alone
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *max_ctas = clusters * cluster;
    return err;
  };
  return by_dtype(dtype, query);
}
