// One GRU layer over a whole sequence: the forward scan and its backward.
//
// The forward replaces the Pallas kernel _gru_fwd_kernel of
// variational_mmt_tpu/ops/pallas/gru.py (gru_layer_scan, pallas_call at
// :165). Same contract: x_proj (B,T,3H) precomputed input projections in
// the compute dtype T (float or bfloat16), mask (B,T) f32, h0 (B,H) f32,
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
//       scan (tile_gemm.cuh; tensor cores in bf16);
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
//       tiled product over K = B*T (tensor cores in bf16), K split over 8
//       blocks a tile (48 tiles would leave most SMs idle) whose partials
//       the last block adds in a fixed order; extra blocks of the same
//       launch sum dbh, the unrounded column sums of dh_proj. Deterministic.
// The scan writes dx_proj and only the third gate block of dh_proj (its
// first two equal dx_proj's), which (c) reads.
// With a reset stream (the Pallas has_reset branch, gru.py:205-210 and
// :244-245) every h_prev is the zeroed state h_prev * (1 - reset): in (a),
// in the scan's gate backward and in (c). The carry's cotangent does not
// cross a segment start: the scan multiplies each step's dh_prev by that
// step's 1 - reset where the next step (or dh0) reads it.
//
// Wide plan (H from 513 to 1024: the launch plan's layout "wide"). Past 512
// units the three gate blocks of Wh no longer fit one cluster of 16 CTAs
// (6.3 MB in bf16 at H = 1024), so both scans spread the 3H columns over
// the whole card instead: one persistent cooperative kernel a chunk of at
// most 256 x row_tiles batch rows, CTA b owning the 8 units of one mma
// n-tile in bf16 (4 in f32, FMAs, never TF32) of a tile of rows and
// keeping their columns of Wh in shared memory for the call (49 KB at H =
// 1024). h_{t-1} crosses CTAs through global memory: each step writes its
// units of round(h' * keep of the next step) into one of two exchange
// buffers (B, pad32(H)) and meets one grid barrier; the next step's
// product streams the rows from L2 into the mma fragments
// (block_product.cuh), so no CTA holds the whole state. Two buffers make
// one barrier a step enough: a CTA writing buffer s % 2 at step s + 2 has
// passed the barrier of step s + 1, which every reader of step s reached.
// The backward's serial part (b) runs the same way on round(dh_proj) (K =
// 3H): the gate backward of the CTA's cells into the step's exchange
// buffer, a grid barrier, then dh = dh_part + dh_proj @ Wh[units, :]^T;
// (a) and (c) are the cluster plan's tiled products, which take any shape.
// What bounds these kernels is the same chain of T steps, each now a grid
// barrier after a product whose operand comes from L2.

#include <cooperative_groups.h>

#include "block_product.cuh"

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
    ld = is_bf16<T>() ? slice_ld<T>(H) : H;
    buf = (size_t)slots * ld;  // elements of one state buffer
    w = align16((size_t)kFwdCols * ld * sizeof(T));
    hb = align16(2 * buf * sizeof(T));
    total = w + hb + (size_t)kFwdParts * kFwdCols * slots * sizeof(float);
  }
  // offset of (slot r, unit k) in a state buffer
  __host__ __device__ int at(int r, int k) const {
    return is_bf16<T>() ? r * ld + k : k * slots + r;
  }
};

// Batch-row slots of the forward's state buffers for clusters of `rows`
// rows: 8 (the mma's columns in bf16); in f32 4 where clusters of at most 4
// rows would not fit a CTA's shared memory with 8 (which brings f32 at H =
// 512 within it).
template <typename T>
int fwd_slots(int H, int rows) {
  return !is_bf16<T>() && rows <= kFwdFewSlots && FwdLayout<T>(H, kFwdSlots).total > kSmemPerBlock
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
    w_s[is_bf16<T>() ? c * ld + k : k * kFwdCols + c] = v;
  }
  // 1 - reset at (row, t)
  auto keep_at = [&](int row, int t) { return 1.f - reset[(size_t)row * T_len + t]; };
  // buffer 0 holds round(h0) of the cluster's rows (times the keep of the
  // first step processed), the rest is zero
  const int t_first = reverse ? T_len - 1 : 0;
  for (int i = tid; i < 2 * (int)L.buf; i += kFwdThreads) {
    const int b = i / (int)L.buf, e = i % (int)L.buf;
    const int r = is_bf16<T>() ? e / ld : e % kSlots;
    const int k = is_bf16<T>() ? e % ld : e / kSlots;
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
    if constexpr (is_bf16<T>()) {
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
          mma_bf16(c4, a, pair_at(db + k), pair_at(db + k + 8));
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
  if constexpr (!is_bf16<T>()) {
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
    wrows = is_bf16<T>() ? kScanUnits : units;
    ld = is_bf16<T>() ? slice_ld<T>(3 * H) : 3 * H;
    w = align16((size_t)wrows * ld * sizeof(T));
    dp = align16((size_t)2 * rows * ld * sizeof(T));
    total = w + dp + (size_t)2 * rows * units * sizeof(float) +
            (is_bf16<T>() ? (size_t)kScanParts * kScanUnits * rows * sizeof(float) : 0);
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
    if constexpr (is_bf16<T>()) {
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
        mma_bf16(c4, a, b0, b1);
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
  if constexpr (!is_bf16<T>()) {
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

template <typename T>
int launch_bwd(const void* x_proj, const void* mask, const void* reset, const void* h0,
               const void* wh, const void* bh, const void* outs, const void* g, void* dx,
               void* dh0, void* dwh, void* dbh, void* hp, void* dhn, void* partial,
               void* counters, int B, int T_len, int H, int reverse, int cluster, int units,
               int rows, int splits, cudaStream_t stream) {
  const int H3 = 3 * H;
  const float* h0f = static_cast<const float*>(h0);
  const float* outsf = static_cast<const float*>(outs);
  const float* resetf = static_cast<const float*>(reset);
  OpArray<ScanHoist<T>, 1> hoist{{{B * T_len, H3, H, h0f, outsf, resetf,
                                   static_cast<const T*>(wh), static_cast<const float*>(bh),
                                   static_cast<float*>(hp), T_len, H, reverse}}};
  tile_gemm<T>(hoist, stream);
  const auto kernel = bwd_kernel<T>(reset != nullptr, rows);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      scan_bwd_config<T>(kernel, B, H, cluster, units, rows, attr, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x_proj),
      static_cast<const float*>(mask), resetf, h0f, outsf, static_cast<const float*>(g),
      static_cast<const float*>(hp), static_cast<const T*>(wh), static_cast<float*>(dx),
      static_cast<float*>(dhn), static_cast<float*>(dh0), B, T_len, H, units, reverse);
  if (err != cudaSuccess) return (int)err;
  OpArray<ScanDWh<T>, 1> dw{{{H, H3, B * T_len, h0f, outsf, resetf,
                              static_cast<const float*>(dx), static_cast<const float*>(dhn),
                              static_cast<float*>(dwh), static_cast<float*>(dbh), T_len, H,
                              reverse}}};
  tile_gemm<T>(dw, stream, splits, static_cast<float*>(partial), static_cast<int*>(counters));
  return 0;
}


// ---------------------------------------------------------------------------
// Wide scans (H > 512): persistent cooperative kernels over the whole card;
// see the note at the top.

// Shared memory of a wide forward CTA of `rows` batch rows: its units'
// three gate columns of Wh transposed into (3 tile_rows, ldw) rows, the
// product buffer (3 n-tiles of 8 floats a row; in bf16 room for the
// warps' K-split partial sums) and the f32 carry (rows, units).
template <typename T>
struct WideFwdLayout {
  int ldw;
  size_t w, prod, total;
  __host__ __device__ WideFwdLayout(int H, int units, int rows) {
    ldw = frag_ld<T>(H);
    w = align16((size_t)3 * tile_rows<T>() * ldw * sizeof(T));
    const int prod_rows = is_bf16<T>() ? max(kDecWarps * 16, rows) : rows;
    prod = (size_t)prod_rows * 3 * kDecUnitsMma * sizeof(float);
    total = w + prod + align16((size_t)rows * units * sizeof(float));
  }
};

// Shared memory of a wide backward CTA: its units' rows of Wh (tile_rows,
// ldw) over the 3H columns, the product buffer (one n-tile) and the f32
// dh carry and dh_part (rows, units each).
template <typename T>
struct WideBwdLayout {
  int ldw;
  size_t w, prod, total;
  __host__ __device__ WideBwdLayout(int H, int units, int rows) {
    ldw = frag_ld<T>(3 * H);
    w = align16((size_t)tile_rows<T>() * ldw * sizeof(T));
    const int prod_rows = is_bf16<T>() ? max(kDecWarps * 16, rows) : rows;
    prod = (size_t)prod_rows * kDecUnitsMma * sizeof(float);
    total = w + prod + 2 * align16((size_t)rows * units * sizeof(float));
  }
};

// Arguments of both wide kernels for one launch over B rows (a chunk of
// the call's rows: the pointers start at its first row).
template <typename T>
struct Wide {
  const T* x_proj;
  const float *mask, *reset, *h0;  // reset null: no reset stream
  const T* wh;
  const float* bh;   // forward
  float* outs;       // forward: written; backward: read
  float* final_h;    // forward
  const float *g, *hp;           // backward: cotangent of outs, hoisted gate products
  float *dx, *dhn, *dh0;         // backward
  // written and read inside the kernel across CTAs, read with __ldcg: two
  // (B, ldx) buffers in T, zero past the row's width (forward: round(h),
  // ldx = pad32(H); backward: round(dh_proj), ldx = pad32(3H))
  T* xch;
  int B, T_len, H, units, unit_tiles, rows, ldx, reverse;
};

// The wide kernels' CTAs need 2 an SM in f32 (4 units a CTA: 256 CTAs at
// H = 1024), 1 in bf16 (8 units: 128 CTAs).
template <typename T>
struct WideBlocks {
  static constexpr int kPerSm = is_bf16<T>() ? 1 : 2;
};

// CTA b owns hidden units [(b % unit_tiles) * units, +units) of batch rows
// [(b / unit_tiles) * rows, +rows). Per step: its units' round(h) @ Wh from
// the exchange buffer of the step, the gates in f32, its units of h' into
// the other buffer (times the next step's 1 - reset), one grid barrier.
template <typename T>
__global__ void __launch_bounds__(kDecThreads, WideBlocks<T>::kPerSm)
gru_wide_fwd_kernel(Wide<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, T_len = p.T_len, H = p.H, H3 = 3 * H, units = p.units, ldx = p.ldx;
  const int tid = threadIdx.x;
  const int row_tiles = (B + p.rows - 1) / p.rows;
  const bool owner = (int)blockIdx.x < p.unit_tiles * row_tiles;
  const int u0 = (blockIdx.x % p.unit_tiles) * units;
  const int nu = owner ? max(0, min(units, H - u0)) : 0;
  const int r0 = owner ? (blockIdx.x / p.unit_tiles) * p.rows : 0;
  const int nr = owner ? min(p.rows, B - r0) : 0;
  const int items = nr * nu;
  constexpr int tr = tile_rows<T>(), PS = 3 * kDecUnitsMma;
  const WideFwdLayout<T> L(H, units, p.rows);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* prod = reinterpret_cast<float*>(smem_raw + L.w);
  float* carry = reinterpret_cast<float*>(smem_raw + L.w + L.prod);
  const bool reset = p.reset != nullptr;
  auto keep_at = [&](int row, int t) { return reset ? 1.f - p.reset[(size_t)row * T_len + t] : 1.f; };

  // row g * tr + u of w_s is column g * H + u0 + u of Wh, zero past nu
  // units and past H
  for (int i = tid; i < L.ldw * 3 * tr; i += kDecThreads) {
    const int u = i % tr, g = (i / tr) % 3, k = i / (3 * tr);
    w_s[(g * tr + u) * L.ldw + k] =
        u < nu && k < H ? p.wh[(size_t)k * H3 + g * H + u0 + u] : from_f<T>(0.f);
  }
  for (int i = tid; i < items; i += kDecThreads)
    carry[(i / nu) * units + i % nu] = p.h0[(size_t)(r0 + i / nu) * H + u0 + i % nu];
  // buffer 0: round(h0 * keep of the first step); buffer 1 zero (its
  // columns past H stay so)
  const int t_first = p.reverse ? T_len - 1 : 0;
  const size_t xn = (size_t)B * ldx;
  const size_t gtid = (size_t)blockIdx.x * kDecThreads + tid;
  for (size_t i = gtid; i < 2 * xn; i += (size_t)gridDim.x * kDecThreads) {
    const int k = (int)(i % ldx), row = (int)((i / ldx) % B);
    const float v = i < xn && k < H ? p.h0[(size_t)row * H + k] * keep_at(row, t_first) : 0.f;
    p.xch[i] = from_f<T>(v);
  }
  grid.sync();

  for (int step = 0; step < T_len; ++step) {
    const int t = p.reverse ? T_len - 1 - step : step;
    const int t_next = p.reverse ? t - 1 : t + 1;
    const T* cur = p.xch + (step & 1) * xn;
    T* nxt = p.xch + ((step + 1) & 1) * xn;
    if (items > 0) {
      block_product<T, 3>(cur, ldx, H, w_s, L.ldw, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu, row = r0 + mm, j = u0 + u, c = mm * units + u;
        const size_t n = (size_t)row * T_len + t;
        float x[3], hp[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          x[g] = to_f(p.x_proj[n * H3 + g * H + j]);
          hp[g] = prod[mm * PS + g * 8 + u] + p.bh[g * H + j];
        }
        float h = carry[c] * keep_at(row, t);  // as the product read it: zero at a start
        h = p.mask[n] > 0.f ? gru_cell(x, hp, h) : h;
        carry[c] = h;
        p.outs[n * H + j] = h;
        if (step + 1 < T_len) nxt[(size_t)row * ldx + j] = from_f<T>(h * keep_at(row, t_next));
      }
    }
    if (step + 1 < T_len) grid.sync();  // every unit of h' is in nxt
  }
  for (int i = tid; i < items; i += kDecThreads)
    p.final_h[(size_t)(r0 + i / nu) * H + u0 + i % nu] = carry[(i / nu) * units + i % nu];
}

// The reverse scan, tiled as the forward. Per step: the gate backward of
// the CTA's cells from the hoisted hp, their round(dh_proj) into the
// step's exchange buffer, one grid barrier, then dh = dh_part + dh_proj @
// Wh[units, :]^T from the exchange (times the step's 1 - reset).
template <typename T>
__global__ void __launch_bounds__(kDecThreads, WideBlocks<T>::kPerSm)
gru_wide_bwd_kernel(Wide<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, T_len = p.T_len, H = p.H, H3 = 3 * H, units = p.units, ldx = p.ldx;
  const int tid = threadIdx.x;
  const int row_tiles = (B + p.rows - 1) / p.rows;
  const bool owner = (int)blockIdx.x < p.unit_tiles * row_tiles;
  const int u0 = (blockIdx.x % p.unit_tiles) * units;
  const int nu = owner ? max(0, min(units, H - u0)) : 0;
  const int r0 = owner ? (blockIdx.x / p.unit_tiles) * p.rows : 0;
  const int nr = owner ? min(p.rows, B - r0) : 0;
  const int items = nr * nu;
  constexpr int tr = tile_rows<T>();
  const WideBwdLayout<T> L(H, units, p.rows);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* prod = reinterpret_cast<float*>(smem_raw + L.w);
  float* dh_s = reinterpret_cast<float*>(smem_raw + L.w + L.prod);
  float* part_s = dh_s + align16((size_t)p.rows * units * sizeof(float)) / sizeof(float);
  const bool reset = p.reset != nullptr;

  // row u of w_s is row u0 + u of Wh (its 3H columns), zero past nu and 3H
  for (int i = tid; i < tr * L.ldw; i += kDecThreads) {
    const int u = i / L.ldw, c = i % L.ldw;
    w_s[i] = u < nu && c < H3 ? p.wh[(size_t)(u0 + u) * H3 + c] : from_f<T>(0.f);
  }
  for (int i = tid; i < items; i += kDecThreads) dh_s[(i / nu) * units + i % nu] = 0.f;
  const size_t xn = (size_t)B * ldx;
  const size_t gtid = (size_t)blockIdx.x * kDecThreads + tid;
  for (size_t i = gtid; i < 2 * xn; i += (size_t)gridDim.x * kDecThreads) p.xch[i] = from_f<T>(0.f);
  grid.sync();

  for (int step = 0; step < T_len; ++step) {
    const int t = p.reverse ? step : T_len - 1 - step;
    T* dp = p.xch + (step & 1) * xn;
    for (int i = tid; i < items; i += kDecThreads) {
      const int mm = i / nu, u = i % nu, row = r0 + mm, j = u0 + u, c = mm * units + u;
      const size_t n = (size_t)row * T_len + t;
      const float keep = reset ? 1.f - p.reset[n] : 1.f;
      const float h_prev = prev_state<float>(p.h0, p.outs, row, t, T_len, H, j, p.reverse) * keep;
      const float* hp = p.hp + n * H3;
      const float hn = hp[2 * H + j];
      const float rg = sigmoid_f(to_f(p.x_proj[n * H3 + j]) + hp[j]);
      const float zg = sigmoid_f(to_f(p.x_proj[n * H3 + H + j]) + hp[H + j]);
      const float ng = tanhf(to_f(p.x_proj[n * H3 + 2 * H + j]) + rg * hn);
      const float m = p.mask[n];
      const float dh_total = p.g[n * H + j] + dh_s[c];
      const float dhat = m * dh_total;
      const float dn_pre = dhat * (1.f - zg) * (1.f - ng * ng);
      const float dz_pre = dhat * (h_prev - ng) * zg * (1.f - zg);
      const float dr_pre = dn_pre * hn * rg * (1.f - rg);
      const float dhn_ = dn_pre * rg;
      part_s[c] = (1.f - m) * dh_total + dhat * zg;
      float* dxr = p.dx + n * H3;
      dxr[j] = dr_pre;
      dxr[H + j] = dz_pre;
      dxr[2 * H + j] = dn_pre;
      p.dhn[n * H + j] = dhn_;
      T* out = dp + (size_t)row * ldx;
      out[j] = from_f<T>(dr_pre);
      out[H + j] = from_f<T>(dz_pre);
      out[2 * H + j] = from_f<T>(dhn_);
    }
    grid.sync();  // every cell's dh_proj is in dp
    if (items > 0) {
      block_product<T, 1>(dp, ldx, H3, w_s, L.ldw, nu, r0, nr, prod);
      for (int i = tid; i < items; i += kDecThreads) {
        const int mm = i / nu, u = i % nu, c = mm * units + u;
        const float keep = reset ? 1.f - p.reset[(size_t)(r0 + mm) * T_len + t] : 1.f;
        dh_s[c] = (part_s[c] + prod[mm * kDecUnitsMma + u]) * keep;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < items; i += kDecThreads)
    p.dh0[(size_t)(r0 + i / nu) * H + u0 + i % nu] = dh_s[(i / nu) * units + i % nu];
}

template <typename T>
size_t wide_smem(int pass, int H, int units, int rows) {
  return pass == 0 ? WideFwdLayout<T>(H, units, rows).total : WideBwdLayout<T>(H, units, rows).total;
}

template <typename T>
void* wide_kernel(int pass) {
  return pass == 0 ? reinterpret_cast<void*>(gru_wide_fwd_kernel<T>)
                   : reinterpret_cast<void*>(gru_wide_bwd_kernel<T>);
}

// One cooperative launch of pass 0 (forward) or 1 (backward) a chunk of
// `rows * row_tiles` batch rows, the chunks in order on the stream; q holds
// the whole call's pointers, offset here to each chunk's first row.
template <typename T>
int launch_wide(int pass, Wide<T> q, int row_tiles, cudaStream_t stream) {
  const size_t smem = wide_smem<T>(pass, q.H, q.units, q.rows);
  void* kernel = wide_kernel<T>(pass);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int B = q.B, T_len = q.T_len, H = q.H, chunk = q.rows * row_tiles;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    Wide<T> p = q;
    const size_t bt = (size_t)b0 * T_len;
    p.B = min(chunk, B - b0);
    p.x_proj = q.x_proj + bt * 3 * H;
    p.mask = q.mask + bt;
    p.reset = q.reset != nullptr ? q.reset + bt : nullptr;
    p.h0 = q.h0 + (size_t)b0 * H;
    p.outs = q.outs + bt * H;
    if (pass == 0) {
      p.final_h = q.final_h + (size_t)b0 * H;
    } else {
      p.g = q.g + bt * H;
      p.hp = q.hp + bt * 3 * H;
      p.dx = q.dx + bt * 3 * H;
      p.dhn = q.dhn + bt * H;
      p.dh0 = q.dh0 + (size_t)b0 * H;
    }
    const int grid = q.unit_tiles * ((p.B + q.rows - 1) / q.rows);
    void* args[] = {&p};
    // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that is not co-resident
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDecThreads), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
Wide<T> wide_args(const void* x_proj, const void* mask, const void* reset, const void* h0,
                  const void* wh, void* xch, int B, int T_len, int H, int units, int rows,
                  int pass, int reverse) {
  Wide<T> p = {};
  p.x_proj = static_cast<const T*>(x_proj);
  p.mask = static_cast<const float*>(mask);
  p.reset = static_cast<const float*>(reset);
  p.h0 = static_cast<const float*>(h0);
  p.wh = static_cast<const T*>(wh);
  p.xch = static_cast<T*>(xch);
  p.B = B;
  p.T_len = T_len;
  p.H = H;
  p.units = units;
  p.unit_tiles = (H + units - 1) / units;
  p.rows = rows;
  p.ldx = pad32(pass == 0 ? H : 3 * H);
  p.reverse = reverse;
  return p;
}

// The wide plan's tiling is the caller's: units the dtype's tile_rows,
// rows a multiple of 16, each launch's grid within the co-resident CTAs.
bool valid_wide(int dtype, int H, int units, int rows, int row_tiles) {
  const int tr = dtype == 1 ? kDecUnitsMma : kDecUnitsFma;
  return H >= 1 && units == tr && rows >= 16 && rows % 16 == 0 && row_tiles >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x_proj and Wh). Forward scan on
// thread-block clusters of `cluster` CTAs, each owning `units` hidden units
// (cluster * units >= H, units <= 32, cluster <= 16) of `rows` (<= 8)
// batch rows. reset (B,T) f32 or null.
extern "C" int vmmt_gru_scan(int dtype, const void* x_proj, const void* mask,
                             const void* reset, const void* h0, const void* wh, const void* bh,
                             void* outs, void* final_h, int B, int T_len, int H,
                             int reverse, int cluster, int units, int rows, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (units < 1 || units > kScanUnits || cluster < 1 || cluster > kMaxCluster ||
      cluster * units < H || rows < 1 || rows > kFwdSlots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 1 ? launch_fwd<__nv_bfloat16>(x_proj, mask, reset, h0, wh, bh, outs, final_h, B,
                                             T_len, H, reverse, cluster, units, rows, s)
                 : launch_fwd<float>(x_proj, mask, reset, h0, wh, bh, outs, final_h, B, T_len, H,
                                     reverse, cluster, units, rows, s);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many clusters of the forward scan's launch plan the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 when the card cannot hold one of
// that size), and the dynamic shared memory of one CTA.
extern "C" int vmmt_gru_scan_occupancy(int dtype, int H, int cluster, int rows,
                                       int* max_clusters, int* smem_bytes) {
  if (cluster < 1 || cluster > kMaxCluster || rows < 1 || rows > kFwdSlots)
    return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    cudaLaunchAttribute attr[1];
    const auto kernel = fwd_kernel<T>(false, H, rows);
    const cudaLaunchConfig_t cfg = scan_fwd_config<T>(kernel, rows, H, cluster, rows, attr, 0);
    *smem_bytes = (int)cfg.dynamicSmemBytes;
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  };
  return (int)(dtype == 1 ? query(__nv_bfloat16{}) : query(float{}));
}

// Backward of vmmt_gru_scan on thread-block clusters of `cluster` CTAs,
// each owning `units` hidden units (cluster * units >= H, units <= 32,
// cluster <= 16) of `rows` batch rows: 4, or 2 in f32. x_proj and wh in the compute dtype; mask,
// reset (null: none), h0, bh, outs, g and every output f32: dx (B,T,3H), dh0 (B,H), dwh (H,3H), dbh
// (3H). Scratch, f32: hp (B,T,3H), dhn (B,T,H); dWh splits its K = B*T
// over `splits` blocks a 64 x 64 tile, with partial (splits * 4096 floats a
// tile) and counters (an int a tile, zero before the call).
extern "C" int vmmt_gru_scan_bwd(int dtype, const void* x_proj, const void* mask,
                                 const void* reset, const void* h0, const void* wh, const void* bh,
                                 const void* outs, const void* g, void* dx, void* dh0, void* dwh,
                                 void* dbh, void* hp, void* dhn, void* partial, void* counters,
                                 int B, int T_len, int H, int reverse, int cluster, int units,
                                 int rows, int splits, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (units < 1 || units > kScanUnits || cluster < 1 || cluster > kMaxCluster ||
      cluster * units < H || splits < 1 || !(rows == kScanRows || (rows == 2 && dtype == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 1
          ? launch_bwd<__nv_bfloat16>(x_proj, mask, reset, h0, wh, bh, outs, g, dx, dh0, dwh, dbh,
                                      hp, dhn, partial, counters, B, T_len, H, reverse, cluster,
                                      units, rows, splits, s)
          : launch_bwd<float>(x_proj, mask, reset, h0, wh, bh, outs, g, dx, dh0, dwh, dbh, hp,
                              dhn, partial, counters, B, T_len, H, reverse, cluster, units,
                              rows, splits, s);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many clusters of the backward scan's launch plan the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 when the card cannot hold one of
// that size), and the dynamic shared memory of one CTA.
extern "C" int vmmt_gru_scan_bwd_occupancy(int dtype, int H, int cluster, int units, int rows,
                                           int* max_clusters, int* smem_bytes) {
  if (cluster < 1 || cluster > kMaxCluster || !(rows == kScanRows || (rows == 2 && dtype == 0)))
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
  return (int)(dtype == 1 ? query(__nv_bfloat16{}) : query(float{}));
}

// Wide forward (H > 512: the plan of ops/gru_scan.py): inputs and outputs
// as vmmt_gru_scan's; CTAs of `units` units (8 in bf16, 4 in f32) and
// `rows` batch rows, row_tiles of them a launch, one cooperative launch a
// chunk of rows * row_tiles rows. xch: scratch of 2 * rows * row_tiles *
// pad32(H) elements of the compute dtype.
extern "C" int vmmt_gru_wide(int dtype, const void* x_proj, const void* mask, const void* reset,
                             const void* h0, const void* wh, const void* bh, void* outs,
                             void* final_h, void* xch, int B, int T_len, int H, int reverse,
                             int units, int rows, int row_tiles, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (!valid_wide(dtype, H, units, rows, row_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    Wide<T> p = wide_args<T>(x_proj, mask, reset, h0, wh, xch, B, T_len, H, units, rows, 0,
                             reverse);
    p.bh = static_cast<const float*>(bh);
    p.outs = static_cast<float*>(outs);
    p.final_h = static_cast<float*>(final_h);
    return launch_wide<T>(0, p, row_tiles, s);
  };
  const int err = dtype == 1 ? run(__nv_bfloat16{}) : run(float{});
  return err != 0 ? err : (int)cudaGetLastError();
}

// Wide backward: the hoisted gate products and dWh as vmmt_gru_scan_bwd's
// (tile_gemm.cuh takes any shape), the reverse scan on the wide kernel.
// Arguments as vmmt_gru_scan_bwd's with the wide tiling in place of the
// cluster's and xch: 2 * rows * row_tiles * pad32(3H) elements of the
// compute dtype.
extern "C" int vmmt_gru_wide_bwd(int dtype, const void* x_proj, const void* mask,
                                 const void* reset, const void* h0, const void* wh, const void* bh,
                                 const void* outs, const void* g, void* dx, void* dh0, void* dwh,
                                 void* dbh, void* hp, void* dhn, void* partial, void* counters,
                                 void* xch, int B, int T_len, int H, int reverse, int units,
                                 int rows, int row_tiles, int splits, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (!valid_wide(dtype, H, units, rows, row_tiles) || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const int H3 = 3 * H;
    const float* h0f = static_cast<const float*>(h0);
    const float* outsf = static_cast<const float*>(outs);
    const float* resetf = static_cast<const float*>(reset);
    OpArray<ScanHoist<T>, 1> hoist{{{B * T_len, H3, H, h0f, outsf, resetf,
                                     static_cast<const T*>(wh), static_cast<const float*>(bh),
                                     static_cast<float*>(hp), T_len, H, reverse}}};
    tile_gemm<T>(hoist, s);
    Wide<T> p = wide_args<T>(x_proj, mask, reset, h0, wh, xch, B, T_len, H, units, rows, 1,
                             reverse);
    p.outs = const_cast<float*>(outsf);
    p.g = static_cast<const float*>(g);
    p.hp = static_cast<const float*>(hp);
    p.dx = static_cast<float*>(dx);
    p.dhn = static_cast<float*>(dhn);
    p.dh0 = static_cast<float*>(dh0);
    const int err = launch_wide<T>(1, p, row_tiles, s);
    if (err != 0) return err;
    OpArray<ScanDWh<T>, 1> dw{{{H, H3, B * T_len, h0f, outsf, resetf,
                                static_cast<const float*>(dx), static_cast<const float*>(dhn),
                                static_cast<float*>(dwh), static_cast<float*>(dbh), T_len, H,
                                reverse}}};
    tile_gemm<T>(dw, s, splits, static_cast<float*>(partial), static_cast<int*>(counters));
    return 0;
  };
  const int err = dtype == 1 ? run(__nv_bfloat16{}) : run(float{});
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many CTAs of the wide kernel of `pass` (0 forward, 1 backward) the
// card holds at once, and the dynamic shared memory of one CTA, for CTAs of
// `units` units and `rows` batch rows.
extern "C" int vmmt_gru_wide_occupancy(int dtype, int pass, int H, int units, int rows,
                                       int* max_blocks, int* smem_bytes) {
  if (pass != 0 && pass != 1) return (int)cudaErrorInvalidValue;
  auto query = [&](auto zero) {
    using T = decltype(zero);
    return co_resident(wide_kernel<T>(pass), wide_smem<T>(pass, H, units, rows), max_blocks,
                       smem_bytes);
  };
  return (int)(dtype == 1 ? query(__nv_bfloat16{}) : query(float{}));
}
