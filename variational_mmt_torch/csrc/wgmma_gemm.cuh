// A product on Hopper's Tensor Memory Accelerator (TMA) and warpgroup
// matrix multiply-accumulate (wgmma), for the GRU-scan backward's two
// hoisted products in gru_scan.cu: the gate recompute hp = Hs @ Wh + bh and
// the weight gradient dWh = Hs^T dP. It replaces no Pallas call by itself:
// those products sit inside _gru_bwd_kernel (variational_mmt_tpu/ops/
// pallas/gru.py, pallas_call at :297), which forms round(h_prev) @ Wh each
// step (:218) and sums round(h_prev)^T round(dh_proj) over the steps
// (:249); gru_scan.cu gathers each over all (row, t) into one product.
//
// out (M, N) f32 = A (M, K) B (K, N) (+ bias), operands 16-bit (bfloat16
// or float16) in device memory with rows padded to a multiple of 8 values
// (16 bytes, what TMA addresses), f32 accumulation. B is stored (K, N), N
// contiguous ("MN-major"); A is stored (M, K), K contiguous (kAMN false:
// the gate recompute's Hs), or (K, M), M contiguous (kAMN true: dWh's
// Hs^T). wgmma reads an MN-major operand with its transpose bit, which
// 16-bit types allow, so no operand is transposed in memory.
//
// What bounds it: at B = 256, T = 24, H = 1024-2048 each product is 6 B T
// H^2 FLOPs (77-309 GFLOP for both) against O(B T H) bytes, so the card's
// 989 TFLOP/s (dense bf16) bound it, 0.08-0.31 ms. tile_gemm.cuh, written
// for H = 250, reaches about 5% of that: one shared-memory stage refilled
// through registers, mma.sync, loads and products in turn. Here:
//  - a CTA of 384 threads computes a 128 x BN tile (BN 128 or 256). One
//    thread of the producer warpgroup issues TMA loads of 64-deep K slices
//    of A and B into a ring of `stages` shared-memory stages, 128-byte
//    swizzled (the layout wgmma reads without bank conflicts), each stage
//    guarded by a full and an empty mbarrier;
//  - two consumer warpgroups each run wgmma.mma_async m64nBNk16 on their
//    64 rows of the tile, f32 accumulators in registers, with one stage's
//    products in flight while the stage before is handed back;
//  - TMA fills zeros past the matrices' edges, so ragged M, N and K need
//    no masking in the main loop; the epilogue stores what lies inside;
//  - a product with few tiles and a long K (dWh) splits K over `splits`
//    CTAs a tile: each writes its partial tile, and the last to finish (an
//    atomic count a tile) adds them in split order, so repeats are
//    bit-identical.
// The tensor maps are encoded on the host through the driver's
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPointByVersion (no
// link against libcuda), and passed as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <atomic>

#include "tile_gemm.cuh"  // is_mma

namespace {

constexpr int kWgBM = 128;         // rows of a tile: two consumer warpgroups of 64
constexpr int kWgBK = 64;          // K of a stage: 128 bytes of 16-bit values, the swizzle span
constexpr int kWgThreads = 384;    // the producer warpgroup and two consumer warpgroups
constexpr int kWgAtom = 64 * 128;  // bytes of 64 rows of 128 bytes: one TMA box of 64 rows
constexpr int kWgConsumerWarps = 8;
constexpr int kWgMaxSmem = 232448;  // shared memory a CTA may take (sm_90)
constexpr int kWgDevices = 64;      // devices whose kernel attributes are remembered

// Bytes of one stage (A's 128 x 64 and B's 64 x bn 16-bit values) and the
// dynamic shared memory of a CTA: 1 KB to align the ring to the swizzle's
// 1024-byte pattern, the stages, a full and an empty mbarrier a stage.
__host__ __device__ inline int wg_stage_bytes(int bn) { return (kWgBM + bn) * kWgBK * 2; }
__host__ __device__ inline int wg_smem(int bn, int stages) {
  return 1024 + stages * wg_stage_bytes(bn) + 2 * stages * 8;
}

struct WgGemm {
  int M, N, K;
  float* out;          // (M, N), rows ldo apart
  int ldo;
  const float* bias;   // (N) added to every row, or null
  int splits;          // CTAs a tile along K, each at least one 64-deep slice
  float* partial;      // splits * 128 * bn floats a tile (splits > 1)
  int* counters;       // an int a tile, zero before the launch (splits > 1)
  int stages;
};

__device__ __forceinline__ uint32_t wg_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wg_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wg_addr(bar)) : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = wg_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at element coordinates (c0 innermost, c1) into
// shared memory at dst, completing bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma matrix descriptor of an operand at p in a 128-byte-swizzled
// layout: lbo, the bytes between 64-value atoms along M or N (MN-major;
// unused K-major); sbo, the bytes between groups of 8 rows (K-major) or of
// 8 k-rows (MN-major).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((wg_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN of the warpgroup, f32) += A (64 x 16) B (16 x BN) from
// shared memory; TA, TB: 1 where the operand is MN-major.
template <typename T, int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(is_mma<T>() && (BN == 128 || BN == 256), "wgmma of 16-bit operands, n 128 or 256");
  if constexpr (BN == 128) {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
          "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
            "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
            "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
            "+f"(d[63])
          : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
          "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
            "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
            "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
            "+f"(d[63])
          : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
          "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
          "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
          "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
          "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
          "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
            "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
            "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
            "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
            "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
            "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
            "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
            "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
            "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
            "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
            "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
            "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
            "+f"(d[126]), "+f"(d[127])
          : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
          "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
          "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
          "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
          "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
          "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
            "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
            "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
            "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
            "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
            "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
            "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
            "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
            "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
            "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
            "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
            "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
            "+f"(d[126]), "+f"(d[127])
          : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
    }
  }
}

// The named barrier of the two consumer warpgroups (the producer's threads
// leave after their loads).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

template <typename T, int BN, bool kAMN>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const WgGemm p) {
  extern __shared__ __align__(16) unsigned char wg_raw[];
  __shared__ int last;
  unsigned char* smem = wg_raw + ((1024 - (wg_addr(wg_raw) & 1023)) & 1023);
  constexpr int kStage = (kWgBM + BN) * kWgBK * 2, kA = kWgBM * kWgBK * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * kStage);
  uint64_t* empty = full + p.stages;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int m0 = tile / n_tiles * kWgBM, n0 = tile % n_tiles * BN;
  const int kb = (p.K + kWgBK - 1) / kWgBK;
  const int kb0 = split * kb / p.splits, n_k = (split + 1) * kb / p.splits - kb0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread issues every load
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) mbar_wait(&empty[s], (i / p.stages - 1) & 1);
        unsigned char* a = smem + s * kStage;
        unsigned char* b = a + kA;
        const int k = (kb0 + i) * kWgBK;
        mbar_expect_tx(&full[s], kStage);
        if constexpr (kAMN) {  // (K, M): two boxes of 64 k-rows x 64 m
          tma_load_2d(a, &ta, &full[s], m0, k);
          tma_load_2d(a + kWgAtom, &ta, &full[s], m0 + 64, k);
        } else {  // (M, K): one box of 128 m-rows x 64 k
          tma_load_2d(a, &ta, &full[s], k, m0);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * kWgAtom, &tb, &full[s], n0 + 64 * j, k);
      }
    }
    return;
  }

  // the consumers: warpgroup cw owns rows m0 + 64 cw .. + 63 of the tile
  const int ct = threadIdx.x - 128, cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % p.stages;
    mbar_wait(&full[s], (i / p.stages) & 1);
    const unsigned char* a = smem + s * kStage + cw * kWgAtom;
    const unsigned char* b = smem + s * kStage + kA;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // a 16-deep slice: 32 bytes along a K-major row, 16 rows of 128
      // bytes down an MN-major atom
      const uint64_t da = kAMN ? wg_desc(a + kk * 2048, kWgAtom, 1024)
                               : wg_desc(a + kk * 32, 16, 1024);
      const uint64_t db = wg_desc(b + kk * 2048, kWgAtom, 1024);
      wgmma<T, BN, kAMN ? 1 : 0, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before is read: hand it back
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % p.stages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4 j + 2 h + c] is (row + 8 h, col + c) of the 8 columns j
  if (p.splits > 1) {
    float* mine = p.partial + ((size_t)tile * p.splits + split) * (kWgBM * BN);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) mine[e * 256 + ct] = acc[e];
    __threadfence();
    consumers_sync();
    if (ct == 0) last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    consumers_sync();
    if (!last) return;
    __threadfence();
    // split by split, so that a split's BN / 2 loads are in flight at once
    const float* all = p.partial + (size_t)tile * p.splits * (kWgBM * BN);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    for (int s = 0; s < p.splits; ++s) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        acc[e] += __ldcg(all + (size_t)s * kWgBM * BN + e * 256 + ct);
    }
  }
  const int row = m0 + cw * 64 + warp * 16 + lane / 4;
  const bool pairs = p.ldo % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= p.N) continue;
    const bool both = col + 1 < p.N;
    const float b0 = p.bias != nullptr ? p.bias[col] : 0.f;
    const float b1 = p.bias != nullptr && both ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.M) continue;
      float* o = p.out + (size_t)r * p.ldo + col;
      const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (pairs && both) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (both) o[1] = v1;
      }
    }
  }
}

template <typename T>
using WgKernel = void (*)(const CUtensorMap, const CUtensorMap, const WgGemm);

// The instantiation for an A that is MN-major or not and tiles of bn
// columns (null for another bn).
template <typename T>
WgKernel<T> wg_kernel(bool a_mn, int bn) {
  if (bn == 128) return a_mn ? wgmma_gemm_kernel<T, 128, true> : wgmma_gemm_kernel<T, 128, false>;
  if (bn == 256) return a_mn ? wgmma_gemm_kernel<T, 256, true> : wgmma_gemm_kernel<T, 256, false>;
  return nullptr;
}

// Lets an instantiation take `smem` bytes of dynamic shared memory on the
// current device. cudaFuncSetAttribute runs where a launch needs more than
// was allowed before, once an instantiation and device in practice, not
// once a launch: it costs host time that a small call pays in full.
template <typename T, int BN, bool kAMN>
cudaError_t wg_allow_smem_of(int smem) {
  static std::atomic<int> allowed[kWgDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kWgDevices;
  if (known && allowed[dev].load(std::memory_order_acquire) >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(wgmma_gemm_kernel<T, BN, kAMN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && known) {
    int was = allowed[dev].load(std::memory_order_relaxed);
    while (was < smem && !allowed[dev].compare_exchange_weak(was, smem)) {
    }
  }
  return err;
}

template <typename T>
cudaError_t wg_allow_smem(bool a_mn, int bn, int smem) {
  if (bn == 128)
    return a_mn ? wg_allow_smem_of<T, 128, true>(smem) : wg_allow_smem_of<T, 128, false>(smem);
  if (bn == 256)
    return a_mn ? wg_allow_smem_of<T, 256, true>(smem) : wg_allow_smem_of<T, 256, false>(smem);
  return cudaErrorInvalidValue;
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime;
// null where the driver does not offer it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The tensor map of a 16-bit row-major matrix of rows x cols values at
// base, rows ld apart (a multiple of 8, base 16-byte aligned), read in
// boxes of box_rows rows of 64 values (128 bytes, swizzled as wgmma reads
// them), zero past the edges. Returns 0 or a CUDA error code: the call
// raises where the map cannot be encoded.
template <typename T>
int tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (rows < 1 || cols < 1 || ld % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launches out = A B (+ bias): ta is A's map (boxes of 128 rows of (M, K),
// or of 64 rows of (K, M) where a_mn), tb B's (boxes of 64 rows of (K, N));
// tiles of 128 x bn. Returns 0 or the launch's CUDA error.
template <typename T>
int wgmma_gemm(const CUtensorMap& ta, const CUtensorMap& tb, bool a_mn, int bn, const WgGemm& p,
               cudaStream_t stream) {
  const WgKernel<T> kernel = wg_kernel<T>(a_mn, bn);
  const int smem = wg_smem(bn, p.stages);
  if (kernel == nullptr || p.splits < 1 || p.stages < 2 || smem > kWgMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = wg_allow_smem<T>(a_mn, bn, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.M + kWgBM - 1) / kWgBM) * ((p.N + bn - 1) / bn);
  kernel<<<tiles * p.splits, kWgThreads, smem, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

// CTAs of the product with tiles of bn columns and `stages` stages that an
// SM holds at once (the lesser of both instantiations), and their dynamic
// shared memory.
template <typename T>
int wgmma_gemm_occupancy(int bn, int stages, int* per_sm, int* smem_bytes) {
  *smem_bytes = wg_smem(bn, stages);
  *per_sm = 0;
  int least = 1 << 30;
  for (bool a_mn : {false, true}) {
    const WgKernel<T> kernel = wg_kernel<T>(a_mn, bn);
    if (kernel == nullptr || stages < 2) return (int)cudaErrorInvalidValue;
    if (*smem_bytes > kWgMaxSmem) return 0;  // no CTA fits
    cudaError_t err = wg_allow_smem<T>(a_mn, bn, *smem_bytes);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWgThreads, *smem_bytes);
    if (err != cudaSuccess) return (int)err;
    least = n < least ? n : least;
  }
  *per_sm = least;
  return 0;
}

}  // namespace
