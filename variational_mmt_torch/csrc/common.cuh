// Device helpers shared by the port's CUDA sources: the conversions
// between the compute dtype T (float, bfloat16 or float16) and f32,
// rounding to T (to nearest even, as Tensor.to and astype do),
// the sigmoid, the warp reductions, the attention's thread count, the
// dynamic shared-memory opt-in and vmmt_error_string. Each kernel lives in
// its own source (gru_scan.cu, decode_step.cu, decoder.cu).
//
// Numerics, as in the Pallas bodies: every product takes its operands
// rounded to T and accumulates in f32; each elementwise product of the
// attention contractions is rounded to T before its f32 sum.
//
// Each library is one translation unit that includes this header once, so
// its definitions live in an anonymous namespace like the sources' own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// round an f32 value to the precision of T (the product operand dtype)
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

constexpr int kAttnThreads = 256;  // threads of an attention block

// Allows a dynamic shared-memory size above the 48 KB default.
template <typename Kernel>
void allow_smem(Kernel* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
}

// The compute dtype codes of the entry points: 0 float32, 1 bfloat16,
// 2 float16 (kernels.DTYPE_CODE).
constexpr bool known_dtype(int code) { return code >= 0 && code <= 2; }

// Calls f with a value of the compute dtype that `code` names and returns
// its result as an int; any other code returns cudaErrorInvalidValue and
// runs nothing.
template <typename F>
int by_dtype(int code, F&& f) {
  switch (code) {
    case 0:
      return (int)f(float{});
    case 1:
      return (int)f(__nv_bfloat16{});
    case 2:
      return (int)f(__half{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The message of an error code that an entry point returned.
extern "C" const char* vmmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
