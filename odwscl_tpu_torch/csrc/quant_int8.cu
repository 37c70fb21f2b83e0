// int8 quantize of activations: the passes of int8 serving that no conv
// epilogue can take.
//
// Counterpart of the activation quantize of odwscl_tpu/ops/quant.py:58
// conv2d_int8 (per channel :97, per tensor :100-103) and of :119
// dense_int8 (per row :128-131), which are XLA elementwise and reduce
// work, no Pallas kernel. Called through odwscl_tpu_torch/ops/quant.py
// (quantize_act, quantize_rows). Every mode equals the JAX expression bit
// for bit: codes = clip(rint(x / s), -127, 127), x bf16 or f32 read
// exactly into f32, with rint's half-to-even of the correctly rounded
// quotient (a refined multiply by the reciprocal and its exact remainder:
// int8_round.cuh, no division).
// The scales themselves are true divisions.
//
// Modes:
//   map     s = scale[c] per channel (c = i % C, C a multiple of 8), or
//           scale[0] per tensor, or, given a device abs-max (dynamic per
//           tensor), s = max(amax, 1e-12) / 127 (floor, then divide),
//           written to xs by one thread;
//   absmax  amax = max |x| over the tensor: a block reduction, then an
//           atomicMax on the bits of the non-negative float (their order
//           is the floats' order); the launcher zeroes amax first;
//   rows    one block a row of K: s = max(max |x_row| / 127, 1e-12)
//           (divide, then floor: the order differs from the conv's), then
//           the map; xs[row] = s. The second read of the row (50 KB for
//           fc6's 25,088 bf16 values) comes from L2.
//
// Bound: bytes, ~0.4 operations a byte. One read of x and one write of
// the codes a pass; the dynamic per-tensor mode reads x twice (absmax,
// then map). Each thread moves 8 values a step (16 bytes of bf16 in, 8
// bytes of codes out); the grids stride over the tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "int8_round.cuh"

namespace {

using int8_round::clip_code;
using int8_round::rint_quotient;

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ int8_t code(float v, float s, float r) {
  return clip_code(rint_quotient(v, s, r));
}

// The codes of 8 values with scales s and reciprocals r ~ 1 / s.
__device__ __forceinline__ void store8(int8_t* out, const float (&v)[8],
                                       const float (&s)[8],
                                       const float (&r)[8]) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[i], s[i], r[i])))
          << (8 * i);
    hi |= static_cast<uint32_t>(
              static_cast<uint8_t>(code(v[i + 4], s[i + 4], r[i + 4])))
          << (8 * i);
  }
  *reinterpret_cast<uint2*>(out) = make_uint2(lo, hi);
}

// The block's maximum of v, in every thread (v >= 0).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, part[i]);
  __syncthreads();   // part is reused by the next call
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    map_kernel(const T* __restrict__ x, long long n, int C,
               const float* __restrict__ scale,
               const float* __restrict__ amax, float* __restrict__ xs,
               int8_t* __restrict__ out) {
  float st = 0.0f;   // the per-tensor scale
  if (amax != nullptr) {
    st = __fdiv_rn(fmaxf(*amax, 1e-12f), 127.0f);
    if (blockIdx.x == 0 && threadIdx.x == 0) *xs = st;
  } else if (C == 0) {
    st = *scale;
  }
  const bool per_channel = amax == nullptr && C > 0;
  const float rt = per_channel ? 0.0f : __fdividef(1.0f, st);
  const long long n8 = n / 8;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n8; i += step) {
    float v[8], s[8], r[8];
    load8(x + 8 * i, v);
    const int c0 = per_channel ? static_cast<int>((8 * i) % C) : 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = per_channel ? __ldg(scale + c0 + e) : st;
      r[e] = per_channel ? __fdividef(1.0f, s[e]) : rt;
    }
    store8(out + 8 * i, v, s, r);
  }
  // the tail of a size that is not a multiple of 8 (per tensor only)
  for (long long i = 8 * n8 + blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += step)
    out[i] = code(to_float(x[i]), st, rt);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, long long n,
                  float* __restrict__ amax) {
  float m = 0.0f;
  const long long n8 = n / 8;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  for (long long i = first; i < n8; i += step) {
    float v[8];
    load8(x + 8 * i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  for (long long i = 8 * n8 + first; i < n; i += step)
    m = fmaxf(m, fabsf(to_float(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<unsigned int*>(amax), __float_as_uint(m));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const T* __restrict__ x, int K, int8_t* __restrict__ out,
                float* __restrict__ xs) {
  const T* row = x + static_cast<size_t>(blockIdx.x) * K;
  int8_t* orow = out + static_cast<size_t>(blockIdx.x) * K;
  const int k8 = K / 8;
  float m = 0.0f;
  for (int i = threadIdx.x; i < k8; i += kThreads) {
    float v[8];
    load8(row + 8 * i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  const float s = fmaxf(__fdiv_rn(block_max(m), 127.0f), 1e-12f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  float sv[8], rv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sv[e] = s;
    rv[e] = __fdividef(1.0f, s);
  }
  for (int i = threadIdx.x; i < k8; i += kThreads) {
    float v[8];
    load8(row + 8 * i, v);
    store8(orow + 8 * i, v, sv, rv);
  }
}

int grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n / 8 + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// The map. x bf16 (x_bf16 != 0) or f32, n values; C > 0: per-channel
// scale[C] over the last axis (C % 8 == 0); C == 0: the per-tensor
// scale[0], or with ``amax`` the dynamic per-tensor scale, written to xs.
extern "C" int quant_int8_map(const void* x, int x_bf16, long long n, int C,
                              const float* scale, const float* amax,
                              float* xs, void* out, void* stream) {
  if (n < 0 || C < 0 || C % 8 || (C > 0 && n % C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* o = static_cast<int8_t*>(out);
  if (x_bf16)
    map_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, C, scale, amax, xs, o);
  else
    map_kernel<<<grid_for(n), kThreads, 0, s>>>(static_cast<const float*>(x),
                                                n, C, scale, amax, xs, o);
  return static_cast<int>(cudaGetLastError());
}

// max |x| over n values into amax (f32, zeroed here first).
extern "C" int quant_int8_absmax(const void* x, int x_bf16, long long n,
                                 float* amax, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  if (x_bf16)
    absmax_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, amax);
  else
    absmax_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(x), n, amax);
  return static_cast<int>(cudaGetLastError());
}

// Per row: rows x K values (K % 8 == 0) -> codes and xs[rows].
extern "C" int quant_int8_rows(const void* x, int x_bf16, int rows, int K,
                               void* out, float* xs, void* stream) {
  if (rows < 0 || K <= 0 || K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* o = static_cast<int8_t*>(out);
  if (x_bf16)
    rows_kernel<<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), K, o, xs);
  else
    rows_kernel<<<rows, kThreads, 0, s>>>(static_cast<const float*>(x), K, o,
                                          xs);
  return static_cast<int>(cudaGetLastError());
}
