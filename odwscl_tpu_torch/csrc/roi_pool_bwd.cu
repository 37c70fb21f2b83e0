// 7x7 RoI max pooling, backward from the stored argmax, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: odwscl_tpu/ops/roi_pool_pallas.py:_bwd_kernel (:292, the
// Pallas TPU kernel behind the custom_vjp of roi_pool_tpu), which
// reproduces the CUDA ROIPool backward:
//   - each bin's cotangent goes whole to the bin's FIRST maximum in
//     row-major order, so ties, bf16 ties included, are routed to one cell
//     and never split;
//   - empty bins, masked rois and bins whose cells are all off the map
//     contribute nothing;
//   - the gradient accumulates in f32 and is returned in the feature dtype.
// The first maximum comes from the training forward (csrc/roi_pool_fwd.cu,
// ARGMAX): one code per output element, the offset (y - hs) * (we - ws) +
// (x - ws) of the cell inside its bin, read as unsigned, all ones for no
// cell; int16 codes (Narrow) for maps of at most 65535 cells, int32 (Wide)
// above, as the forward wrote them. The bin edges are recomputed here in integers, as the
// forward computes them. The plain PyTorch version is
// roi_pool_backward_argmax_plain in ops/roi_pool.py (decode, one f32
// index_add_, cast); the map-rescan roi_pool_backward_plain is the oracle of
// the routing. Routing is exact; the f32 sums agree up to their order.
//
// Why the argmax is stored: the first design recomputed it here by
// rescanning each bin of the map, as the JAX custom_vjp does, on the
// assumption that the rescan mostly hits L2. On the card the rescan cost
// as much as a whole forward (7.07 of the backward's 16.93 ms at the
// 1200-scale training step, NVIDIA H100 80GB HBM3, 700 W, PERF.md), while
// the int16 argmax costs 822 MB written by the forward and 822 MB read
// here at the training shape, about 0.5 ms at 3.35 TB/s.
//
// Bound: bytes. The function's own least traffic is feat and the cotangent
// g read once and d feat written once in the feature dtype (the bound kept
// from the first design, which read feat): at the training shape (feat
// [8, 160, 208, 512] bf16, P = 2048) 272 + 822 + 272 MB. This design reads
// g and the argmax instead of feat: 822 + 822 + 272 MB.
//
// Design: one block per (channel tile of kTileC = 256, map tile of kTileH x
// kTileW = 8 x 8 cells, image) owns that part of d feat outright. Its f32
// accumulator acc[cell][channel] (64 KB) lives in shared memory, so the
// first design's 411 M global f32 atomics, its zeroed f32 scratch and the
// separate cast pass are gone.
//   - Roi list: the block tests the P rois of its image kList at a time,
//     one thread per roi (mask, and which row and column bins meet the
//     tile: two contiguous ranges), and appends the hits, with warp
//     ballots, to a list in shared memory.
//   - Accumulate: each warp takes one (listed roi, row bin) at a time and
//     walks that row's bins that meet the tile, kBins (3) with their loads
//     in flight together; lanes over the tile's channels, 8 each, so each
//     lane reads 16 bytes of argmax codes and of g per bin. Each lane
//     decodes its cells (an exact float division) and, if a cell lies in
//     the tile, adds the cotangent with a shared-memory atomicAdd: warps
//     may meet on a word, lanes never do. Channel k of lane l lives in
//     plane k, word l of its cell, so the 32 lanes of an add touch 32 banks.
//   - Epilogue: acc is cast to the feature dtype and every cell of the
//     tile is written once, 16 bytes per store.
// g and the argmax are read once per map tile that a bin meets: about 1.5x
// at the training shape with 8 x 8 tiles. Two blocks of 512 threads share
// an SM (64 registers each). The tile sizes, kBins and the block shape were
// picked on the card among 8x4 to 32x32 tiles, 32 to 256 channels, 1 to 7
// bins in flight and 256 or 512 threads, kBins at the batches of the six
// train scales (odwscl_tpu_torch/tools/tune_roi_pool.py; readings in
// PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;   // map rows per block
constexpr int kTileW = 8;   // map columns per block
constexpr int kPer = 8;     // channels per lane (a multiple of 8)
constexpr int kBins = 3;    // bins whose loads are in flight together
constexpr int kList = 512;  // rois listed at a time
constexpr int kMinBlocks = 2;  // blocks per SM the registers must allow
constexpr int kTileC = 32 * kPer;
constexpr int kDefaultSmem = 48 * 1024;
constexpr size_t kAccBytes =
    static_cast<size_t>(kTileH) * kTileW * kTileC * sizeof(float);

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A lane's cotangents as loaded (kPer values in 16-byte vectors), read
// one channel at a time (at), and 8 channels of d feat stored from f32
// (store8)
struct Bf16 {
  using Elem = __nv_bfloat16;
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ float at(const uint4* g, int k) {
    const uint32_t w = word(g[k / 8], (k % 8) / 2);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void store8(Elem* dst, const float* f) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

struct F32 {
  using Elem = float;
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ float at(const uint4* g, int k) {
    return __uint_as_float(word(g[k / 4], k % 4));
  }
  static __device__ __forceinline__ void store8(Elem* dst, const float* f) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// A lane's kPer argmax codes: at(c, k) is channel k's code, kNone marks no
// cell, and row(code, bw, inv, half_inv) is code / bw, exactly.
struct Narrow {  // int16 codes, two to a word
  static constexpr int kBytes = 2;
  static constexpr uint32_t kNone = 0xffffu;
  static __device__ __forceinline__ uint32_t at(const uint4* c, int k) {
    const uint32_t w = word(c[k / 8], (k % 8) / 2);
    return (k & 1) ? (w >> 16) : (w & 0xffffu);
  }
  // (code + 0.5) / bw lies at least 0.5 / bw from an integer, and one
  // rounding of code * inv + 0.5 * inv errs by less than (code + 1) *
  // 2^-23 / bw
  static __device__ __forceinline__ int row(uint32_t code, int, float inv,
                                           float half_inv) {
    return static_cast<int>(
        __fmaf_rn(static_cast<float>(code), inv, half_inv));
  }
};

struct Wide {  // int32 codes, one to a word
  static constexpr int kBytes = 4;
  static constexpr uint32_t kNone = 0xffffffffu;
  static __device__ __forceinline__ uint32_t at(const uint4* c, int k) {
    return word(c[k / 4], k % 4);
  }
  // an integer division: the float rounding bound above needs code < 2^22
  static __device__ __forceinline__ int row(uint32_t code, int bw, float,
                                           float) {
    return static_cast<int>(code / static_cast<uint32_t>(bw));
  }
};

__device__ __forceinline__ int round_cell(float x, float scale) {
  // two roundings, as the forward computes it; no fused multiply-add
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(x, scale), 0.5f)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int bin_lo(int k, int len, int start, int limit) {
  return clampi(k * len / kPooled + start, 0, limit);
}

__device__ __forceinline__ int bin_hi(int k, int len, int start, int limit) {
  return clampi(((k + 1) * len + kPooled - 1) / kPooled + start, 0, limit);
}

// channel j of the tile lives in plane j % kPer, word j / kPer of its cell
__device__ __forceinline__ int acc_slot(int j) {
  return (j % kPer) * 32 + j / kPer;
}

// Grid (channel tiles, map tiles, images).
template <typename T, typename Code>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_pool_bwd_kernel(const uint4* __restrict__ argmax,
                    const float* __restrict__ rois,
                    const uint8_t* __restrict__ mask,
                    const typename T::Elem* __restrict__ grad,
                    typename T::Elem* __restrict__ dfeat, int P, int H,
                    int W, int C, float scale, int tiles_w) {
  constexpr int kCodeVecs = kPer * Code::kBytes / 16;  // uint4 of codes
  constexpr int kGradVecs = kPer * T::kBytes / 16;
  extern __shared__ __align__(16) float acc[];  // [kTileH * kTileW][kTileC]
  __shared__ int4 box[kList];   // x1, y1, roi_w, roi_h of the listed rois
  __shared__ int ids[kList];    // their flat index b * P + p
  __shared__ int span[kList];   // their row and column bins that meet the tile
  __shared__ int count;

  const int c0 = blockIdx.x * kTileC;
  const int ty0 = (blockIdx.y / tiles_w) * kTileH;
  const int tx0 = (blockIdx.y % tiles_w) * kTileW;
  const int th = min(ty0 + kTileH, H) - ty0;
  const int tw = min(tx0 + kTileW, W) - tx0;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = c0 + lane * kPer;  // the lane's first channel
  const bool lane_live = cl < C;    // C is a multiple of 8

  for (int i = tid; i < kTileH * kTileW * kTileC; i += kThreads) acc[i] = 0.f;

  for (int base = 0; base < P; base += kList) {
    __syncthreads();  // the previous list is consumed (and acc is zeroed)
    if (tid == 0) count = 0;
    __syncthreads();
    // list the rois whose bins meet the tile, with the ranges of those
    // bins (bins are ordered, so each range is contiguous)
    for (int p = base + tid; p < base + kList; p += kThreads) {
      const int roi = b * P + p;
      int4 q = make_int4(0, 0, 1, 1);
      int ph0 = kPooled, ph1 = 0, pw0 = kPooled, pw1 = 0;
      if (p < P && mask[roi]) {
        const float* r = rois + static_cast<int64_t>(roi) * 4;
        q.x = round_cell(r[0], scale);
        q.y = round_cell(r[1], scale);
        q.z = max(round_cell(r[2], scale) - q.x + 1, 1);
        q.w = max(round_cell(r[3], scale) - q.y + 1, 1);
#pragma unroll
        for (int k = 0; k < kPooled; ++k) {
          if (max(bin_lo(k, q.w, q.y, H), ty0) <
              min(bin_hi(k, q.w, q.y, H), ty0 + th)) {
            ph0 = min(ph0, k);
            ph1 = k + 1;
          }
          if (max(bin_lo(k, q.z, q.x, W), tx0) <
              min(bin_hi(k, q.z, q.x, W), tx0 + tw)) {
            pw0 = min(pw0, k);
            pw1 = k + 1;
          }
        }
      }
      const bool keep = ph1 > ph0 && pw1 > pw0;
      const unsigned hits = __ballot_sync(0xffffffffu, keep);
      int slot = 0;
      if (lane == 0 && hits) slot = atomicAdd(&count, __popc(hits));
      slot = __shfl_sync(0xffffffffu, slot, 0) +
             __popc(hits & ((1u << lane) - 1u));
      if (keep) {
        box[slot] = q;
        ids[slot] = roi;
        span[slot] = ph0 | (ph1 << 8) | (pw0 << 16) | (pw1 << 24);
      }
    }
    __syncthreads();

    // each warp takes one (listed roi, row bin) at a time and walks the
    // row's bins that meet the tile, kBins at a time with their loads in
    // flight together; lanes over the tile's channels, kPer each
    const int items = count * kPooled;
    for (int it = warp; it < items; it += kWarps) {
      const int li = it / kPooled;
      const int sp = span[li];
      const int ph = it - li * kPooled;
      if (ph < (sp & 0xff) || ph >= ((sp >> 8) & 0xff)) continue;
      const int pw0 = (sp >> 16) & 0xff, pw1 = (sp >> 24) & 0xff;
      const int4 r = box[li];
      const int hs = bin_lo(ph, r.w, r.y, H);
      const int64_t row0 =
          (static_cast<int64_t>(ids[li]) * kPooled + ph) * kPooled;
      for (int pwb = pw0; pwb < pw1; pwb += kBins) {
        uint4 codes[kBins][kCodeVecs];
        uint4 g[kBins][kGradVecs];
#pragma unroll
        for (int u = 0; u < kBins; ++u) {
          const int64_t e = (row0 + pwb + u) * C + cl;
          const bool live = pwb + u < pw1 && lane_live;
#pragma unroll
          for (int v = 0; v < kCodeVecs; ++v)
            codes[u][v] = live ? __ldg(argmax + e / (16 / Code::kBytes) + v)
                               : make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
          for (int v = 0; v < kGradVecs; ++v)
            if (live)
              g[u][v] = __ldg(reinterpret_cast<const uint4*>(grad + e) + v);
        }
#pragma unroll
        for (int u = 0; u < kBins; ++u) {
          const int pw = pwb + u;
          if (pw >= pw1) break;
          const int ws = bin_lo(pw, r.z, r.x, W);
          const int bw = bin_hi(pw, r.z, r.x, W) - ws;
          const float inv = 1.0f / static_cast<float>(bw);
          const float half_inv = 0.5f * inv;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const uint32_t code = Code::at(codes[u], k);
            if (code == Code::kNone) continue;
            const int dy = Code::row(code, bw, inv, half_inv);  // code / bw
            const int y = hs + dy - ty0;
            const int x = ws + static_cast<int>(code) - dy * bw - tx0;
            if (static_cast<unsigned>(y) < static_cast<unsigned>(th) &&
                static_cast<unsigned>(x) < static_cast<unsigned>(tw))
              atomicAdd(&acc[(y * kTileW + x) * kTileC + k * 32 + lane],
                        T::at(g[u], k));
          }
        }
      }
    }
  }
  __syncthreads();

  // epilogue: each cell of the tile, 8 channels per thread
  constexpr int kVecs = kTileC / 8;
  for (int it = tid; it < kTileH * kTileW * kVecs; it += kThreads) {
    const int cell = it / kVecs;
    const int j0 = (it - cell * kVecs) * 8;
    const int y = cell / kTileW;
    const int x = cell % kTileW;
    if (y >= th || x >= tw || c0 + j0 >= C) continue;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = acc[cell * kTileC + acc_slot(j0 + j)];
    T::store8(dfeat + ((static_cast<int64_t>(b) * H + ty0 + y) * W + tx0 + x)
                  * C + c0 + j0,
              f);
  }
}

template <typename T, typename Code>
int launch(const void* argmax, const float* rois, const uint8_t* mask,
           const void* grad, void* dfeat, int B, int P, int H, int W, int C,
           float scale, void* stream) {
  if (B * H * W == 0 || C == 0) return 0;
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (kAccBytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_pool_bwd_kernel<T, Code>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kAccBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid((C + kTileC - 1) / kTileC, tiles_h * tiles_w, B);
  roi_pool_bwd_kernel<T, Code><<<grid, kThreads, kAccBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(argmax), rois, mask,
      static_cast<const typename T::Elem*>(grad),
      static_cast<typename T::Elem*>(dfeat), P, H, W, C, scale, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. argmax [B, P, 7, 7, C] int16 (the
// training forward's codes), rois [B, P, 4] f32, mask [B, P] bool (1 byte),
// grad [B, P, 7, 7, C] in the feature dtype, dfeat [B, H, W, C] in the
// feature dtype (every cell written; C a multiple of 8, 16-byte aligned).
// Returns the cudaError_t of the launch.
extern "C" int roi_pool_bwd_bf16(const void* argmax, const float* rois,
                                 const uint8_t* mask, const void* grad,
                                 void* dfeat, int B, int P, int H, int W,
                                 int C, float scale, void* stream) {
  return launch<Bf16, Narrow>(argmax, rois, mask, grad, dfeat, B, P, H, W, C,
                              scale, stream);
}

extern "C" int roi_pool_bwd_f32(const void* argmax, const float* rois,
                                const uint8_t* mask, const void* grad,
                                void* dfeat, int B, int P, int H, int W,
                                int C, float scale, void* stream) {
  return launch<F32, Narrow>(argmax, rois, mask, grad, dfeat, B, P, H, W, C,
                             scale, stream);
}

// The same from int32 codes (maps of more than 65535 cells).
extern "C" int roi_pool_bwd_wide_bf16(const void* argmax, const float* rois,
                                      const uint8_t* mask, const void* grad,
                                      void* dfeat, int B, int P, int H,
                                      int W, int C, float scale,
                                      void* stream) {
  return launch<Bf16, Wide>(argmax, rois, mask, grad, dfeat, B, P, H, W, C,
                            scale, stream);
}

extern "C" int roi_pool_bwd_wide_f32(const void* argmax, const float* rois,
                                     const uint8_t* mask, const void* grad,
                                     void* dfeat, int B, int P, int H, int W,
                                     int C, float scale, void* stream) {
  return launch<F32, Wide>(argmax, rois, mask, grad, dfeat, B, P, H, W, C,
                           scale, stream);
}
