// 7x7 RoI max pooling cut by stage, for NVIDIA Hopper (sm_90a): the
// ROIPool forward's stage profiler.
//
// Replaces the TPU profiling kernels built from the blocks of
// odwscl_tpu/ops/roi_pool_pallas.py: tools/profile_pool.py:_fwd_rows_only
// (:61) and _fwd_cols_only (:89), and tools/profile_pool_stages.py:
// make_kernel (:35) with its write/rows/cols/full stages. One __global__
// template, instantiated per stage and dtype (bf16, f32):
//   write      zeros: the output traffic alone;
//   rows       row stage, then out[ph, pw] = max of rb[ph][0..7];
//   rows_col0  row stage, then out[ph, pw] = rb[ph][0];
//   cols       rb[ph][:cw] = map row ph (0..6) across the window, then the
//              exact column stage;
//   full       row stage, then the exact column stage: the forward of
//              csrc/roi_pool_fwd.cu, bit for bit.
// Masked rois give 0 in every stage. The plain PyTorch version of each
// stage is roi_pool_stage_plain in ops/roi_pool_stages.py; max only
// selects, so the two agree bit-exactly.
//
// Bound: bytes. At the bench shape (feat [8, 104, 168, 512] bf16, P =
// 2048) the [B, P, 7, 7, C] output alone is 822.1 MB = 0.2454 ms at an
// H100 SXM's 3.35 TB/s (write). The others also read each map cell that
// their output depends on once (stage_work in ops/roi_pool_stages.py):
// full 956.8 MB = 0.2856 ms, rows 929.4 MB = 0.2774 ms (columns [xs,
// xs + 8)), rows_col0 835.7 MB = 0.2495 ms (column xs), cols 831.7 MB =
// 0.2483 ms (map rows 0..6). Their comparisons are far below the card's
// rate.
//
// Design: the TPU kernel's separable structure, rethought for Hopper. One
// block per (roi, tile of ct channels), threads over channel pairs (bf16x2
// or float2), so every load and store of a warp is a contiguous run along
// the NHWC channel axis.
//   Row stage: threads over (window column, channel pair) write the 7
//   row-bin maxima of every column of [xs, xs + cw) into shared memory
//   rb[7][cw][ct], in the feature dtype (exact: the maxima are inputs).
//   Each thread makes one pass over the roi's rows, read from device
//   memory four at a time, and each row updates the bins that hold it
//   (the TPU's sparse row table would cost more shared memory than it
//   saves).
//   Columns at or beyond W read as 0, as the TPU's zero pad does, without
//   a padded copy of the map.
//   Column stage: threads over (bin, channel pair) reduce rb over each
//   column bin inside the window and write the 49 outputs once.
// Every stage keeps the same grid, block, shared memory and output
// traffic, so that only the stage under test differs. A stage's shared
// stores are read by other threads after __syncthreads() at indices the
// compiler cannot foresee, so they are kept even where the stage reads
// only rb[ph][0]. The scratch is 7 * cw_max * ct * itemsize bytes: the
// wrapper picks the widest even channel tile ct that fits 227 KB for the
// launch's widest window (ct = 128 at the bench shape, 158 KB), and this
// file raises the dynamic shared memory limit above 48 KB per
// instantiation. The windows (xs, cw) are planned by the wrapper as the
// TPU kernel plans them (ops/roi_pool_stages.py:tpu_windows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;
constexpr int kThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

enum Stage { kWrite = 0, kRows = 1, kRowsCol0 = 2, kCols = 3, kFull = 4 };

struct Bf16x2 {
  using Vec = __nv_bfloat162;
  static constexpr int kItemSize = 2;
  static __device__ __forceinline__ float2 to_float2(Vec v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ Vec from_float2(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);  // exact: v holds bf16 values
  }
};

struct F32x2 {
  using Vec = float2;
  static constexpr int kItemSize = 4;
  static __device__ __forceinline__ float2 to_float2(Vec v) { return v; }
  static __device__ __forceinline__ Vec from_float2(float2 v) { return v; }
};

__device__ __forceinline__ int round_cell(float x, float scale) {
  // two roundings, as the reference computes it; no fused multiply-add
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(x, scale), 0.5f)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// bin k of a roi of `len` cells from `start`: [lo, hi), clipped to the map
__device__ __forceinline__ int bin_lo(int k, int len, int start, int limit) {
  return clampi(k * len / kPooled + start, 0, limit);
}

__device__ __forceinline__ int bin_hi(int k, int len, int start, int limit) {
  return clampi(((k + 1) * len + kPooled - 1) / kPooled + start, 0, limit);
}

__device__ __forceinline__ float2 max2(float2 a, float2 b) {
  return make_float2(b.x > a.x ? b.x : a.x, b.y > a.y ? b.y : a.y);
}

template <typename T, int STAGE>
__global__ void __launch_bounds__(kThreads)
roi_pool_stage_kernel(const typename T::Vec* __restrict__ feat,
                      const float* __restrict__ rois,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ xs_of,
                      const int* __restrict__ cw_of,
                      typename T::Vec* __restrict__ out,
                      int P, int H, int W, int C2, int ct2, float scale) {
  using Vec = typename T::Vec;
  extern __shared__ __align__(16) unsigned char smem[];
  Vec* rb = reinterpret_cast<Vec*>(smem);  // [7][cw][ct2]

  const int tiles = C2 / ct2;
  const int roi = blockIdx.x / tiles;      // b * P + p
  const int c0 = (blockIdx.x - roi * tiles) * ct2;
  const int b = roi / P;
  const bool live = STAGE != kWrite && mask[roi];
  const float2 zero = make_float2(0.f, 0.f);
  const float2 neg = make_float2(-INFINITY, -INFINITY);

  int x1 = 0, y1 = 0, roi_w = 1, roi_h = 1, xs = 0, cw = 0;
  if (live) {
    const float* r = rois + static_cast<int64_t>(roi) * 4;
    x1 = round_cell(r[0], scale);
    y1 = round_cell(r[1], scale);
    roi_w = max(round_cell(r[2], scale) - x1 + 1, 1);
    roi_h = max(round_cell(r[3], scale) - y1 + 1, 1);
    xs = xs_of[roi];
    cw = cw_of[roi];
  }
  const Vec* fimg = feat + static_cast<int64_t>(b) * H * W * C2 + c0;

  if (live && STAGE != kCols) {
    // row stage: rb[ph][x] = max over row bin ph of column xs + x. Row
    // bins hold ~3 rows at the bench shape, so each thread makes one pass
    // over the roi's rows, four loads in flight, and every row updates
    // the bins that hold it.
    int hs[kPooled], he[kPooled];
#pragma unroll
    for (int ph = 0; ph < kPooled; ++ph) {
      hs[ph] = bin_lo(ph, roi_h, y1, H);
      he[ph] = bin_hi(ph, roi_h, y1, H);
    }
    const int64_t row_stride = static_cast<int64_t>(W) * C2;
    for (int it = threadIdx.x; it < cw * ct2; it += blockDim.x) {
      const int x = it / ct2;
      const int pair = it - x * ct2;
      const int col = xs + x;
      float2 m[kPooled];
#pragma unroll
      for (int ph = 0; ph < kPooled; ++ph) m[ph] = neg;
      if (col < W) {
        const Vec* src = fimg + static_cast<int64_t>(col) * C2 + pair;
        int y = hs[0];
        for (; y + 4 <= he[kPooled - 1]; y += 4) {
          float2 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = T::to_float2(src[(y + k) * row_stride]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int ph = 0; ph < kPooled; ++ph)
              if (y + k >= hs[ph] && y + k < he[ph]) m[ph] = max2(m[ph], v[k]);
        }
        for (; y < he[kPooled - 1]; ++y) {
          const float2 v = T::to_float2(src[y * row_stride]);
#pragma unroll
          for (int ph = 0; ph < kPooled; ++ph)
            if (y >= hs[ph] && y < he[ph]) m[ph] = max2(m[ph], v);
        }
      } else {
#pragma unroll
        for (int ph = 0; ph < kPooled; ++ph)
          if (he[ph] > hs[ph]) m[ph] = zero;  // the zero pad right of the map
      }
#pragma unroll
      for (int ph = 0; ph < kPooled; ++ph)
        rb[(ph * cw + x) * ct2 + pair] = T::from_float2(m[ph]);
    }
  } else if (live) {
    // cols: rb[ph][x] = map row ph at column xs + x (0 in the zero pad)
    for (int it = threadIdx.x; it < cw * ct2; it += blockDim.x) {
      const int x = it / ct2;
      const int pair = it - x * ct2;
      const int col = xs + x;
#pragma unroll
      for (int ph = 0; ph < kPooled; ++ph) {
        float2 v = zero;
        if (ph < H && col < W)
          v = T::to_float2(
              fimg[(static_cast<int64_t>(ph) * W + col) * C2 + pair]);
        rb[(ph * cw + x) * ct2 + pair] = T::from_float2(v);
      }
    }
  }
  __syncthreads();

  // column stage: one output bin and channel pair per item
  Vec* out_roi = out + static_cast<int64_t>(roi) * kPooled * kPooled * C2 + c0;
  for (int it = threadIdx.x; it < kPooled * kPooled * ct2;
       it += blockDim.x) {
    const int bin = it / ct2;
    const int pair = it - bin * ct2;
    const int ph = bin / kPooled;
    const int pw = bin - ph * kPooled;
    float2 m = zero;
    if (live) {
      const Vec* row = rb + ph * cw * ct2 + pair;
      const bool row_live = STAGE == kCols ||
                            bin_hi(ph, roi_h, y1, H) > bin_lo(ph, roi_h, y1, H);
      if (STAGE == kRows || STAGE == kRowsCol0) {
        if (row_live) {
          m = T::to_float2(row[0]);
          if (STAGE == kRows)
            for (int x = 1; x < 8; ++x)
              m = max2(m, T::to_float2(row[x * ct2]));
        }
      } else {
        const int lo = clampi(bin_lo(pw, roi_w, x1, W) - xs, 0, cw);
        const int hi = clampi(bin_hi(pw, roi_w, x1, W) - xs, 0, cw);
        if (row_live && hi > lo) {
          m = neg;
          for (int x = lo; x < hi; ++x)
            m = max2(m, T::to_float2(row[x * ct2]));
        }
      }
    }
    out_roi[bin * C2 + pair] = T::from_float2(m);
  }
}

template <typename T, int STAGE>
int launch(const void* feat, const float* rois, const uint8_t* mask,
           const int* xs, const int* cw, void* out, int B, int P, int H,
           int W, int C, float scale, int ct, int cw_max,
           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kPooled) * cw_max * ct * T::kItemSize;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_pool_stage_kernel<T, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = static_cast<int64_t>(B) * P * (C / ct);
  roi_pool_stage_kernel<T, STAGE><<<static_cast<unsigned>(blocks), kThreads,
                                    smem, stream>>>(
      static_cast<const typename T::Vec*>(feat), rois, mask, xs, cw,
      static_cast<typename T::Vec*>(out), P, H, W, C / 2, ct / 2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feat, const float* rois, const uint8_t* mask,
             const int* xs, const int* cw, void* out, int B, int P, int H,
             int W, int C, float scale, int stage, int ct, int cw_max,
             void* stream) {
  if (B * P == 0) return 0;
  if (C % 2 || ct < 2 || ct % 2 || C % ct || cw_max < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kWrite:
      return launch<T, kWrite>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                               scale, ct, cw_max, s);
    case kRows:
      return launch<T, kRows>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                              scale, ct, cw_max, s);
    case kRowsCol0:
      return launch<T, kRowsCol0>(feat, rois, mask, xs, cw, out, B, P, H, W,
                                  C, scale, ct, cw_max, s);
    case kCols:
      return launch<T, kCols>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                              scale, ct, cw_max, s);
    case kFull:
      return launch<T, kFull>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                              scale, ct, cw_max, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes. feat [B, H, W, C] contiguous (C even),
// rois [B, P, 4] f32, mask [B, P] bool (1 byte), xs and cw [B, P] int32
// (each roi's window, cw <= cw_max), out [B, P, 7, 7, C] in the feature
// dtype; stage 0..4 = write, rows, rows_col0, cols, full; ct an even
// divisor of C. Returns the cudaError_t of the launch.
extern "C" int roi_pool_stage_bf16(const void* feat, const float* rois,
                                   const uint8_t* mask, const int* xs,
                                   const int* cw, void* out, int B, int P,
                                   int H, int W, int C, float scale,
                                   int stage, int ct, int cw_max,
                                   void* stream) {
  return dispatch<Bf16x2>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                          scale, stage, ct, cw_max, stream);
}

extern "C" int roi_pool_stage_f32(const void* feat, const float* rois,
                                  const uint8_t* mask, const int* xs,
                                  const int* cw, void* out, int B, int P,
                                  int H, int W, int C, float scale,
                                  int stage, int ct, int cw_max,
                                  void* stream) {
  return dispatch<F32x2>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                         scale, stage, ct, cw_max, stream);
}
