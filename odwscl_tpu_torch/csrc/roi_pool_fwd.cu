// 7x7 RoI max pooling, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces: odwscl_tpu/ops/roi_pool_pallas.py:_fwd_kernel (the Pallas TPU
// kernel behind roi_pool_tpu), which reproduces the CUDA ROIPool semantics:
//   - cell coordinates are floor(x * scale + 0.5) in f32;
//   - malformed rois (x2 < x1 or y2 < y1) are forced to 1x1 cells;
//   - bin (ph, pw) covers rows [floor(ph*h/7), ceil((ph+1)*h/7)) + y1 and
//     the same for columns, in integer arithmetic, clipped to the map;
//   - empty bins and masked rois give 0.
// The plain PyTorch version is roi_pool_plain in ops/roi_pool.py; the two
// agree bit-exactly (max selects one of the inputs; no arithmetic on them).
//
// Bound: bytes. The least traffic is the feature map read once plus the
// [B, P, 7, 7, C] output written once: at the main-path shape
// (feat [8, 104, 168, 512] bf16, P = 2048) that is 143 MB + 822 MB, about
// 0.29 ms at an H100 SXM's 3.35 TB/s. The comparisons (one per scanned cell
// and channel) are far below the card's rate.
//
// Design for that bound: one block per (image, roi), threads over channels,
// two channels per thread (bf16x2 or float2), so every load and store of a
// warp is one contiguous run along the NHWC channel axis. Each thread
// derives the roi's cell box and all 49 bin edges in integers and scans
// each bin with a running max; nothing is staged in shared memory. The
// output is written exactly once. Cells of overlapping rois are re-read,
// and consecutive blocks pool rois of the same image, so those re-reads
// mostly hit L2 (one image's map is 18 MB at the main-path shape). The
// map is read from device memory directly, so any map and roi size is
// accepted: unlike the TPU kernel there is no VMEM feasibility gate and no
// fallback. No argmax is stored; the backward comes with the training path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;

struct Bf16x2 {
  using Vec = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_float2(Vec v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ Vec from_float2(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);  // exact: v holds bf16 values
  }
};

struct F32x2 {
  using Vec = float2;
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

template <typename T>
__global__ void roi_pool_fwd_kernel(const typename T::Vec* __restrict__ feat,
                                    const float* __restrict__ rois,
                                    const uint8_t* __restrict__ mask,
                                    typename T::Vec* __restrict__ out,
                                    int P, int H, int W, int C2,
                                    float scale) {
  const int roi = blockIdx.x;  // b * P + p
  const int b = roi / P;
  typename T::Vec* out_roi =
      out + static_cast<int64_t>(roi) * kPooled * kPooled * C2;
  const float2 zero = make_float2(0.f, 0.f);

  if (!mask[roi]) {
    for (int c = threadIdx.x; c < C2; c += blockDim.x)
      for (int bin = 0; bin < kPooled * kPooled; ++bin)
        out_roi[bin * C2 + c] = T::from_float2(zero);
    return;
  }

  const float* r = rois + static_cast<int64_t>(roi) * 4;
  const int x1 = round_cell(r[0], scale);
  const int y1 = round_cell(r[1], scale);
  const int x2 = round_cell(r[2], scale);
  const int y2 = round_cell(r[3], scale);
  const int roi_w = max(x2 - x1 + 1, 1);
  const int roi_h = max(y2 - y1 + 1, 1);
  const typename T::Vec* fimg =
      feat + static_cast<int64_t>(b) * H * W * C2;

  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    for (int ph = 0; ph < kPooled; ++ph) {
      const int hs = clampi(ph * roi_h / kPooled + y1, 0, H);
      const int he = clampi(((ph + 1) * roi_h + kPooled - 1) / kPooled + y1,
                            0, H);
      for (int pw = 0; pw < kPooled; ++pw) {
        const int ws = clampi(pw * roi_w / kPooled + x1, 0, W);
        const int we = clampi(((pw + 1) * roi_w + kPooled - 1) / kPooled + x1,
                              0, W);
        float2 m = zero;
        if (he > hs && we > ws) {
          m = make_float2(-INFINITY, -INFINITY);
          for (int y = hs; y < he; ++y) {
            const typename T::Vec* row =
                fimg + (static_cast<int64_t>(y) * W) * C2 + c;
            for (int x = ws; x < we; ++x) {
              const float2 v = T::to_float2(row[static_cast<int64_t>(x) * C2]);
              m.x = v.x > m.x ? v.x : m.x;
              m.y = v.y > m.y ? v.y : m.y;
            }
          }
        }
        out_roi[(ph * kPooled + pw) * C2 + c] = T::from_float2(m);
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const float* rois, const uint8_t* mask,
           void* out, int B, int P, int H, int W, int C, float scale,
           void* stream) {
  if (B * P == 0) return 0;
  const int c2 = C / 2;
  int threads = ((c2 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  roi_pool_fwd_kernel<T><<<B * P, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename T::Vec*>(feat), rois, mask,
      static_cast<typename T::Vec*>(out), P, H, W, c2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. feat [B, H, W, C] contiguous (C even),
// rois [B, P, 4] f32, mask [B, P] bool (1 byte), out [B, P, 7, 7, C] in the
// feature dtype. Returns the cudaError_t of the launch.
extern "C" int roi_pool_fwd_bf16(const void* feat, const float* rois,
                                 const uint8_t* mask, void* out, int B, int P,
                                 int H, int W, int C, float scale,
                                 void* stream) {
  return launch<Bf16x2>(feat, rois, mask, out, B, P, H, W, C, scale, stream);
}

extern "C" int roi_pool_fwd_f32(const void* feat, const float* rois,
                                const uint8_t* mask, void* out, int B, int P,
                                int H, int W, int C, float scale,
                                void* stream) {
  return launch<F32x2>(feat, rois, mask, out, B, P, H, W, C, scale, stream);
}
