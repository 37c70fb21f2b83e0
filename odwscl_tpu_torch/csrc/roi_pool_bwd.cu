// 7x7 RoI max pooling, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces: odwscl_tpu/ops/roi_pool_pallas.py:_bwd_kernel (the Pallas TPU
// kernel behind the custom_vjp of roi_pool_tpu), which reproduces the CUDA
// ROIPool backward:
//   - each bin's cotangent goes whole to the bin's FIRST maximum in
//     row-major order (scan y, then x, with a strict '>', as the forward's
//     running max in roi_pool_fwd.cu does), so ties, bf16 ties included,
//     are routed to one cell and never split;
//   - empty bins, masked rois and bins whose cells are all off the map
//     contribute nothing;
//   - cell rounding and bin edges are the forward's own, integer-exact;
//   - the gradient accumulates in f32; the wrapper casts it to the
//     feature dtype.
// The plain PyTorch version is roi_pool_backward_plain in ops/roi_pool.py.
// Routing is exact; the f32 sums agree up to the order of the atomic adds.
//
// The argmax is recomputed here from (feat, rois, mask), as the JAX
// custom_vjp does (its residuals hold no argmax): a stored int32 argmax
// would be [B, P, 7, 7, C], 1.6 GB at B = 8, P = 2048, C = 512, written by
// the forward and read back here, more bytes than the rescan of the map,
// which mostly hits L2.
//
// Bound: bytes. The least traffic is feat and the cotangent g read once and
// d_feat written once in the feature dtype. At the training shape (feat
// [8, 160, 208, 512] bf16, P = 2048) that is 272 MB + 822 MB + 272 MB. The
// design adds the f32 scratch: zeroed, read-modified-written by the
// atomics, and read once more by the cast.
//
// Design: one block per (image, roi), threads over channel pairs (bf16x2 or
// float2 loads, so a warp reads one contiguous run of the NHWC channel
// axis), as in the forward. Each thread scans each bin keeping (max, cell)
// per channel and adds the cotangent to the winning cell of the f32 scratch
// with one atomicAdd per channel. Blocks of overlapping rois add to the
// same cells in no fixed order, hence the atomics. No shared memory.

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
};

struct F32x2 {
  using Vec = float2;
  static __device__ __forceinline__ float2 to_float2(Vec v) { return v; }
};

__device__ __forceinline__ int round_cell(float x, float scale) {
  // two roundings, as the forward computes it; no fused multiply-add
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(x, scale), 0.5f)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <typename T>
__global__ void roi_pool_bwd_kernel(const typename T::Vec* __restrict__ feat,
                                    const float* __restrict__ rois,
                                    const uint8_t* __restrict__ mask,
                                    const typename T::Vec* __restrict__ grad,
                                    float* __restrict__ dfeat,
                                    int P, int H, int W, int C2,
                                    float scale) {
  const int roi = blockIdx.x;  // b * P + p
  if (!mask[roi]) return;
  const int b = roi / P;
  const int C = 2 * C2;

  const float* r = rois + static_cast<int64_t>(roi) * 4;
  const int x1 = round_cell(r[0], scale);
  const int y1 = round_cell(r[1], scale);
  const int x2 = round_cell(r[2], scale);
  const int y2 = round_cell(r[3], scale);
  const int roi_w = max(x2 - x1 + 1, 1);
  const int roi_h = max(y2 - y1 + 1, 1);
  const typename T::Vec* fimg = feat + static_cast<int64_t>(b) * H * W * C2;
  float* dimg = dfeat + static_cast<int64_t>(b) * H * W * C;
  const typename T::Vec* g_roi =
      grad + static_cast<int64_t>(roi) * kPooled * kPooled * C2;

  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    for (int ph = 0; ph < kPooled; ++ph) {
      const int hs = clampi(ph * roi_h / kPooled + y1, 0, H);
      const int he = clampi(((ph + 1) * roi_h + kPooled - 1) / kPooled + y1,
                            0, H);
      if (he <= hs) continue;
      for (int pw = 0; pw < kPooled; ++pw) {
        const int ws = clampi(pw * roi_w / kPooled + x1, 0, W);
        const int we = clampi(((pw + 1) * roi_w + kPooled - 1) / kPooled + x1,
                              0, W);
        if (we <= ws) continue;
        const float2 g = T::to_float2(g_roi[(ph * kPooled + pw) * C2 + c]);
        if (g.x == 0.f && g.y == 0.f) continue;
        float2 m = make_float2(-INFINITY, -INFINITY);
        int64_t ax = -1, ay = -1;  // winning cell (y * W + x) per channel
        for (int y = hs; y < he; ++y) {
          const typename T::Vec* row =
              fimg + (static_cast<int64_t>(y) * W) * C2 + c;
          for (int x = ws; x < we; ++x) {
            const float2 v = T::to_float2(row[static_cast<int64_t>(x) * C2]);
            const int64_t cell = static_cast<int64_t>(y) * W + x;
            if (v.x > m.x) { m.x = v.x; ax = cell; }
            if (v.y > m.y) { m.y = v.y; ay = cell; }
          }
        }
        if (ax >= 0 && g.x != 0.f) atomicAdd(dimg + ax * C + 2 * c, g.x);
        if (ay >= 0 && g.y != 0.f) atomicAdd(dimg + ay * C + 2 * c + 1, g.y);
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const float* rois, const uint8_t* mask,
           const void* grad, float* dfeat, int B, int P, int H, int W, int C,
           float scale, void* stream) {
  if (B * P == 0) return 0;
  const int c2 = C / 2;
  int threads = ((c2 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  roi_pool_bwd_kernel<T><<<B * P, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename T::Vec*>(feat), rois, mask,
      static_cast<const typename T::Vec*>(grad), dfeat, P, H, W, c2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. feat [B, H, W, C] contiguous (C even),
// rois [B, P, 4] f32, mask [B, P] bool (1 byte), grad [B, P, 7, 7, C] in the
// feature dtype, dfeat [B, H, W, C] f32 zeroed by the caller (accumulated
// into). Returns the cudaError_t of the launch.
extern "C" int roi_pool_bwd_bf16(const void* feat, const float* rois,
                                 const uint8_t* mask, const void* grad,
                                 float* dfeat, int B, int P, int H, int W,
                                 int C, float scale, void* stream) {
  return launch<Bf16x2>(feat, rois, mask, grad, dfeat, B, P, H, W, C, scale,
                        stream);
}

extern "C" int roi_pool_bwd_f32(const void* feat, const float* rois,
                                const uint8_t* mask, const void* grad,
                                float* dfeat, int B, int P, int H, int W,
                                int C, float scale, void* stream) {
  return launch<F32x2>(feat, rois, mask, grad, dfeat, B, P, H, W, C, scale,
                       stream);
}
