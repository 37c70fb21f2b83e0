// Two designs of the 7x7 RoI max pooling forward that use a spatial roi
// order, kept to be timed against csrc/roi_pool_fwd.cu (PERF.md):
//   - kStagedRun > 0: cross-roi reuse made explicit. A block takes a run of
//     kStagedRun neighbouring rois and stages the union of their windows in
//     shared memory, in row bands with cp.async into two buffers;
//   - kStagedRun = 0: the shipped kernel's direct loads, its runs of kRun
//     rois taken in the spatial order instead of the given order.
// This is not a standalone source: odwscl_tpu_torch/tools/tune_roi_pool.py
// appends it to csrc/roi_pool_fwd.cu (whose Shape, Bins and helpers it
// uses) and builds the two as one variant. Both designs give the shipped
// kernel's output and argmax bit for bit; the order only decides which
// rois a block pools together. bf16 only.

namespace {

constexpr int kStagedRun = 4;          // rois per block (0: direct loads)
constexpr int kBandBytes = 64 * 1024;  // map bytes per band buffer
constexpr int kOrderThreads = 1024;
constexpr int kOrderBins = 8192;  // keys of the roi order (32 KB)
constexpr int kOrderCell = 16;    // map cells a side of a coarse cell

template <typename T>
struct Staged {
  static constexpr int kPerRoi = Shape<T>::kPerRoi;
  static constexpr int kRois =
      kStagedRun * kPerRoi > 1024 ? 1024 / kPerRoi : kStagedRun;
  static constexpr int kThreads = kPerRoi * (kRois > 0 ? kRois : 1);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Staged in shared memory. Grid (images x runs of kStagedRun rois of the
// image in `order`, channel tiles). The block stages the union of its
// rois' windows, `band_cells / width` rows at a time, with cp.async into
// two buffers of band_cells cells (the next band loads while this one is
// pooled); each thread carries its bins' maxima from band to band.
template <typename T, bool ARGMAX>
__global__ void __launch_bounds__(Staged<T>::kThreads)
roi_pool_fwd_staged_kernel(const uint4* __restrict__ feat,
                           const float* __restrict__ rois,
                           const uint8_t* __restrict__ mask,
                           const int* __restrict__ order,
                           uint4* __restrict__ out,
                           uint32_t* __restrict__ argmax, int P, int H,
                           int W, int CV, float scale, int band_cells) {
  using S = Shape<T>;
  constexpr int R = Staged<T>::kRois;
  constexpr int L = S::kLanes;
  extern __shared__ uint4 band[];  // [2][band_cells][kLanes]
  __shared__ int4 win[R];          // x0, y0, x1, y1 of each roi's window
  const int lane = threadIdx.x;
  const int cv = blockIdx.y * L + lane;
  const int pw = threadIdx.y;
  const int ph0 = threadIdx.z % S::kGroups * kGroup;
  const int slot = threadIdx.z / S::kGroups;
  const int tid = lane + L * (pw + 8 * threadIdx.z);
  const int runs = (P + R - 1) / R;
  const int b = blockIdx.x / runs;
  const int p = (blockIdx.x - b * runs) * R + slot;
  const int roi = p < P ? order[b * P + p] : 0;  // image b's rois come first
  const bool live = p < P && mask[roi];
  Bins<T> s(rois, live, roi, ph0, min(pw, kPooled - 1), H, W, scale);

  if (tid % S::kPerRoi == 0) {  // the slot's first thread
    int4 w = make_int4(W, H, 0, 0);  // empty
    if (live) {
      const float* r = rois + static_cast<int64_t>(roi) * 4;
      const int x1 = round_cell(r[0], scale);
      const int y1 = round_cell(r[1], scale);
      const int roi_w = max(round_cell(r[2], scale) - x1 + 1, 1);
      const int roi_h = max(round_cell(r[3], scale) - y1 + 1, 1);
      const int4 v = make_int4(bin_lo(0, roi_w, x1, W), bin_lo(0, roi_h, y1, H),
                               bin_hi(kPooled - 1, roi_w, x1, W),
                               bin_hi(kPooled - 1, roi_h, y1, H));
      if (v.x < v.z && v.y < v.w) w = v;
    }
    win[slot] = w;
  }
  __syncthreads();
  int x0 = W, y0 = H, x1 = 0, y1 = 0;  // the union of the windows
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int4 w = win[k];
    x0 = min(x0, w.x);
    y0 = min(y0, w.y);
    x1 = max(x1, w.z);
    y1 = max(y1, w.w);
  }
  const int width = x1 - x0;
  const int rows = width > 0 ? band_cells / width : 0;  // band_cells >= W
  const int bands = width > 0 ? (y1 - y0 + rows - 1) / rows : 0;
  const uint4* img = feat + static_cast<int64_t>(b) * H * W * CV;

  auto stage = [&](int k) {
    uint4* dst = band + (k & 1) * band_cells * L;
    const int yb = y0 + k * rows;
    const int n = min(rows, y1 - yb) * width * L;
    for (int i = tid; i < n; i += Staged<T>::kThreads) {
      const int cell = i / L, l = i - cell * L;
      const int yy = cell / width;
      const int c = blockIdx.y * L + l;
      cp_async16(dst + i,
                 c < CV ? img + (static_cast<int64_t>(yb + yy) * W + x0 +
                                 cell - yy * width) * CV + c
                        : img,
                 c < CV);
    }
    cp_async_commit();
  };

  const bool work = pw < kPooled && cv < CV && s.we > s.ws;
  if (bands > 0) stage(0);
  for (int k = 0; k < bands; ++k) {
    if (k + 1 < bands)
      stage(k + 1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    const int yb = y0 + k * rows;
    if (work) {
      const uint4* src = band + ((k & 1) * band_cells + s.ws - x0) * L + lane;
      const int ye = min(s.y_end, yb + rows);
      for (int y = max(s.hs[0], yb); y < ye; ++y)
        s.template row<ARGMAX, false>(src + (y - yb) * width * L, L, y);
    }
    __syncthreads();  // the buffer is free for band k + 2
  }
  if (p < P && pw < kPooled && cv < CV)
    s.template store<ARGMAX>(out, argmax, out_vec(roi, ph0, pw, CV, cv), CV);
}

// The shipped kernel's loop over runs of kRun rois, in `order`.
template <typename T, bool ARGMAX>
__global__ void __launch_bounds__(Shape<T>::kThreads)
roi_pool_fwd_sorted_kernel(const uint4* __restrict__ feat,
                           const float* __restrict__ rois,
                           const uint8_t* __restrict__ mask,
                           const int* __restrict__ order,
                           uint4* __restrict__ out,
                           uint32_t* __restrict__ argmax, int N, int P,
                           int H, int W, int CV, float scale) {
  using S = Shape<T>;
  const int cv = blockIdx.y * S::kLanes + threadIdx.x;
  const int pw = threadIdx.y;
  const int ph0 = threadIdx.z % S::kGroups * kGroup;
  const int slot = threadIdx.z / S::kGroups;
  if (pw >= kPooled || cv >= CV) return;
  const int64_t row_stride = static_cast<int64_t>(W) * CV;
  const int end = min(N, static_cast<int>(blockIdx.x + 1) * kRun);
  for (int i = blockIdx.x * kRun + slot; i < end; i += S::kSlots) {
    const int roi = order[i];
    Bins<T> s(rois, mask[roi], roi, ph0, pw, H, W, scale);
    if (s.we > s.ws) {
      const uint4* src =
          feat + (static_cast<int64_t>(roi / P) * H * W + s.ws) * CV + cv;
      for (int y = s.hs[0]; y < s.y_end; ++y)
        s.template row<ARGMAX, true>(src + y * row_stride, CV, y);
    }
    s.template store<ARGMAX>(out, argmax, out_vec(roi, ph0, pw, CV, cv), CV);
  }
}

// One block sorts the rois by key = (image, coarse cell of the roi's centre
// on a grid of `cell` x `cell` map cells, row-major), a counting sort in
// shared memory, and writes the permutation to `order`. Rois of one key
// come in no fixed order: the order only decides which rois a block pools
// together, never a result.
__global__ void __launch_bounds__(kOrderThreads)
roi_order_kernel(const float* __restrict__ rois, int N, int P, int H, int W,
                 float scale, int cell, int gh, int gw,
                 int* __restrict__ order) {
  __shared__ int start[kOrderBins];
  __shared__ int warp_sum[kOrderThreads / 32];
  const int tid = threadIdx.x;
  const int bins = (N / P) * gh * gw;
  auto key = [&](int roi) {
    const float* r = rois + static_cast<int64_t>(roi) * 4;
    const int cx = clampi((round_cell(r[0], scale) + round_cell(r[2], scale))
                          >> 1, 0, W - 1);
    const int cy = clampi((round_cell(r[1], scale) + round_cell(r[3], scale))
                          >> 1, 0, H - 1);
    return ((roi / P) * gh + cy / cell) * gw + cx / cell;
  };
  for (int i = tid; i < bins; i += kOrderThreads) start[i] = 0;
  __syncthreads();
  for (int roi = tid; roi < N; roi += kOrderThreads)
    atomicAdd(&start[key(roi)], 1);
  __syncthreads();
  // exclusive prefix sum: each thread a run of `per` bins, then the runs
  const int per = (bins + kOrderThreads - 1) / kOrderThreads;
  const int lo = min(tid * per, bins), hi = min(lo + per, bins);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += start[i];
  int incl = sum;  // inclusive scan over the threads
  const int lane = tid & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[tid >> 5] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (tid >> 5); ++w) before += warp_sum[w];
  int run = before + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = start[i];
    start[i] = run;
    run += c;
  }
  __syncthreads();
  for (int roi = tid; roi < N; roi += kOrderThreads)
    order[atomicAdd(&start[key(roi)], 1)] = roi;
}

template <typename T, bool ARGMAX>
cudaError_t launch_staged(const uint4* f, const float* rois,
                          const uint8_t* mask, const int* order, uint4* o,
                          uint32_t* a, int B, int P, int H, int W, int cv,
                          float scale, cudaStream_t s) {
  using S = Shape<T>;
  const int cells = max(kBandBytes / (S::kLanes * 16), W);
  const size_t smem = 2 * static_cast<size_t>(cells) * S::kLanes * 16;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const auto kernel = roi_pool_fwd_staged_kernel<T, ARGMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(S::kLanes, 8, S::kGroups * Staged<T>::kRois);
  const dim3 grid(B * ((P + Staged<T>::kRois - 1) / Staged<T>::kRois),
                  (cv + S::kLanes - 1) / S::kLanes);
  kernel<<<grid, block, smem, s>>>(f, rois, mask, order, o, a, P, H, W, cv,
                                   scale, cells);
  return cudaGetLastError();
}

template <typename T, bool ARGMAX>
cudaError_t launch_ordered(const void* feat, const float* rois,
                           const uint8_t* mask, int* order, void* out,
                           void* argmax, int B, int P, int H, int W, int C,
                           float scale, cudaStream_t s) {
  if (C % 8 || B > kOrderBins) return cudaErrorInvalidValue;
  const int n = B * P;
  int cell = kOrderCell, gh, gw;
  for (;; cell *= 2) {
    gh = (H + cell - 1) / cell;
    gw = (W + cell - 1) / cell;
    if (static_cast<int64_t>(B) * gh * gw <= kOrderBins) break;
  }
  roi_order_kernel<<<1, kOrderThreads, 0, s>>>(rois, n, P, H, W, scale, cell,
                                               gh, gw, order);
  using S = Shape<T>;
  const int cv = C / T::kVec;
  const auto* f = static_cast<const uint4*>(feat);
  auto* o = static_cast<uint4*>(out);
  auto* a = static_cast<uint32_t*>(argmax);
  if constexpr (Staged<T>::kRois > 0) {
    return launch_staged<T, ARGMAX>(f, rois, mask, order, o, a, B, P, H, W,
                                    cv, scale, s);
  } else {
    const dim3 block(S::kLanes, 8, S::kGroups * S::kSlots);
    const dim3 grid((n + kRun - 1) / kRun, (cv + S::kLanes - 1) / S::kLanes);
    roi_pool_fwd_sorted_kernel<T, ARGMAX><<<grid, block, 0, s>>>(
        f, rois, mask, order, o, a, n, P, H, W, cv, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// As roi_pool_fwd_bf16, with an int32 [B * P] scratch for the roi order.
extern "C" int roi_pool_fwd_ordered_bf16(const void* feat, const float* rois,
                                         const uint8_t* mask, int* order,
                                         void* out, void* argmax, int B,
                                         int P, int H, int W, int C,
                                         float scale, void* stream) {
  if (B * P == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      argmax ? launch_ordered<Bf16, true>(feat, rois, mask, order, out,
                                          argmax, B, P, H, W, C, scale, s)
             : launch_ordered<Bf16, false>(feat, rois, mask, order, out,
                                           argmax, B, P, H, W, C, scale, s));
}
