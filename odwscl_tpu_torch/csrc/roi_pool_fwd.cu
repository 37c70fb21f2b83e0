// 7x7 RoI max pooling, forward, for NVIDIA Hopper (sm_90a), with and
// without the argmax.
//
// Replaces: odwscl_tpu/ops/roi_pool_pallas.py:_fwd_kernel (:245, the
// Pallas TPU kernel behind roi_pool_tpu), which reproduces the CUDA ROIPool
// semantics:
//   - cell coordinates are floor(x * scale + 0.5) in f32;
//   - malformed rois (x2 < x1 or y2 < y1) are forced to 1x1 cells;
//   - bin (ph, pw) covers rows [floor(ph*h/7), ceil((ph+1)*h/7)) + y1 and
//     the same for columns, in integer arithmetic, clipped to the map;
//   - empty bins and masked rois give 0.
// The training instantiation (ARGMAX) also writes, per output element, the
// code of the bin's FIRST maximum in row-major order (y, then x, strict
// '>'): its offset (y - hs) * (we - ws) + (x - ws) inside the bin, read as
// unsigned, or -1 (all ones) for an empty bin, a masked roi or a bin of
// -inf only. The reference CUDA ROIPool stores the argmax the same way;
// csrc/roi_pool_bwd.cu routes the cotangent by it. A bin clipped to the map
// can span the whole map, so the code's width follows the map: int16 codes
// (Narrow) while H * W <= 65535, int32 codes (Wide) above, e.g. FPN P2 of
// an 800x1344 canvas (200x336 = 67,200 cells); the caller picks one from
// the map's shape. The plain
// PyTorch versions are roi_pool_plain and roi_pool_argmax_plain in
// ops/roi_pool.py; both agree bit-exactly (max selects one of the inputs,
// the codes are integers).
//
// Bound: bytes. The least traffic is each map cell that the output depends
// on read once, plus the [B, P, 7, 7, C] output (and the argmax) written
// once: at the eval shape (feat [8, 104, 168, 512] bf16, P = 2048) 956.8
// MB, 0.2856 ms at an H100 SXM's 3.35 TB/s (stage_work in
// ops/roi_pool_stages.py). The comparisons are far below the card's rate.
//
// What held the first design back (one block per roi, threads over channel
// pairs, every bin scanned on its own with a float compare per channel): it
// loaded 8.22 GB of bin cells at that shape, 61x the map that the rois
// cover, mostly from L2, and ran at 12.3% of the bound. This design:
//   - Channel tile of 64 and 16-byte loads: 8 (bf16) or 16 (f32) lanes
//     cover the tile's 128 or 256 bytes of a cell.
//   - Rows read once per thread: the thread of (roi, column bin pw, kGroup
//     = 2 row bins, 16 bytes of channels) walks its bins' rows once; per
//     row it takes the max over the column bin, then folds it into the row
//     bins that hold it (a row shared by the two bins is loaded once).
//     The maxima are packed: one bf16x2 max (__hmax2) or f32 max per two
//     or one channels. With ARGMAX, a packed compare mask (__hgt2_mask)
//     keeps, per channel, the first column of the row max and then the
//     first row of the bin max (strict '>', in order): the first row-major
//     maximum, as 16-bit offsets two to a word (Wide: the mask's halves
//     spread to one 32-bit offset a word). Two row bins per thread
//     (not all seven) keep the chain of dependent row loads short and the
//     registers at 64, four blocks to an SM.
//   - A block pools kRun = 4 consecutive rois, one at a time; the output
//     (and the argmax) is written once, with 16-byte stores.
// Reuse of the map across rois is left to L1 and L2. Two designs that order
// the rois spatially (a counting sort on the card) were timed against this
// one (odwscl_tpu_torch/tools/roi_pool_fwd_ordered.cu): the same loads over
// runs of neighbouring rois, 4-12% slower at a training step's batches;
// and runs of neighbouring rois whose windows are staged in shared memory
// with cp.async, 2.5x slower, as each band of rows is a barrier at which
// the threads whose bins miss it idle. kGroup, kRun, the loads in flight
// (kUnroll, kUnrollArgmax) and the block size were picked on the card at
// the batches of the six train scales
// (odwscl_tpu_torch/tools/tune_roi_pool.py; readings in PERF.md).
// The map is read from device memory directly, so any map and roi size is
// accepted: unlike the TPU kernel there is no VMEM feasibility gate.
//
// The stage profiler (roi_pool_stage_bf16/_f32) is this kernel cut by
// rectangle. It replaces the TPU profiling kernels built from the blocks
// of the Pallas forward: tools/profile_pool.py:_fwd_rows_only (:61) and
// _fwd_cols_only (:89), and tools/profile_pool_stages.py:make_kernel (:35).
// Each STAGE gives output bin (ph, pw) of a live roi another rectangle,
// over which the thread runs the same row walk and store (Bins::cut), with
// the same launch shape, so each stage times a part of this loop:
//   write      no rectangle: the store path alone (zeros);
//   rows       rows of row bin ph x columns [xs, xs + 8), for every pw;
//   rows_col0  rows of row bin ph x column xs;
//   cols       map row ph x the columns of bin pw inside [xs, xs + cw);
//   full       the forward itself (this kernel's eval instantiation).
// (xs, cw) is the roi's column window as the TPU kernel plans it
// (ops/roi_pool_stages.py:tpu_windows). The TPU reads a zero-padded map; the
// pad enters only where a rows stage's columns reach past W (the window
// plan allows it on maps narrower than 8 columns): the running max of a
// bin with rows then starts at +0 (a cols row past H holds only zeros,
// which an empty rectangle gives too). The plain version of every
// stage is roi_pool_stage_plain, and stage_edges there spells out these
// rectangles; they agree bit-exactly. Bound: bytes, as for the forward
// (stage_work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;
constexpr int kTileC = 64;  // channels per block
constexpr int kGroup = 2;   // row bins per thread
constexpr int kMinThreads = 256;  // threads per block, at least
constexpr int kRun = 4;     // consecutive rois per block
constexpr int kUnroll = 4;  // loads in flight per thread: eval forward
constexpr int kUnrollArgmax = 2;  // and training forward

// the stage profiler's stages, in the order of ops/roi_pool_stages.py:STAGES
enum Stage { kWrite = 0, kRows = 1, kRowsCol0 = 2, kCols = 3, kFull = 4 };

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes of the NHWC channel axis (8 bf16 or 4 f32 values) as 4 words,
// and the int16 codes of those channels as kWords words of two codes.
// vmax is the elementwise max; gt(a, b, i) is the mask of the codes of
// word i whose channels have a > b (0xFFFF per code).
struct Bf16 {
  static constexpr int kVec = 8;
  static constexpr int kWords = 4;
  static constexpr uint32_t kNeg = 0xff80ff80u;  // two bf16 -inf
  static __device__ __forceinline__ __nv_bfloat162 h2(uint32_t w) {
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
  }
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    uint4 o;
    const __nv_bfloat162 x = __hmax2(h2(a.x), h2(b.x));
    const __nv_bfloat162 y = __hmax2(h2(a.y), h2(b.y));
    const __nv_bfloat162 z = __hmax2(h2(a.z), h2(b.z));
    const __nv_bfloat162 w = __hmax2(h2(a.w), h2(b.w));
    o.x = *reinterpret_cast<const uint32_t*>(&x);
    o.y = *reinterpret_cast<const uint32_t*>(&y);
    o.z = *reinterpret_cast<const uint32_t*>(&z);
    o.w = *reinterpret_cast<const uint32_t*>(&w);
    return o;
  }
  static __device__ __forceinline__ uint32_t gt(const uint4& a,
                                                const uint4& b, int i) {
    return __hgt2_mask(h2(word(a, i)), h2(word(b, i)));
  }
};

struct F32 {
  static constexpr int kVec = 4;
  static constexpr int kWords = 2;
  static constexpr uint32_t kNeg = 0xff800000u;  // -inf
  static __device__ __forceinline__ float f(const uint4& v, int k) {
    return __uint_as_float(word(v, k));
  }
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(__float_as_uint(fmaxf(f(a, 0), f(b, 0))),
                      __float_as_uint(fmaxf(f(a, 1), f(b, 1))),
                      __float_as_uint(fmaxf(f(a, 2), f(b, 2))),
                      __float_as_uint(fmaxf(f(a, 3), f(b, 3))));
  }
  static __device__ __forceinline__ uint32_t gt(const uint4& a,
                                                const uint4& b, int i) {
    return (f(a, 2 * i) > f(b, 2 * i) ? 0x0000ffffu : 0u) |
           (f(a, 2 * i + 1) > f(b, 2 * i + 1) ? 0xffff0000u : 0u);
  }
};

__device__ __forceinline__ uint32_t pick(uint32_t old, uint32_t neu,
                                         uint32_t mask) {
  return (old & ~mask) | (neu & mask);
}

// The argmax codes of one 16-byte vector of channels: kWords<T> words,
// kSpread puts a value in every code of a word, and mask<T>(a, b, w) is the
// mask of the codes of word w whose channels have a > b.
struct Narrow {  // int16 codes, two to a word (channel 2i in the low half)
  template <typename T>
  static constexpr int kWords = T::kWords;
  static constexpr uint32_t kSpread = 0x10001u;
  template <typename T>
  static __device__ __forceinline__ uint32_t mask(const uint4& a,
                                                  const uint4& b, int w) {
    return T::gt(a, b, w);
  }
};

struct Wide {  // int32 codes, one to a word
  template <typename T>
  static constexpr int kWords = 2 * T::kWords;
  static constexpr uint32_t kSpread = 1u;
  template <typename T>
  static __device__ __forceinline__ uint32_t mask(const uint4& a,
                                                  const uint4& b, int w) {
    return 0u - ((T::gt(a, b, w >> 1) >> (16 * (w & 1))) & 1u);
  }
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

// Threads per roi and channel tile: kLanes (16-byte vectors of the tile) x
// 8 (the column bin pw; pw = 7 idles, so that no warp mixes two rois) x
// kGroups (the thread's kGroup row bins). A block pools kSlots rois at a
// time, kRun in all; grid (runs of kRun rois, channel tiles).
template <typename T>
struct Shape {
  static constexpr int kLanes = kTileC / T::kVec;
  static constexpr int kGroups = (kPooled + kGroup - 1) / kGroup;
  static constexpr int kPerRoi = kLanes * 8 * kGroups;
  static constexpr int kSlots = kPerRoi >= kMinThreads ? 1
                                                       : kMinThreads / kPerRoi;
  static constexpr int kThreads = kPerRoi * kSlots;
};

// One thread's share of a roi: row bins ph0 .. ph0 + nph - 1 ([hs, he)),
// column bin [ws, we), and their running maxima and argmax codes.
template <typename T, typename Code = Narrow>
struct Bins {
  static constexpr int kCodeWords = Code::template kWords<T>;
  int hs[kGroup], he[kGroup], nph, ws, we, y_end;
  uint4 m[kGroup];
  uint32_t code[kGroup][kCodeWords];

  __device__ __forceinline__ Bins(const float* rois, bool live, int roi,
                                  int ph0, int pw, int H, int W,
                                  float scale) {
    nph = min(kGroup, kPooled - ph0);
    ws = we = y_end = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      hs[j] = he[j] = 0;
      m[j] = make_uint4(T::kNeg, T::kNeg, T::kNeg, T::kNeg);
#pragma unroll
      for (int w = 0; w < kCodeWords; ++w) code[j][w] = 0xffffffffu;
    }
    if (!live) return;
    const float* r = rois + static_cast<int64_t>(roi) * 4;
    const int x1 = round_cell(r[0], scale);
    const int y1 = round_cell(r[1], scale);
    const int roi_w = max(round_cell(r[2], scale) - x1 + 1, 1);
    const int roi_h = max(round_cell(r[3], scale) - y1 + 1, 1);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < nph) {
        hs[j] = bin_lo(ph0 + j, roi_h, y1, H);
        he[j] = bin_hi(ph0 + j, roi_h, y1, H);
        y_end = he[j];
      }
    }
    ws = bin_lo(pw, roi_w, x1, W);
    we = bin_hi(pw, roi_w, x1, W);
  }

  // A stage's rectangles in place of the bins' (see the file's head), for
  // a live roi whose column window is [xs, xs + cw).
  template <int STAGE>
  __device__ __forceinline__ void cut(int xs, int cw, int ph0, int H,
                                      int W) {
    if constexpr (STAGE == kCols) {
      ws = max(ws, xs);
      we = min(we, xs + cw);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < nph) {
          hs[j] = min(ph0 + j, H);
          he[j] = min(ph0 + j + 1, H);
          y_end = he[j];
        }
      }
    } else {
      constexpr int kSpan = STAGE == kRows ? 8 : 1;
      ws = min(xs, W);
      we = min(xs + kSpan, W);
      if (xs + kSpan > W) {  // columns of the zero pad right of the map
#pragma unroll
        for (int j = 0; j < kGroup; ++j) m[j] = make_uint4(0, 0, 0, 0);
      }
    }
  }

  // Row y of the column bin: its we - ws cells from p, `stride` vectors
  // apart, read from device memory (GLOBAL) or from the shared memory of
  // the staged design (tools/roi_pool_fwd_ordered.cu).
  template <bool ARGMAX, bool GLOBAL>
  __device__ __forceinline__ void row(const uint4* p, int stride, int y) {
    constexpr int kWords = kCodeWords;
    constexpr int kLoads = ARGMAX ? kUnrollArgmax : kUnroll;
    const int bw = we - ws;
    // the row's max over the column bin, and per channel the first column
    // that reaches it (one per code of a word)
    uint4 r = make_uint4(T::kNeg, T::kNeg, T::kNeg, T::kNeg);
    uint32_t rx[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) rx[w] = 0;
    for (int x0 = 0; x0 < bw; x0 += kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (x0 + u >= bw) continue;
        if constexpr (GLOBAL)
          v[u] = __ldg(p + (x0 + u) * stride);
        else
          v[u] = p[(x0 + u) * stride];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (x0 + u >= bw) break;
        if constexpr (ARGMAX) {
          const uint32_t xx = static_cast<uint32_t>(x0 + u) * Code::kSpread;
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            rx[w] = pick(rx[w], xx, Code::template mask<T>(v[u], r, w));
        }
        r = T::vmax(r, v[u]);
      }
    }
    // fold the row into the row bins that hold it: a strict '>' over rows
    // in order keeps the first row-major maximum
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j >= nph || y < hs[j] || y >= he[j]) continue;
      if constexpr (ARGMAX) {
        const uint32_t off =
            static_cast<uint32_t>((y - hs[j]) * bw) * Code::kSpread;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          code[j][w] = pick(code[j][w], rx[w] + off,
                            Code::template mask<T>(r, m[j], w));
      }
      m[j] = T::vmax(m[j], r);
    }
  }

  // the output (and argmax) vectors of the thread's bins; e0 indexes the
  // vector of bin (ph0, pw)
  template <bool ARGMAX>
  __device__ __forceinline__ void store(uint4* out, uint32_t* argmax,
                                        int64_t e0, int CV) const {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j >= nph) break;
      const int64_t e = e0 + static_cast<int64_t>(j) * kPooled * CV;
      const bool empty = he[j] <= hs[j] || we <= ws;  // masked: all empty
      out[e] = empty ? make_uint4(0, 0, 0, 0) : m[j];
      if constexpr (ARGMAX) {
        // the vector's codes: 2 words (Narrow f32), 4 or 8 (Wide bf16)
        if constexpr (kCodeWords % 4 == 0) {
          constexpr int kQuads = kCodeWords / 4;
#pragma unroll
          for (int q = 0; q < kQuads; ++q)
            reinterpret_cast<uint4*>(argmax)[e * kQuads + q] =
                make_uint4(code[j][4 * q], code[j][4 * q + 1],
                           code[j][4 * q + 2], code[j][4 * q + 3]);
        } else {
          reinterpret_cast<uint2*>(argmax)[e] =
              make_uint2(code[j][0], code[j][1]);
        }
      }
    }
  }
};

__device__ __forceinline__ int64_t out_vec(int roi, int ph, int pw, int CV,
                                           int cv) {
  return (static_cast<int64_t>(roi) * kPooled * kPooled + ph * kPooled + pw)
             * CV + cv;
}

// xs, cw: the rois' column windows, read by the rows and cols stages only
template <typename T, bool ARGMAX, int STAGE = kFull, typename Code = Narrow>
__global__ void __launch_bounds__(Shape<T>::kThreads)
roi_pool_fwd_kernel(const uint4* __restrict__ feat,
                    const float* __restrict__ rois,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ xs, const int* __restrict__ cw,
                    uint4* __restrict__ out, uint32_t* __restrict__ argmax,
                    int N, int P, int H, int W, int CV, float scale) {
  using S = Shape<T>;
  const int cv = blockIdx.y * S::kLanes + threadIdx.x;
  const int pw = threadIdx.y;
  const int ph0 = threadIdx.z % S::kGroups * kGroup;  // the thread's row bins
  const int slot = threadIdx.z / S::kGroups;
  if (pw >= kPooled || cv >= CV) return;  // no barrier follows
  const int64_t row_stride = static_cast<int64_t>(W) * CV;
  const int end = min(N, static_cast<int>(blockIdx.x + 1) * kRun);

  for (int roi = blockIdx.x * kRun + slot; roi < end; roi += S::kSlots) {
    const bool live = STAGE != kWrite && mask[roi];
    Bins<T, Code> s(rois, live, roi, ph0, pw, H, W, scale);
    if constexpr (STAGE != kWrite && STAGE != kFull) {
      if (live) s.template cut<STAGE>(xs[roi], cw[roi], ph0, H, W);
    }
    if (s.we > s.ws) {
      const uint4* src =
          feat + (static_cast<int64_t>(roi / P) * H * W + s.ws) * CV + cv;
      for (int y = s.hs[0]; y < s.y_end; ++y)
        s.template row<ARGMAX, true>(src + y * row_stride, CV, y);
    }
    s.template store<ARGMAX>(out, argmax, out_vec(roi, ph0, pw, CV, cv), CV);
  }
}

template <typename T, bool ARGMAX, int STAGE = kFull, typename Code = Narrow>
int launch(const void* feat, const float* rois, const uint8_t* mask,
           const int* xs, const int* cw, void* out, void* argmax, int B,
           int P, int H, int W, int C, float scale, void* stream) {
  if (B * P == 0) return 0;
  if (C % 8 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using S = Shape<T>;
  const int n = B * P;
  const int cv = C / T::kVec;
  const dim3 block(S::kLanes, 8, S::kGroups * S::kSlots);
  const dim3 grid((n + kRun - 1) / kRun, (cv + S::kLanes - 1) / S::kLanes);
  roi_pool_fwd_kernel<T, ARGMAX, STAGE, Code>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(feat), rois, mask, xs, cw,
          static_cast<uint4*>(out), static_cast<uint32_t*>(argmax), n, P, H,
          W, cv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* feat, const float* rois, const uint8_t* mask,
               void* out, void* argmax, int B, int P, int H, int W, int C,
               float scale, void* stream) {
  return argmax ? launch<T, true>(feat, rois, mask, nullptr, nullptr, out,
                                  argmax, B, P, H, W, C, scale, stream)
                : launch<T, false>(feat, rois, mask, nullptr, nullptr, out,
                                   nullptr, B, P, H, W, C, scale, stream);
}

template <typename T>
int launch_fwd_wide(const void* feat, const float* rois, const uint8_t* mask,
                    void* out, void* argmax, int B, int P, int H, int W,
                    int C, float scale, void* stream) {
  return launch<T, true, kFull, Wide>(feat, rois, mask, nullptr, nullptr,
                                      out, argmax, B, P, H, W, C, scale,
                                      stream);
}

template <typename T>
int launch_stage(const void* feat, const float* rois, const uint8_t* mask,
                 const int* xs, const int* cw, void* out, int B, int P,
                 int H, int W, int C, float scale, int stage, void* stream) {
  switch (stage) {
    case kWrite:
      return launch<T, false, kWrite>(feat, rois, mask, xs, cw, out, nullptr,
                                      B, P, H, W, C, scale, stream);
    case kRows:
      return launch<T, false, kRows>(feat, rois, mask, xs, cw, out, nullptr,
                                     B, P, H, W, C, scale, stream);
    case kRowsCol0:
      return launch<T, false, kRowsCol0>(feat, rois, mask, xs, cw, out,
                                         nullptr, B, P, H, W, C, scale,
                                         stream);
    case kCols:
      return launch<T, false, kCols>(feat, rois, mask, xs, cw, out, nullptr,
                                     B, P, H, W, C, scale, stream);
    case kFull:
      return launch<T, false, kFull>(feat, rois, mask, xs, cw, out, nullptr,
                                     B, P, H, W, C, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes. feat [B, H, W, C] contiguous (C a
// multiple of 8, 16-byte aligned), rois [B, P, 4] f32, mask [B, P] bool (1
// byte), out [B, P, 7, 7, C] in the feature dtype, argmax [B, P, 7, 7, C]
// int16 or NULL (the eval forward). Returns the cudaError_t of the launch.
extern "C" int roi_pool_fwd_bf16(const void* feat, const float* rois,
                                 const uint8_t* mask, void* out, void* argmax,
                                 int B, int P, int H, int W, int C,
                                 float scale, void* stream) {
  return launch_fwd<Bf16>(feat, rois, mask, out, argmax, B, P, H, W, C,
                          scale, stream);
}

extern "C" int roi_pool_fwd_f32(const void* feat, const float* rois,
                                const uint8_t* mask, void* out, void* argmax,
                                int B, int P, int H, int W, int C,
                                float scale, void* stream) {
  return launch_fwd<F32>(feat, rois, mask, out, argmax, B, P, H, W, C, scale,
                         stream);
}

// The training forward for maps of more than 65535 cells: as
// roi_pool_fwd_*, with argmax [B, P, 7, 7, C] int32 (never NULL).
extern "C" int roi_pool_fwd_wide_bf16(const void* feat, const float* rois,
                                      const uint8_t* mask, void* out,
                                      void* argmax, int B, int P, int H,
                                      int W, int C, float scale,
                                      void* stream) {
  return launch_fwd_wide<Bf16>(feat, rois, mask, out, argmax, B, P, H, W, C,
                               scale, stream);
}

extern "C" int roi_pool_fwd_wide_f32(const void* feat, const float* rois,
                                     const uint8_t* mask, void* out,
                                     void* argmax, int B, int P, int H,
                                     int W, int C, float scale,
                                     void* stream) {
  return launch_fwd_wide<F32>(feat, rois, mask, out, argmax, B, P, H, W, C,
                              scale, stream);
}

// The stage profiler: as roi_pool_fwd_*, without the argmax, plus xs and cw
// [B, P] int32 (each roi's column window; read by the rows, rows_col0 and
// cols stages) and stage 0..4 = write, rows, rows_col0, cols, full.
extern "C" int roi_pool_stage_bf16(const void* feat, const float* rois,
                                   const uint8_t* mask, const int* xs,
                                   const int* cw, void* out, int B, int P,
                                   int H, int W, int C, float scale,
                                   int stage, void* stream) {
  return launch_stage<Bf16>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                            scale, stage, stream);
}

extern "C" int roi_pool_stage_f32(const void* feat, const float* rois,
                                  const uint8_t* mask, const int* xs,
                                  const int* cw, void* out, int B, int P,
                                  int H, int W, int C, float scale,
                                  int stage, void* stream) {
  return launch_stage<F32>(feat, rois, mask, xs, cw, out, B, P, H, W, C,
                           scale, stage, stream);
}

// The launch shape of a dtype of `itemsize` bytes (2: bf16, 4: f32):
// channels per block, rois per block, threads per block.
extern "C" void roi_pool_block_shape(int itemsize, int* shape) {
  const int threads = itemsize == 2 ? Shape<Bf16>::kThreads
                                    : Shape<F32>::kThreads;
  shape[0] = kTileC;
  shape[1] = kRun;
  shape[2] = threads;
}
