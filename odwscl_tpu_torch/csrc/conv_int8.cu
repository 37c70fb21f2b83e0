// int8 3x3 convolution on Hopper's tensor cores, with the dequantize and
// the next layer's quantize fused.
//
// Counterpart of odwscl_tpu/ops/quant.py:58 conv2d_int8, whose int8 x int8
// -> int32 convolution is XLA's conv_general_dilated (:109) and no Pallas
// kernel; PyTorch has no int8 convolution on CUDA. Called through
// odwscl_tpu_torch/ops/quant.py (conv_int8_nhwc, conv_int8_acc).
//
// What it computes, for output pixel m = (b, yo, xo) and channel n:
//   acc[m, n] = sum over taps (ty, tx) and ci of
//               x[b, yo - pad + ty * dil, xo - pad + tx * dil, ci]
//               * w[n, ty, tx, ci]            (int32; 0 outside the map)
// x is NHWC int8 [B, H, W, Cin], w int8 packed [Cout, 3, 3, Cin] (K is
// contiguous for each output channel), the output NHWC [B, Ho, Wo, Cout]
// with Ho = H + 2 pad - 2 dil. The epilogue writes, by output kind:
//   ACC    acc itself (int32), for the bit-exact checks;
//   F32    y = relu?((f32(acc) * scale[n]) + bias[n]) in the JAX package's
//          order (scale = xs * ks formed by the caller; __fmul_rn /
//          __fadd_rn keep nvcc from contracting the two into an FMA);
//   BF16   the same y rounded to bf16;
//   CODES  the next conv's int8 codes of y (static serving):
//          clip(rint(y' / out_scale[n]), -127, 127), y' = y rounded to
//          bf16 first unless the compute dtype is f32, with rint's
//          half-to-even of the correctly rounded quotient, so the codes
//          equal the unfused chain's (dequantize, ReLU, then
//          ops/quant.py:_quantize) bit for bit. out_scale is the next
//          conv's [Cout] per-channel scale, or its per-tensor scale
//          broadcast, followed by its reciprocal. The true division is a
//          branch to a slow path that serialized the epilogue, so the
//          correctly rounded quotient comes from a refined multiply by
//          the reciprocal and its exact remainder (int8_round.cuh).
//
// Bound: operations. The VGG16 layers at the 1200 scale do 0.63-1.26 TOP
// each; the int8 input, the weights and the output (int8 codes, or bf16
// for conv12) come to 0.14-0.82 GB, under the card's int8 ridge (1979
// TOP/s over 3.35 TB/s ~ 590 operations a byte) at every layer; conv2
// (Cin 64) is the closest, ~770 operations a byte with codes out.
//
// Two main loops over one implicit GEMM (M = output pixels, N = Cout,
// K = 9 taps x Cin, stepped one tap and BK channels at a time):
// - wgmma + TMA (tiles 2, 3; the serving path): a block tile is an 8 x 16
//   or 16 x 16 spatial block of one image x 128 output channels. One
//   producer thread issues, for each K step, a 4-D TMA box [1, TH, 16, BK]
//   of the NHWC codes at (b, y0 - pad + ty dil, x0 - pad + tx dil, c0): TMA
//   fills what lies outside the map with zeros, which is the conv's
//   padding at both dilations, never materialized. The weights' box is
//   [128, BK] of the packed [Cout, 9 Cin]. Both land 128-byte swizzled
//   (64-byte for BK = 64, Cin = 64), K-major, the one layout wgmma takes
//   for 8-bit operands. Two consumer warpgroups (setmaxnreg 232; the
//   producer's drops to 40) each run wgmma.m64n128k32.s32.s8.s8 on half
//   of the tile's pixels from shared memory, the int32 sums in registers,
//   through a ring of stages with full (TMA bytes) and empty (one arrival
//   per consumer warpgroup once its wgmma on the stage completed)
//   mbarriers. The grid is persistent (one block an SM walks the tiles,
//   the output channel tiles fastest, so the blocks sharing an input box
//   run together and find it in L2), and the producer fills the next
//   tile's stages while the consumers store the last one's epilogue.
// - mma.sync (tiles 0, 1; the first design, kept for the timing beside
//   it in tools/tune_conv_int8.py and chip_smoke.py): mma.sync.m16n8k32
//   from ldmatrix, through a cp.async ring whose every thread computes the
//   address of each 16 bytes; a tap outside the map is zero-filled by
//   cp.async's source size of 0. It is slower at every VGG16 layer.
#include <cuda.h>          // CUtensorMap; the encoder is fetched at run time
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "int8_round.cuh"

namespace {

using int8_round::clip_code;
using int8_round::rint_quotient;

// What the epilogue writes (the C interface's out_kind).
enum OutKind { kAcc = 0, kF32 = 1, kBf16 = 2, kCodes = 3 };

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  const float* out_scale;   // CODES: the next conv's input scale [Cout],
                            // then its reciprocal [Cout]
  void* out;
  int H, W, Cin, Cout, Ho, Wo, dil, pad, M, B;
  int relu;
  int round_bf16;           // CODES: round y to bf16 before the quantize
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float dequant(int v, float s, float b, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(v), s), b);
  return relu ? fmaxf(y, 0.0f) : y;
}

// Output channels n, n + 1 (n even) of one pixel; ``off`` is the element
// offset of channel n in the output. CODES rounds y to bf16 first if
// round_bf16, then clip(rint(y / s), -127, 127) with s = out_scale[n].
template <int kOut>
__device__ __forceinline__ void store_pair(const Params& p, size_t off,
                                           int n, int v0, int v1) {
  if constexpr (kOut == kAcc) {
    *reinterpret_cast<int2*>(static_cast<int*>(p.out) + off) =
        make_int2(v0, v1);
    return;
  }
  const float2 s = *reinterpret_cast<const float2*>(p.scale + n);
  const float2 b = *reinterpret_cast<const float2*>(p.bias + n);
  float y0 = dequant(v0, s.x, b.x, p.relu);
  float y1 = dequant(v1, s.y, b.y, p.relu);
  if constexpr (kOut == kF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
        make_float2(y0, y1);
  } else if constexpr (kOut == kBf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                       off) = __floats2bfloat162_rn(y0, y1);
  } else {
    if (p.round_bf16) {
      y0 = __bfloat162float(__float2bfloat16_rn(y0));
      y1 = __bfloat162float(__float2bfloat16_rn(y1));
    }
    const float2 o = *reinterpret_cast<const float2*>(p.out_scale + n);
    const float2 r =
        *reinterpret_cast<const float2*>(p.out_scale + p.Cout + n);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + off) =
        make_char2(clip_code(rint_quotient(y0, o.x, r.x)),
                   clip_code(rint_quotient(y1, o.y, r.y)));
  }
}

// ---------------------------------------------------------------------------
// The wgmma + TMA main loop.

// A block tile of TH x TW pixels of one image (BM = 128 or 256) x BN = 128
// output channels, BK channels of one tap a stage, in a ring of STAGES
// stages of shared memory (A then B, each 1024-byte aligned for the
// swizzle). Each of the two consumer warpgroups takes BM / 2 pixels, as MI
// m64 blocks. (One consumer warpgroup with two blocks an SM, to run one
// block's epilogue beside the other's products, was slower at every VGG16
// layer.)
template <int BM_, int BK_>
struct WgTile {
  static constexpr int BM = BM_, BN = 128, BK = BK_;
  static constexpr int TW = 16, TH = BM / TW, MI = BM / 128;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      196608 / STAGE_BYTES > 8 ? 8 : 196608 / STAGE_BYTES;
  // the ring, its 2 x STAGES mbarriers and 1024 bytes to align the base
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
  static constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
  static_assert(BK == 64 || BK == 128, "swizzle span");
  static_assert(BM == 128 || BM == 256, "two consumer warpgroups");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "alignment");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor of a K-major tile whose rows are BK
// bytes, swizzled over BK bytes: 8-row groups SBO = 8 BK bytes apart (the
// leading offset is unused for swizzled K-major tiles); layout 1 = 128-byte
// swizzle, 2 = 64-byte.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * BK) >> 4) << 32) |
         (static_cast<uint64_t>(BK == 128 ? 1 : 2) << 62);
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

// Keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128(int (&d)[64], uint64_t da,
                                               uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


// The tile t of the persistent walk: output channels fastest, then the
// spatial blocks of an image row by row, then the images.
struct TileCoord {
  int b, y0, x0, n0;
};

template <class T>
__device__ __forceinline__ TileCoord tile_coord(int t, int n_tiles,
                                                int tiles_x, int tiles_y) {
  TileCoord c;
  c.n0 = (t % n_tiles) * T::BN;
  int m = t / n_tiles;
  c.x0 = (m % tiles_x) * T::TW;
  m /= tiles_x;
  c.y0 = (m % tiles_y) * T::TH;
  c.b = m / tiles_y;
  return c;
}

template <class T, int kOut>
__global__ void __launch_bounds__(T::THREADS, 1)
    conv_int8_wgmma(__grid_constant__ const CUtensorMap map_x,
                    __grid_constant__ const CUtensorMap map_w,
                    const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  // full[s] (the stage's TMA bytes landed) and empty[s] (both consumer
  // warpgroups are done with it) after the ring
  const uint32_t full0 = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_x = (p.Wo + T::TW - 1) / T::TW;
  const int tiles_y = (p.Ho + T::TH - 1) / T::TH;
  const int n_tiles = p.Cout / T::BN;
  const int tiles = p.B * tiles_y * tiles_x * n_tiles;
  const int cin_steps = p.Cin / T::BK;
  const int k_steps = 9 * cin_steps;

  if (tid < 128) {   // the producer warpgroup: one thread issues the TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileCoord c = tile_coord<T>(t, n_tiles, tiles_x, tiles_y);
        for (int k = 0; k < k_steps; ++k) {
          const int tap = k / cin_steps;
          const int c0 = (k - tap * cin_steps) * T::BK;
          const int ty = tap / 3, tx = tap - ty * 3;
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = ring + stage * T::STAGE_BYTES;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, T::STAGE_BYTES);
          tma_load_4d(sa, &map_x, full, c0, c.x0 - p.pad + tx * p.dil,
                      c.y0 - p.pad + ty * p.dil, c.b);
          tma_load_2d(sa + T::A_BYTES, &map_w, full, tap * p.Cin + c0, c.n0);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {   // two consumer warpgroups: pixels BM / 2 cw ... of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int lane = tid & 31, wi = (tid >> 5) & 3;
    const bool leader = (tid & 127) == 0;
    int stage = 0;
    uint32_t phase = 0;
    int acc[T::MI][T::BN / 2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int i = 0; i < T::BN / 2; ++i) acc[mi][i] = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileCoord c = tile_coord<T>(t, n_tiles, tiles_x, tiles_y);
      int prev = 0;
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa =
            ring + stage * T::STAGE_BYTES + cw * T::MI * 64 * T::BK;
        const uint32_t sb = ring + stage * T::STAGE_BYTES + T::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) fence_acc(acc[mi]);
#pragma unroll
        for (int kk = 0; kk < T::BK / 32; ++kk)
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi)
            wgmma_m64n128(acc[mi],
                              smem_desc<T::BK>(sa + mi * 64 * T::BK + kk * 32),
                              smem_desc<T::BK>(sb + kk * 32),
                              (k > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) fence_acc(acc[mi]);
        if (k > 0) {   // the previous stage's products are done: free it
          wgmma_wait<1>();
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) fence_acc(acc[mi]);
          if (leader) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) fence_acc(acc[mi]);
      if (leader) mbar_arrive(empty0 + 8 * prev);

      // acc[mi][4 j + 2 h + e] is pixel 64 (MI cw + mi) + 16 wi + lane / 4
      // + 8 h of the tile, channel n0 + 8 j + 2 (lane % 4) + e: one image
      // row of the tile a warp and m64 block, columns lane / 4 and
      // lane / 4 + 8
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        const int y = c.y0 + (cw * T::MI + mi) * 4 + wi;
        if (y >= p.Ho) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = c.x0 + (lane >> 2) + 8 * h;
          if (x >= p.Wo) continue;
          const size_t row =
              ((static_cast<size_t>(c.b) * p.Ho + y) * p.Wo + x) * p.Cout;
#pragma unroll
          for (int j = 0; j < T::BN / 8; ++j) {
            const int n = c.n0 + 8 * j + 2 * (lane & 3);
            store_pair<kOut>(p, row + n, n, acc[mi][4 * j + 2 * h],
                             acc[mi][4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <class T, int kOut>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapSwizzle swizzle =
      T::BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  // x: [B, H, W, Cin] bytes, innermost first; a box is one tap's input
  // block of one image
  const cuuint64_t x_dim[4] = {static_cast<cuuint64_t>(p.Cin),
                               static_cast<cuuint64_t>(p.W),
                               static_cast<cuuint64_t>(p.H),
                               static_cast<cuuint64_t>(p.B)};
  const cuuint64_t x_stride[3] = {
      static_cast<cuuint64_t>(p.Cin),
      static_cast<cuuint64_t>(p.W) * p.Cin,
      static_cast<cuuint64_t>(p.H) * p.W * p.Cin};
  const cuuint32_t x_box[4] = {T::BK, T::TW, T::TH, 1};
  // w: [Cout, 9 Cin] bytes
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(9 * p.Cin),
                               static_cast<cuuint64_t>(p.Cout)};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(9 * p.Cin)};
  const cuuint32_t w_box[2] = {T::BK, T::BN};
  CUtensorMap map_x, map_w;
  if (encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
             const_cast<int8_t*>(p.x), x_dim, x_stride, x_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(p.w), w_dim, w_stride, w_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(p.B) *
                          ((p.Ho + T::TH - 1) / T::TH) *
                          ((p.Wo + T::TW - 1) / T::TW) * (p.Cout / T::BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv_int8_wgmma<T, kOut>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(map_x, map_w, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The mma.sync main loop.

// A block tile of BM output pixels x BN output channels, computed by
// WARPS_M x WARPS_N warps of (BM / WARPS_M) x (BN / WARPS_N) each, over
// BK channels of one tap a stage, in a ring of STAGES stages. Shared rows
// are BK + 16 bytes: the 8 rows of an ldmatrix then start on 8 different
// multiples of 4 banks and cover all 32 banks once.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int TM = BM / WARPS_M, TN = BN / WARPS_N;
  static constexpr int MI = TM / 16, NI = TN / 8;   // mma tiles a warp
  static constexpr int ROW = BK + 16;               // shared row, bytes
  static constexpr int CHUNKS = BK / 16;            // 16-byte copies a row
  static constexpr int ROWS_PER_ITER = THREADS / CHUNKS;
  static constexpr int A_ITERS = BM / ROWS_PER_ITER;
  static constexpr int B_ITERS = BN / ROWS_PER_ITER;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
  static_assert(BM % ROWS_PER_ITER == 0 && BN % ROWS_PER_ITER == 0,
                "loader");
};

// 0: 256 x 128, 8 warps of 64 x 64, 64 channels, 4 stages (122,880 bytes)
using Tile0 = Tile<256, 128, 4, 2, 4, 64>;
// 1: 128 x 128, 8 warps of 64 x 32, 128 channels, 3 stages (110,592
// bytes): two blocks an SM, one barrier for every 4 k32 steps
using Tile1 = Tile<128, 128, 2, 4, 3, 128>;

// 16 bytes global -> shared; zero-filled when !valid (source size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class T, int kOut>
__global__ void __launch_bounds__(T::THREADS)
    conv_int8_mma(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % T::WARPS_M;
  const int warp_n = warp / T::WARPS_M;
  const int n_tiles = p.Cout / T::BN;
  const int m0 = (blockIdx.x / n_tiles) * T::BM;
  const int n0 = (blockIdx.x % n_tiles) * T::BN;

  // The loader: each thread copies 16 bytes (part) of rows
  // tid / CHUNKS + i * ROWS_PER_ITER of both tiles every stage.
  const int part = tid % T::CHUNKS;
  int a_b[T::A_ITERS], a_y[T::A_ITERS], a_x[T::A_ITERS];
  bool a_ok[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int m = m0 + tid / T::CHUNKS + i * T::ROWS_PER_ITER;
    a_ok[i] = m < p.M;
    const int mm = a_ok[i] ? m : 0;
    a_x[i] = mm % p.Wo;
    const int t = mm / p.Wo;
    a_y[i] = t % p.Ho;
    a_b[i] = t / p.Ho;
  }
  const int cin_steps = p.Cin / T::BK;
  const int k_tiles = 9 * cin_steps;

  auto load = [&](int stage, int kt) {
    const int tap = kt / cin_steps;
    const int c0 = (kt - tap * cin_steps) * T::BK + part * 16;
    const int ty = tap / 3, tx = tap - (tap / 3) * 3;
    uint8_t* sa = smem + stage * T::STAGE_BYTES;
    uint8_t* sb = sa + T::BM * T::ROW;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const int row = tid / T::CHUNKS + i * T::ROWS_PER_ITER;
      const int yi = a_y[i] - p.pad + ty * p.dil;
      const int xi = a_x[i] - p.pad + tx * p.dil;
      const bool ok = a_ok[i] &&
                      static_cast<unsigned>(yi) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(xi) < static_cast<unsigned>(p.W);
      const int8_t* src =
          ok ? p.x + ((static_cast<size_t>(a_b[i]) * p.H + yi) * p.W + xi) *
                         p.Cin + c0
             : p.x;
      cp_async16(smem_u32(sa + row * T::ROW + part * 16), src, ok);
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int row = tid / T::CHUNKS + i * T::ROWS_PER_ITER;
      const int8_t* src =
          p.w + (static_cast<size_t>(n0 + row) * 9 + tap) * p.Cin + c0;
      cp_async16(smem_u32(sb + row * T::ROW + part * 16), src, true);
    }
  };

  int acc[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }

  // ldmatrix rows of this lane: A's four 8x16-byte matrices are (rows 0-7,
  // k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) = a0..a3 of
  // m16n8k32; B's are (n 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15),
  // (8-15, 16-31) = b0, b1 of two n8 tiles.
  const int a_row = warp_m * T::TM + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = warp_n * T::TN + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int next = kt + T::STAGES - 1;
    if (next < k_tiles) load(next % T::STAGES, next);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % T::STAGES) * T::STAGE_BYTES;
    const uint8_t* sb = sa + T::BM * T::ROW;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 32) {
      uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldmatrix_x4(a[mi],
                    smem_u32(sa + (a_row + mi * 16) * T::ROW + kk + a_col));
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r,
                    smem_u32(sb + (b_row + nj * 16) * T::ROW + kk + b_col));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // c0, c1 of a fragment are (row g, channels 2 t, 2 t + 1); c2, c3 row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * T::TM + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int n = n0 + warp_n * T::TN + ni * 8 + t4 * 2;
        store_pair<kOut>(p, static_cast<size_t>(m) * p.Cout + n, n,
                         acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
  }
}

template <class T, int kOut>
int launch_mma(const Params& p, cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(p.M) + T::BM - 1) / T::BM * (p.Cout / T::BN);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_int8_mma<T, kOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, T::SMEM_BYTES,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut>
int launch(const Params& p, int tile, cudaStream_t s) {
  const bool k128 = p.Cin % 128 == 0;
  switch (tile) {
    case 0:
      return launch_mma<Tile0, kOut>(p, s);
    case 1:
      return launch_mma<Tile1, kOut>(p, s);
    case 2:
      return k128 ? launch_wgmma<WgTile<128, 128>, kOut>(p, s)
                  : launch_wgmma<WgTile<128, 64>, kOut>(p, s);
    default:
      return k128 ? launch_wgmma<WgTile<256, 128>, kOut>(p, s)
                  : launch_wgmma<WgTile<256, 64>, kOut>(p, s);
  }
}

}  // namespace

// One int8 conv. ``out_kind``: 0 the int32 accumulator, 1 f32, 2 bf16, 3
// the next conv's int8 codes (``out_scale`` [2, Cout]: the scales, then
// their reciprocals; ``round_bf16`` rounds y to bf16 first); ``relu``
// applies the ReLU to y. ``tile``: 0 mma.sync 256
// x 128 (64 channels a stage), 1 mma.sync 128 x 128 (128 channels; Cin a
// multiple of 128), 2 wgmma 8 x 16 pixels x 128 channels, 3 wgmma 16 x 16
// pixels x 128 channels; wgmma takes 128 channels a stage where Cin
// allows, else 64. Returns a cudaError_t.
extern "C" int conv_int8(const void* x, const void* w, const float* scale,
                         const float* bias, const float* out_scale, void* out,
                         int out_kind, int relu, int round_bf16, int B, int H,
                         int W, int Cin, int Cout, int dil, int pad, int tile,
                         void* stream) {
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           scale, bias, out_scale, out, H, W, Cin, Cout, 0, 0, dil, pad, 0,
           B, relu, round_bf16};
  p.Ho = H + 2 * pad - 2 * dil;
  p.Wo = W + 2 * pad - 2 * dil;
  const long long m = static_cast<long long>(B) * p.Ho * p.Wo;
  if (tile < 0 || tile > 3 || out_kind < 0 || out_kind > 3 || p.Ho <= 0 ||
      p.Wo <= 0 || Cin % (tile == 1 ? 128 : 64) || Cout % 128 ||
      m > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.M = static_cast<int>(m);
  if (p.M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kAcc:
      return launch<kAcc>(p, tile, s);
    case kF32:
      return launch<kF32>(p, tile, s);
    case kBf16:
      return launch<kBf16>(p, tile, s);
    default:
      return launch<kCodes>(p, tile, s);
  }
}
