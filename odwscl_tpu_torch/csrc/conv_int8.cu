// int8 3x3 convolution on Hopper's tensor cores, with the dequantize fused.
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
// with Ho = H + 2 pad - 2 dil. The epilogue writes, in the JAX package's
// order, y = bf16_or_f32(relu?((f32(acc) * scale[n]) + bias[n])) where
// scale = xs * ks is formed by the caller; __fmul_rn / __fadd_rn keep nvcc
// from contracting the two into an FMA, which rounds once instead of twice.
// The ACC instantiation writes acc itself (int32), for the bit-exact checks.
//
// Bound: operations, but for conv2. The VGG16 layers at the 1200 scale do
// 0.63-1.26 TOP each; the int8 input, the weights and the bf16 output come
// to 0.2-1.4 GB, so all but conv2 (Cin 64: ~460 operations a byte) sit
// above the card's int8 ridge (1979 TOP/s over 3.35 TB/s ~ 590).
//
// Design (an implicit GEMM, M = B Ho Wo, N = Cout, K = 9 Cin): a block
// computes a tile of output pixels x output channels with 8 warps on
// mma.sync.m16n8k32 s8 -> s32 (the tiles below). K runs over the 9 taps
// times Cin in steps of 64 or 128 channels of one tap, so a step's A tile
// is one row of contiguous bytes of x per output pixel. The tiles go
// through a cp.async ring in shared memory (rows padded by 16 bytes: the
// ldmatrix reads are free of bank conflicts); a row whose tap falls outside
// the map is zero-filled by cp.async's source size of 0, so the zero
// padding is never materialized. Blocks walk the output channel tiles
// fastest, so the blocks that share an A tile run together and find it in
// L2. wgmma, TMA and a quantize of the next layer fused into this epilogue
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

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

// The tiles, by the index the C interface takes (ops/quant.py:conv_tile
// picks 1 where Cin allows, else 0; tools/tune_conv_int8.py times both at
// the VGG16 layer shapes, and a 128 x 128 tile of 64 channels, the first
// design, lost to both):
// 0: 256 x 128, 8 warps of 64 x 64, 64 channels, 4 stages (122,880 bytes)
using Tile0 = Tile<256, 128, 4, 2, 4, 64>;
// 1: 128 x 128, 8 warps of 64 x 32, 128 channels, 3 stages (110,592
// bytes): two blocks an SM, one barrier for every 4 k32 steps
using Tile1 = Tile<128, 128, 2, 4, 3, 128>;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int H, W, Cin, Cout, Ho, Wo, dil, pad, M;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Two neighbouring output channels (n, n + 1) of one pixel.
template <typename OutT, bool kRelu>
struct Epilogue;

template <bool kRelu>
struct Epilogue<int, kRelu> {   // ACC: the raw accumulator
  static __device__ __forceinline__ void store(int* out, int v0, int v1,
                                               const float*, const float*) {
    *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
  }
};

__device__ __forceinline__ float dequant(int v, float s, float b,
                                         bool relu) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(v), s), b);
  return relu ? fmaxf(y, 0.0f) : y;
}

template <bool kRelu>
struct Epilogue<float, kRelu> {
  static __device__ __forceinline__ void store(float* out, int v0, int v1,
                                               const float* s,
                                               const float* b) {
    *reinterpret_cast<float2*>(out) = make_float2(
        dequant(v0, s[0], b[0], kRelu), dequant(v1, s[1], b[1], kRelu));
  }
};

template <bool kRelu>
struct Epilogue<__nv_bfloat16, kRelu> {
  static __device__ __forceinline__ void store(__nv_bfloat16* out, int v0,
                                               int v1, const float* s,
                                               const float* b) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
        dequant(v0, s[0], b[0], kRelu), dequant(v1, s[1], b[1], kRelu));
  }
};

template <class T, typename OutT, bool kRelu>
__global__ void __launch_bounds__(T::THREADS)
    conv_int8_kernel(const Params p) {
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
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * T::TM + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int n = n0 + warp_n * T::TN + ni * 8 + t4 * 2;
        Epilogue<OutT, kRelu>::store(out + static_cast<size_t>(m) * p.Cout + n,
                                     acc[mi][ni][half * 2],
                                     acc[mi][ni][half * 2 + 1],
                                     p.scale + n, p.bias + n);
      }
    }
  }
}

template <class T, typename OutT, bool kRelu>
int launch_tile(const Params& p, cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(p.M) + T::BM - 1) / T::BM * (p.Cout / T::BN);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  auto kernel = conv_int8_kernel<T, OutT, kRelu>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, T::SMEM_BYTES,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, bool kRelu>
int launch(const int8_t* x, const int8_t* w, const float* scale,
           const float* bias, void* out, int B, int H, int W, int Cin,
           int Cout, int dil, int pad, int tile, void* stream) {
  Params p{x, w, scale, bias, out, H, W, Cin, Cout, 0, 0, dil, pad, 0};
  p.Ho = H + 2 * pad - 2 * dil;
  p.Wo = W + 2 * pad - 2 * dil;
  const long long m = static_cast<long long>(B) * p.Ho * p.Wo;
  if ((tile != 0 && tile != 1) || p.Ho <= 0 || p.Wo <= 0 ||
      Cin % (tile ? Tile1::BK : Tile0::BK) || Cout % 128 || m > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.M = static_cast<int>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile ? launch_tile<Tile1, OutT, kRelu>(p, s)
              : launch_tile<Tile0, OutT, kRelu>(p, s);
}

}  // namespace

// ``tile``: the index of a block tile above (1 needs Cin % 128 == 0).
// The int32 accumulator [B, Ho, Wo, Cout].
extern "C" int conv_int8_acc(const void* x, const void* w, void* out, int B,
                             int H, int W, int Cin, int Cout, int dil,
                             int pad, int tile, void* stream) {
  return launch<int, false>(static_cast<const int8_t*>(x),
                            static_cast<const int8_t*>(w), nullptr, nullptr,
                            out, B, H, W, Cin, Cout, dil, pad, tile, stream);
}

// The dequantized output in bf16 (out_bf16 != 0) or f32, ReLU if relu != 0.
extern "C" int conv_int8_dequant(const void* x, const void* w,
                                 const float* scale, const float* bias,
                                 void* out, int out_bf16, int relu, int B,
                                 int H, int W, int Cin, int Cout, int dil,
                                 int pad, int tile, void* stream) {
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (out_bf16)
    return relu ? launch<__nv_bfloat16, true>(xq, wq, scale, bias, out, B, H,
                                              W, Cin, Cout, dil, pad, tile,
                                              stream)
                : launch<__nv_bfloat16, false>(xq, wq, scale, bias, out, B,
                                               H, W, Cin, Cout, dil, pad,
                                               tile, stream);
  return relu ? launch<float, true>(xq, wq, scale, bias, out, B, H, W, Cin,
                                    Cout, dil, pad, tile, stream)
              : launch<float, false>(xq, wq, scale, bias, out, B, H, W, Cin,
                                     Cout, dil, pad, tile, stream);
}
