// Dense int8 convolution for Hopper (sm_90a): int8 x int8 -> int32, then
// the fp32 dequantize epilogue.
//
// Replaces XLA's int8 convolution in npp_tpu/ops/quantize.py:int8_conv
// (lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32, line 113). It is not a Pallas kernel: on
// the TPU, XLA emitted it; eager PyTorch has no int8 convolution on CUDA,
// so the port computes it here. For an NHWC int8 input x (N, H, W, Cin)
// and int8 weights w (Cout, kh, kw, Cin) it forms, per output pixel m and
// output channel co,
//     acc[m, co] = sum_{r, s, ci} x[n, ho*sh - ph + r*dh,
//                                   wo*sw - pw + s*dw, ci] * w[co, r, s, ci]
// (zero outside the image) in int32, exactly, and then
//     out = float(acc) * (a_scale * w_scale[co]) + bias[co]
// in npp_tpu's order (quantize.py:120-123): the scale product first, one
// multiply, one add, each rounded to nearest by an explicit intrinsic so
// that nvcc cannot contract them into an FMA (the plain version in
// npp_tpu_torch/ops/quantize.py rounds after each). bf16 outputs are
// rounded by __float2bfloat16_rn, which is torch's .to(torch.bfloat16).
// out_kind 2 writes the raw int32 accumulators instead, for the checks.
//
// What bounds it on this card: at the flagship's widths most of its
// calls read and write more bytes than their int8 operations need time
// on the tensor cores (the H100 SXM data sheet, at its 700 W limit:
// 1,979 int8 TOP/s against 3.35 TB/s, about 590 operations per byte
// before the tensor cores are the limit; a 1x1 conv of 64 channels does
// 2 * 64 = 128 per input byte). The wide 3x3 convs lean the other way.
//
// Design: an implicit GEMM, M = N*Ho*Wo output pixels by Cout, over
// K = kh*kw*Cin taken as (r, s) outer and channel chunks of 32 inner, so
// that each 32-deep step of K reads one contiguous run of a pixel's NHWC
// channels (zero-filled past Cin: the stem's Cin = 3 pads to 32). A block
// of 128 threads (4 warps, 2 x 2) owns a 128 x 64 output tile; each warp
// 64 x 32 of it, as 4 x 4 tiles of mma.sync.m16n8k32.s32.s8.s8.s32.
// Per step the block stages a 128 x 32-byte tile of x and a 64 x 32-byte
// tile of w in shared memory (rows padded to 48 bytes, so that the
// fragment loads of a warp touch 32 distinct banks), and holds the next
// step's tiles in registers while the tensor cores work on this one. With
// Cin a multiple of 16 every global load is one aligned 16-byte vector;
// otherwise (the stem) bytes are loaded one by one. Each thread of the
// loader owns one output pixel row of the tile, whose (n, ho, wo) it
// computes once. No split-K, no wgmma, no TMA: a simple kernel first; its
// times stand in PERF.md beside its bound and the library's GEMM.
//
// chip_smoke.py (phase 20) holds it bit for bit against the plain version
// (accumulators and outputs) at every dense-conv shape class of the
// flagship forward. Built by npp_tpu_torch/ops/quantize.py with nvcc into
// a shared library with a plain C interface, and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;       // output pixels per block tile
constexpr int kBN = 64;        // output channels per block tile
constexpr int kBK = 32;        // bytes of K per step (one mma's depth)
constexpr int kLds = 48;       // shared row pitch in bytes (32 + 16 pad)
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile

struct Params {
  const int8_t* x;        // (N, H, W, Cin) int8, contiguous
  const int8_t* w;        // (Cout, kh, kw, Cin) int8, contiguous
  const float* w_scale;   // (Cout,)
  const float* a_scale;   // (1,), on the device
  const float* bias;      // (Cout,) or nullptr
  void* out;              // (N, Ho, Wo, Cout): float, bf16 or int32
  int n, h, w_in, cin, cout, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int m;                  // N * Ho * Wo
  int chunks;             // ceil(Cin / 32)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of src[0..15], with byte j zero where j >= valid (valid may be
// <= 0 or >= 16); byte by byte, for unaligned rows.
__device__ __forceinline__ int4 load_bytes(const int8_t* src, int valid) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < valid) {
      v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                   << (8 * (j & 3));
    }
  }
  return make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]),
                   static_cast<int>(v[2]), static_cast<int>(v[3]));
}

template <bool kAligned>
__device__ __forceinline__ int4 load16(const int8_t* src, int valid) {
  if (valid <= 0) return make_int4(0, 0, 0, 0);
  if (kAligned) return *reinterpret_cast<const int4*>(src);
  return load_bytes(src, valid);
}

template <int kOut, bool kAligned>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Params p) {
  __shared__ __align__(16) int8_t s_a[kBM * kLds];
  __shared__ __align__(16) int8_t s_b[kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // The loader's rows: x row tid of the tile, w row tid / 2 (half tid % 2).
  const int am = m0 + tid;
  const bool a_row = am < p.m;
  int a_img = 0, a_h0 = 0, a_w0 = 0;
  if (a_row) {
    const int hw = p.ho * p.wo;
    a_img = am / hw;
    const int rem = am - a_img * hw;
    const int oh = rem / p.wo;
    a_h0 = oh * p.sh - p.ph;
    a_w0 = (rem - oh * p.wo) * p.sw - p.pw;
  }
  const int b_row = tid >> 1, b_half = tid & 1;
  const int b_co = n0 + b_row;
  const int64_t k_total = static_cast<int64_t>(p.kh) * p.kw * p.cin;

  int4 ra0, ra1, rb;
  auto load_tile = [&](int t) {
    const int rs = t / p.chunks;
    const int c0 = (t - rs * p.chunks) * kBK;
    const int r = rs / p.kw, s = rs - r * p.kw;
    const int hi = a_h0 + r * p.dh, wi = a_w0 + s * p.dw;
    const bool inside = a_row && hi >= 0 && hi < p.h && wi >= 0 &&
                        wi < p.w_in;
    if (inside) {
      const int8_t* src =
          p.x + ((static_cast<int64_t>(a_img) * p.h + hi) * p.w_in + wi) *
                    p.cin + c0;
      ra0 = load16<kAligned>(src, p.cin - c0);
      ra1 = load16<kAligned>(src + 16, p.cin - c0 - 16);
    } else {
      ra0 = ra1 = make_int4(0, 0, 0, 0);
    }
    if (b_co < p.cout) {
      const int c = c0 + 16 * b_half;
      rb = load16<kAligned>(p.w + b_co * k_total +
                                static_cast<int64_t>(rs) * p.cin + c,
                            p.cin - c);
    } else {
      rb = make_int4(0, 0, 0, 0);
    }
  };
  auto store_tile = [&]() {
    *reinterpret_cast<int4*>(s_a + tid * kLds) = ra0;
    *reinterpret_cast<int4*>(s_a + tid * kLds + 16) = ra1;
    *reinterpret_cast<int4*>(s_b + b_row * kLds + 16 * b_half) = rb;
  };

  // Fragments (PTX ISA, mma.m16n8k32 with .s8): g = lane / 4 picks the
  // row of A (and g + 8) and the column of B; t = lane % 4 the 4 bytes
  // t*4..t*4+3 of the 32-deep K slice (and 16 + those).
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int steps = p.kh * p.kw * p.chunks;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) load_tile(t + 1);
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* row = s_a + (wm + 16 * i + g) * kLds + 4 * t4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(row);
      a[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kLds);
      a[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kLds + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* col = s_b + (wn + 8 * j + g) * kLds + 4 * t4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(col);
      b[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
    if (t + 1 < steps) {
      store_tile();
      __syncthreads();
    }
  }

  // Epilogue: accumulator k of tile (i, j) is row g (+8 for k >= 2),
  // column 2 t + (k & 1).
  const float a_scale = kOut == 2 ? 0.f : *p.a_scale;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int co = n0 + wn + 8 * j + 2 * t4 + c;
      if (co >= p.cout) continue;
      float scale = 0.f, bias = 0.f;
      if (kOut != 2) {
        scale = __fmul_rn(a_scale, p.w_scale[co]);
        if (p.bias != nullptr) bias = p.bias[co];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int m = m0 + wm + 16 * i + g + 8 * hrow;
          if (m >= p.m) continue;
          const int v = acc[i][j][2 * hrow + c];
          const int64_t o = static_cast<int64_t>(m) * p.cout + co;
          if (kOut == 2) {
            static_cast<int*>(p.out)[o] = v;
            continue;
          }
          float y = __fmul_rn(__int2float_rn(v), scale);
          if (p.bias != nullptr) y = __fadd_rn(y, bias);
          if (kOut == 0) {
            static_cast<float*>(p.out)[o] = y;
          } else {
            static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

template <int kOut>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.cin % 16 == 0) {
    int8_conv_kernel<kOut, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    int8_conv_kernel<kOut, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). out_kind: 0 float32, 1 bfloat16,
// 2 the int32 accumulators (a_scale, w_scale and bias are then unread).
extern "C" int npp_int8_conv(const int8_t* x, const int8_t* w,
                             const float* w_scale, const float* a_scale,
                             const float* bias, void* out, int n, int h,
                             int w_in, int cin, int cout, int ho, int wo,
                             int kh, int kw, int sh, int sw, int ph, int pw,
                             int dh, int dw, int out_kind, void* stream) {
  Params p{x,  w,  w_scale, a_scale, bias, out, n,  h,  w_in, cin, cout,
           ho, wo, kh,      kw,      sh,   sw,  ph, pw, dh,   dw,  0,   0};
  p.m = n * ho * wo;
  p.chunks = (cin + kBK - 1) / kBK;
  const dim3 grid((p.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0: return static_cast<int>(launch<0>(p, grid, s));
    case 1: return static_cast<int>(launch<1>(p, grid, s));
    case 2: return static_cast<int>(launch<2>(p, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
