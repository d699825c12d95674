// Dense int8 convolution for Hopper (sm_90a): int8 x int8 -> int32 on the
// tensor cores by wgmma, then the fp32 dequantize epilogue.
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
// What bounds it on this card: most of the flagship's calls read and
// write more bytes than their int8 operations need time on the tensor
// cores (the H100 SXM data sheet at its 700 W limit: 1,979 int8 TOP/s
// against 3.35 TB/s, about 590 operations per byte before the tensor
// cores are the limit; a 1x1 conv of 64 channels does 2 * 64 = 128 per
// input byte). The wide 3x3 convs and the 1024->896 neck lean the other
// way: there the tensor cores' rate is the bound, and only wgmma reaches
// it (mma.sync, which the first version of this kernel used, does not).
//
// Design: an implicit GEMM, M = N*Ho*Wo output pixels by N = Cout, over
// K = kh*kw*Cin ordered (r, s, channel), so that with Cin a multiple of 16
// every 16-byte piece of a row of A is a run of one pixel's NHWC channels,
// and B is qweight (Cout, K) as it lies. For 8-bit types wgmma takes A and
// B only K-major, which both already are: nothing is transposed.
// - Main loop (variant 0): a block of 384 threads owns a 128 x BN output
//   tile (BN = 64, 128 or 256, chosen by quantize._conv_plan). K goes in
//   stages of 128 bytes (4 wgmma k-steps of 32) through a ring of 2-5
//   stages in dynamic shared memory, 128-byte swizzled, guarded by full
//   and empty mbarriers. Warpgroup 0 is the producer: one thread loads
//   B's 128 x BN box by TMA (a 2-D tiled tensor map over qweight, zero
//   past K and past Cout), and all 128 threads gather A, the implicit
//   im2col, by 16-byte cp.async.cg copies, zero-filled (src-size 0) for
//   padding, outside the image and past K; eight lanes cover one 128-byte
//   row, so that a warp reads four whole rows. Warpgroups 1 and 2 each run
//   wgmma.m64nBNk32.s32.s8.s8 on 64 rows of the tile, A and B both from
//   shared memory. Blocks run N-tile fastest, so that the N tiles of one
//   M tile read its A from the L2 and not from device memory again.
// - Split-K: where the tiles are too few to fill the 132 SMs (the 12x12
//   and 24x24 levels), the plan splits the K stages over blockIdx.z. Each
//   split writes its int32 partial tile (coalesced, in the accumulators'
//   own register order) to scratch that the wrapper allocates; the last
//   block of a tile to finish (a counter per tile, reset by that block)
//   adds the other partials and runs the epilogue. int32 addition is
//   associative, so the result is exact whatever the order.
// - Packed K (variant 1, Cin not a multiple of 16: the stem's Cin = 3):
//   K is packed as (r, s, c) contiguous, 27 -> 32 bytes, not one 32-byte
//   chunk per tap; the producer gathers A and B byte by byte, stores them
//   swizzled with st.shared and orders them for wgmma by fence.proxy.async.
// - Tiny M (variant 2, M <= 64: the squeeze-excite convs on 1x1 maps,
//   M = 8): no 128-row tile; one warp per output channel, __dp4a dot
//   products over K and a shuffle sum, for each of the M rows.
// - Epilogue: each consumer warpgroup stages its 64 x BN outputs in shared
//   memory (the ring's, free by then), then writes them out as 16-byte
//   stores along Cout, where NHWC rows are contiguous.
//
// chip_smoke.py (phase 20a) holds it bit for bit against the plain version
// (accumulators and outputs) at every dense-conv shape class of the
// flagship's int8 forwards. Built by npp_tpu_torch/ops/quantize.py with
// nvcc into a shared library with a plain C interface, called through
// ctypes; cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the build links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                 // output pixels per block tile
constexpr int kBK = 128;                 // bytes of K per stage
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kATile = kBM * kBK;        // bytes of A per stage
constexpr int kFullCount = kBM + 1;      // 128 producer arrivals + B's
constexpr int kEmptyCount = 8;           // one arrival per consumer warp
constexpr int kTinyWarps = 8;            // output channels per tiny block

struct Params {
  CUtensorMap tmap_w;     // qweight (Cout, K), boxes of 128 x BN (variant 0)
  CUtensorMap tmap_x;     // x for a_tma: (M, Cin) rows, or (N, H, W, Cin)
  const int8_t* x;        // (N, H, W, Cin) int8, contiguous
  const int8_t* w;        // (Cout, kh, kw, Cin) int8, contiguous
  const float* w_scale;   // (Cout,)
  const float* a_scale;   // (1,), on the device
  const float* bias;      // (Cout,) or nullptr
  void* out;              // (N, Ho, Wo, Cout): float, bf16 or int32
  int4* partial;          // split-K partial tiles, or nullptr
  unsigned int* counters; // split-K arrivals per tile, 0 between launches
  int n, h, w_in, cin, cout, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int m;         // N * Ho * Wo
  int k;         // kh * kw * Cin
  int k_stages;  // ceil(K / 128)
  int splits;    // K splits
  int n_tiles;   // ceil(Cout / BN)
  int m_tiles;   // ceil(M / 128)
  int units;     // n_tiles * m_tiles * splits
  int stages;    // ring depth
  int a_tma;     // A by TMA too: 1 as rows of x (a 1x1, stride-1, unpadded
                 // conv), 2 as an 8 x 16 patch of output pixels for each
                 // tap (stride 1, Cin a multiple of 128, Ho % 8 == 0,
                 // Wo % 16 == 0); 0 gathered by cp.async
};

constexpr int kPatchH = 8;   // output rows of a patch tile
constexpr int kPatchW = 16;  // output columns of a patch tile

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete; a pipeline stuck
// for about 2^34 cycles (seconds) traps, so that a fault raises at the
// next synchronisation instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// 16 bytes from global to shared memory, zero-filled past src_bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed;
// .noinc: the arrival is one of the barrier's expected count.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this mode).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D(64 x N) += A(64 x 32) * B(N x 32)^T, s8 x s8 -> s32, both operands from
// shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
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
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a,
                                           uint64_t b);
template <>
__device__ __forceinline__ void wgmma_tile<64>(int (&d)[32], uint64_t a,
                                               uint64_t b) {
  wgmma_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(int (&d)[64], uint64_t a,
                                                uint64_t b) {
  wgmma_n128(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_tile<256>(int (&d)[128], uint64_t a,
                                                uint64_t b) {
  wgmma_n256(d, a, b);
}

// ---- the epilogue's arithmetic ---------------------------------------------

template <int OUT>
struct OutType;
template <>
struct OutType<0> {
  using T = float;
};
template <>
struct OutType<1> {
  using T = __nv_bfloat16;
};
template <>
struct OutType<2> {
  using T = int;
};

template <int OUT>
__device__ __forceinline__ typename OutType<OUT>::T convert(int v, float scale,
                                                           float bias,
                                                           bool has_bias) {
  if constexpr (OUT == 2) {
    return v;
  } else {
    float y = __fmul_rn(__int2float_rn(v), scale);
    if (has_bias) y = __fadd_rn(y, bias);
    if constexpr (OUT == 0) {
      return y;
    } else {
      return __float2bfloat16_rn(y);
    }
  }
}

// ---- work units: (tile, split) pairs, N tile fastest ------------------------

struct Unit {
  int n0, m0;     // the tile's first output channel and output pixel
  int img, oh0, ow0;  // a patch tile's image and first output row, column
  int tile;       // m_tile * n_tiles + n_tile
  int split;      // the K split
  int s_begin;    // its first K stage
  int nk;         // its K stages (at least one)
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u, int bn) {
  const int tiles = p.n_tiles * p.m_tiles;
  Unit w;
  w.split = u / tiles;
  w.tile = u - w.split * tiles;
  const int m_tile = w.tile / p.n_tiles;
  w.n0 = (w.tile - m_tile * p.n_tiles) * bn;
  w.m0 = m_tile * kBM;
  if (p.a_tma == 2) {
    const int tiles_w = p.wo / kPatchW;
    const int per_img = (p.ho / kPatchH) * tiles_w;
    w.img = m_tile / per_img;
    const int rem = m_tile - w.img * per_img;
    w.oh0 = (rem / tiles_w) * kPatchH;
    w.ow0 = (rem - (rem / tiles_w) * tiles_w) * kPatchW;
  } else {
    w.img = w.oh0 = w.ow0 = 0;
  }
  w.s_begin = w.split * p.k_stages / p.splits;
  w.nk = (w.split + 1) * p.k_stages / p.splits - w.s_begin;
  return w;
}

// Output pixel m's image offset (in pixels) and its window's top-left
// input row and column; a row past M gets a row far outside the image.
__device__ __forceinline__ void row_origin(const Params& p, int m, int& pix,
                                           int& h0, int& w0) {
  if (m < p.m) {
    const int hw = p.ho * p.wo;
    const int img = m / hw;
    const int rem = m - img * hw;
    const int oh = rem / p.wo;
    pix = img * p.h * p.w_in;
    h0 = oh * p.sh - p.ph;
    w0 = (rem - oh * p.wo) * p.sw - p.pw;
  } else {
    pix = 0;
    h0 = -(1 << 28);
    w0 = 0;
  }
}

// ---- the producer where A comes by TMA too: one thread loads both
// operands' boxes. For a 1x1, stride-1, unpadded conv A is x itself, an
// (M, Cin) matrix; otherwise each stage is one tap's 128 channels over an
// 8 x 16 patch of output pixels, a 4-D box of x shifted by the tap, whose
// rows outside the image (the padding) TMA fills with zeros ------------

__device__ __forceinline__ void produce_tma(const Params& p, uint32_t ring,
                                            int stage_bytes, int bn,
                                            uint64_t* full, uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u, bn);
    for (int it = 0; it < w.nk; ++it) {
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t a_dst = ring + stage * stage_bytes;
      const uint32_t bar = smem_u32(&full[stage]);
      const int ks = w.s_begin + it;
      mbar_expect_tx(bar, static_cast<uint32_t>(stage_bytes));
      if (p.a_tma == 1) {
        tma_load_2d(a_dst, &p.tmap_x, ks * kBK, w.m0, bar);
      } else {
        const int cpt = p.cin / kBK;  // stages per tap
        const int tap = ks / cpt;
        const int r = tap / p.kw;
        const int s = tap - r * p.kw;
        tma_load_4d(a_dst, &p.tmap_x, (ks - tap * cpt) * kBK,
                    w.ow0 - p.pw + s * p.dw, w.oh0 - p.ph + r * p.dh, w.img,
                    bar);
      }
      tma_load_2d(a_dst + kATile, &p.tmap_w, ks * kBK, w.n0, bar);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the producer: B by TMA and A by cp.async (variant 0) -------------------

__device__ __forceinline__ void produce_gather(const Params& p, uint32_t ring,
                                               int stage_bytes, int bn,
                                               uint64_t* full,
                                               uint64_t* empty) {
  const int t = threadIdx.x;  // 0..127
  const int chunk = t & 7;    // the 16-byte piece of a 128-byte row of K
  const int row0 = t >> 3;    // rows row0 + 16 i, i < 8
  const uint32_t swz = static_cast<uint32_t>(((row0 & 7) ^ chunk) * 16);
  const int cpt = p.cin >> 4;  // 16-byte pieces per tap
  const int k16 = p.k >> 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u, bn);
    int pix[8], h0[8], w0[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      row_origin(p, w.m0 + row0 + 16 * i, pix[i], h0[i], w0[i]);
    }
    for (int it = 0; it < w.nk; ++it) {
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t a_dst = ring + stage * stage_bytes;
      const uint32_t bar = smem_u32(&full[stage]);
      const int ks = w.s_begin + it;
      if (t == 0) {
        mbar_expect_tx(bar, static_cast<uint32_t>(stage_bytes - kATile));
        tma_load_2d(a_dst + kATile, &p.tmap_w, ks * kBK, w.n0, bar);
      }
      const int piece = ks * 8 + chunk;
      const int tap = piece / cpt;
      const int c = (piece - tap * cpt) * 16;
      const int r = tap / p.kw;
      const int s = tap - r * p.kw;
      const bool k_ok = piece < k16;
      const int dr = r * p.dh, ds = s * p.dw;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int hi = h0[i] + dr, wi = w0[i] + ds;
        const bool ok =
            k_ok && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_in;
        const int8_t* src =
            ok ? p.x + (static_cast<int64_t>(pix[i] + hi * p.w_in + wi) *
                            p.cin + c)
               : p.x;
        cp_async16(a_dst + (row0 + 16 * i) * kBK + swz, src, ok ? 16 : 0);
      }
      cp_async_arrive(bar);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  cp_async_wait_all();
}

// ---- the producer for packed K (variant 1): both operands by hand ----------

// 16 bytes k0..k0+15 of a packed K row (zero past K), loaded side by side.
template <typename Load>
__device__ __forceinline__ void pack16(int k0, int k, Load load,
                                       uint32_t (&v)[4]) {
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = k0 + j < k ? load(k0 + j) : 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = b[4 * q] | (b[4 * q + 1] << 8) | (b[4 * q + 2] << 16) |
           (b[4 * q + 3] << 24);
  }
}

__device__ __forceinline__ void produce_packed(const Params& p, uint32_t ring,
                                               int stage_bytes, int bn,
                                               uint64_t* full,
                                               uint64_t* empty) {
  const int t = threadIdx.x;  // 0..127: row t of A, rows t, t + 128 of B
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u, bn);
    int pix, h0, w0;
    row_origin(p, w.m0 + t, pix, h0, w0);
    // byte k of this row of A: tap k / Cin, channel k % Cin
    auto load_a = [&](int k) -> uint32_t {
      const int tap = k / p.cin;
      const int c = k - tap * p.cin;
      const int r = tap / p.kw;
      const int hi = h0 + r * p.dh;
      const int wi = w0 + (tap - r * p.kw) * p.dw;
      if (hi < 0 || hi >= p.h || wi < 0 || wi >= p.w_in) return 0u;
      return static_cast<uint8_t>(
          p.x[static_cast<int64_t>(pix + hi * p.w_in + wi) * p.cin + c]);
    };
    for (int it = 0; it < w.nk; ++it) {
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t a_dst = ring + stage * stage_bytes;
      const uint32_t b_dst = a_dst + kATile;
      const int k0 = (w.s_begin + it) * kBK;
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (k0 + 16 * j < p.k) pack16(k0 + 16 * j, p.k, load_a, v);
        st_shared_v4(a_dst + t * kBK + ((j ^ (t & 7)) * 16), v[0], v[1],
                     v[2], v[3]);
      }
#pragma unroll 1
      for (int row = t; row < bn; row += kBM) {
        const int co = w.n0 + row;
        auto load_b = [&](int k) -> uint32_t {
          return static_cast<uint8_t>(p.w[static_cast<int64_t>(co) * p.k + k]);
        };
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (co < p.cout && k0 + 16 * j < p.k) {
            pack16(k0 + 16 * j, p.k, load_b, v);
          }
          st_shared_v4(b_dst + row * kBK + ((j ^ (row & 7)) * 16), v[0],
                       v[1], v[2], v[3]);
        }
      }
      fence_proxy_async();  // st.shared before the tensor cores' reads
      const uint32_t bar = smem_u32(&full[stage]);
      mbar_arrive(bar);
      if (t == 0) mbar_arrive(bar);  // the share that TMA takes in variant 0
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the kernel -------------------------------------------------------------

// Bytes a consumer warpgroup stages of one pass of its 64 output rows.
constexpr int kPassBytes = 256;
constexpr int kStagingBytes = 2 * 64 * (kPassBytes + 16);
// Each consumer warpgroup's table of its tile's column scales
// (a_scale * w_scale) and biases, at most 256 columns.
constexpr int kTableBytes = 2 * 2 * 256 * 4;

// A persistent block of 384 threads walks the launch's work units
// (blockIdx.x, + gridDim.x, ...): the producer runs ahead into the next
// unit's loads while the consumers finish a unit's epilogue.
template <int BN, int OUT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ Params p) {
  constexpr int kStage = kATile + BN * kBK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* staging = ring + p.stages * kStage;
  float* tables = reinterpret_cast<float*>(staging + kStagingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStagingBytes +
                                               kTableBytes);
  uint64_t* empty = full + p.stages;
  int* last_flag = reinterpret_cast<int*>(empty + p.stages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), p.a_tma ? 1 : kFullCount);
      mbar_init(smem_u32(&empty[s]), kEmptyCount);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t ring_u32 = smem_u32(ring);
  if (threadIdx.x < 128) {
    if constexpr (PACKED) {
      produce_packed(p, ring_u32, kStage, BN, full, empty);
    } else if (p.a_tma) {
      if (threadIdx.x == 0) produce_tma(p, ring_u32, kStage, BN, full, empty);
    } else {
      produce_gather(p, ring_u32, kStage, BN, full, empty);
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cwg of each tile ----
  using T = typename OutType<OUT>::T;
  constexpr int kEs = static_cast<int>(sizeof(T));
  constexpr int kPassCols = kPassBytes / kEs < BN ? kPassBytes / kEs : BN;
  constexpr int kPasses = BN / kPassCols;
  constexpr int kPitch = kPassCols * kEs + 16;
  const int ctid = threadIdx.x - 128;  // 0..255
  const int cwg = ctid >> 7;
  const int lt = ctid & 127;  // thread within the warpgroup
  const int warp = lt >> 5, lane = lt & 31;
  uint8_t* tile_out = staging + cwg * 64 * kPitch;
  float* col_scale = tables + cwg * 2 * 256;
  float* col_bias = col_scale + 256;
  uint8_t* out = static_cast<uint8_t*>(p.out);
  const bool has_bias = p.bias != nullptr;
  const float a_scale = OUT == 2 ? 0.f : *p.a_scale;
  int acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u, BN);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    if (OUT != 2) {  // the epilogue's column table, read after the main loop
      for (int c = lt; c < BN; c += 128) {
        const int co = w.n0 + c;
        col_scale[c] = co < p.cout ? __fmul_rn(a_scale, __ldg(p.w_scale + co))
                                   : 0.f;
        col_bias[c] = co < p.cout && has_bias ? __ldg(p.bias + co) : 0.f;
      }
    }
    // Each stage's wgmma group runs while the next stage is awaited; a
    // stage is released once the group after it has been issued.
    int prev = 0;
    for (int it = 0; it < w.nk; ++it) {
      mbar_wait(smem_u32(&full[stage]), phase);
      fence_proxy_async();  // cp.async's writes before the tensor cores'
      const int k_left = p.k - (w.s_begin + it) * kBK;
      const int ksteps = k_left >= kBK ? 4 : (k_left + 31) >> 5;
      const uint32_t a_addr = ring_u32 + stage * kStage + cwg * 64 * kBK;
      const uint64_t da = smem_desc(a_addr);
      const uint64_t db = smem_desc(ring_u32 + stage * kStage + kATile);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));

    if (p.splits > 1) {
      // Every split stores its partial tile, in the order of its registers
      // (4 int32 at a time, the 256 consumer threads side by side); the
      // last of the tile's units to arrive adds the others' and goes on.
      int4* part = p.partial;
      const int64_t mine =
          (static_cast<int64_t>(w.tile) * p.splits + w.split) * (BN / 8) *
          256;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        __stcg(part + mine + i * 256 + ctid,
               make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]));
      }
      __threadfence();
      named_sync(1, 256);
      if (ctid == 0) {
        const unsigned int before = atomicAdd(&p.counters[w.tile], 1u);
        *last_flag = before == static_cast<unsigned int>(p.splits - 1);
      }
      named_sync(1, 256);
      if (!*last_flag) continue;
      __threadfence();
      for (int s = 0; s < p.splits; ++s) {
        if (s == w.split) continue;
        const int64_t other =
            (static_cast<int64_t>(w.tile) * p.splits + s) * (BN / 8) * 256;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int4 v = __ldcg(part + other + i * 256 + ctid);
          acc[4 * i] += v.x;
          acc[4 * i + 1] += v.y;
          acc[4 * i + 2] += v.z;
          acc[4 * i + 3] += v.w;
        }
      }
      if (ctid == 0) p.counters[w.tile] = 0u;  // ready for the next launch
    }

    // ---- epilogue: through shared memory, 16-byte stores along Cout, in
    // passes of kPassCols columns ----
    // Accumulator 4 i + j (wgmma's layout): row 16 warp + lane / 4 +
    // 8 (j / 2), column 8 i + 2 (lane % 4) + j % 2.
    const int row_base = w.m0 + cwg * 64;
    // Output pixel of the warpgroup's row r: consecutive, or for a patch
    // tile row 16 bh + bw of the patch.
    auto out_m = [&](int r) {
      if (p.a_tma != 2) return row_base + r;
      const int t = cwg * 64 + r;
      return (w.img * p.ho + w.oh0 + (t >> 4)) * p.wo + w.ow0 + (t & 15);
    };
    named_sync(2 + cwg, 128);  // the column table is written
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if ((8 * i) / kPassCols != pass) continue;
        const int col = 8 * i + 2 * (lane & 3);
        float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
        if (OUT != 2) {
          sc[0] = col_scale[col];
          sc[1] = col_scale[col + 1];
          bi[0] = col_bias[col];
          bi[1] = col_bias[col + 1];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * warp + (lane >> 2) + 8 * hr;
          T* dst = reinterpret_cast<T*>(tile_out + row * kPitch) +
                   (col - pass * kPassCols);
          dst[0] = convert<OUT>(acc[4 * i + 2 * hr], sc[0], bi[0], has_bias);
          dst[1] =
              convert<OUT>(acc[4 * i + 2 * hr + 1], sc[1], bi[1], has_bias);
        }
      }
      named_sync(2 + cwg, 128);
      const int c0 = w.n0 + pass * kPassCols;  // the pass's first channel
      const int cols = min(kPassCols, p.cout - c0);
      constexpr int kVpr = kPassCols * kEs / 16;  // 16-byte pieces a row
      if (cols == kPassCols && (p.cout * kEs) % 16 == 0) {
#pragma unroll 4
        for (int v = lt; v < 64 * kVpr; v += 128) {
          const int r = v / kVpr;
          const int c = v - r * kVpr;
          const int m = out_m(r);
          if (m < p.m) {
            *reinterpret_cast<int4*>(
                out + (static_cast<int64_t>(m) * p.cout + c0) * kEs +
                c * 16) =
                *reinterpret_cast<const int4*>(tile_out + r * kPitch +
                                               c * 16);
          }
        }
      } else if ((p.cout * kEs) % 16 == 0) {
        const int vpr = cols * kEs / 16;
        for (int v = lt; v < 64 * vpr; v += 128) {
          const int r = v / vpr;
          const int c = v - r * vpr;
          const int m = out_m(r);
          if (m < p.m) {
            *reinterpret_cast<int4*>(
                out + (static_cast<int64_t>(m) * p.cout + c0) * kEs +
                c * 16) =
                *reinterpret_cast<const int4*>(tile_out + r * kPitch +
                                               c * 16);
          }
        }
      } else {
        for (int e = lt; e < 64 * cols; e += 128) {
          const int r = e / cols;
          const int c = e - r * cols;
          const int m = out_m(r);
          if (m < p.m) {
            reinterpret_cast<T*>(out)[static_cast<int64_t>(m) * p.cout + c0 +
                                      c] =
                reinterpret_cast<const T*>(tile_out + r * kPitch)[c];
          }
        }
      }
      named_sync(2 + cwg, 128);  // the staging is free for the next pass
    }
  }
}

// Tiny M (variant 2): a 1x1, stride-1, unpadded conv whose M rows are few;
// one warp per output channel, __dp4a over K, a shuffle sum per row.
template <int OUT>
__global__ void __launch_bounds__(kTinyWarps * 32)
    int8_conv_tiny_kernel(const __grid_constant__ Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co = blockIdx.x * kTinyWarps + warp;
  if (co >= p.cout) return;
  const int k4 = p.k >> 2;
  const int* w4 = reinterpret_cast<const int*>(p.w) +
                  static_cast<int64_t>(co) * k4;
  const int* x4 = reinterpret_cast<const int*>(p.x);
  const bool has_bias = p.bias != nullptr;
  float scale = 0.f, bias = 0.f;
  if (OUT != 2) {
    scale = __fmul_rn(*p.a_scale, p.w_scale[co]);
    if (has_bias) bias = p.bias[co];
  }
  for (int m = 0; m < p.m; ++m) {
    int s = 0;
    for (int j = lane; j < k4; j += 32) {
      s = __dp4a(x4[static_cast<int64_t>(m) * k4 + j], w4[j], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      reinterpret_cast<typename OutType<OUT>::T*>(
          p.out)[static_cast<int64_t>(m) * p.cout + co] =
          convert<OUT>(s, scale, bias, has_bias);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <int BN, int OUT, bool PACKED>
cudaError_t launch_main(const Params& p, int blocks, int smem,
                        cudaStream_t stream) {
  auto kernel = int8_conv_kernel<BN, OUT, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int OUT>
cudaError_t launch_bn(const Params& p, int bn, bool packed, int blocks,
                      int smem, cudaStream_t stream) {
  if (packed) {
    if (bn != 64) return cudaErrorInvalidValue;
    return launch_main<64, OUT, true>(p, blocks, smem, stream);
  }
  switch (bn) {
    case 64: return launch_main<64, OUT, false>(p, blocks, smem, stream);
    case 128: return launch_main<128, OUT, false>(p, blocks, smem, stream);
    case 256: return launch_main<256, OUT, false>(p, blocks, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int OUT>
cudaError_t launch_tiny(const Params& p, cudaStream_t stream) {
  const int blocks = (p.cout + kTinyWarps - 1) / kTinyWarps;
  int8_conv_tiny_kernel<OUT><<<blocks, kTinyWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success), or 1000 + the CUresult of a failed
// tensor-map encoding, or 999 when CUDA gives no
// cuTensorMapEncodeTiled. out_kind: 0 float32, 1 bfloat16, 2 the int32
// accumulators (a_scale, w_scale and bias are then unread). variant: 0 the
// wgmma main loop (Cin a multiple of 16), 3 the same with A by TMA too (a
// 1x1, stride-1, unpadded conv as rows; else as 8 x 16 patches, which
// needs stride 1, Cin a multiple of 128, Ho % 8 == 0 and Wo % 16 == 0),
// 1 packed K, 2 tiny M. bn, stages,
// splits, smem_bytes and blocks (the persistent grid) are
// quantize._conv_plan's; partial is its split-K scratch and counters its
// tile counters (both unread when splits is 1).
extern "C" int npp_int8_conv(const int8_t* x, const int8_t* w,
                             const float* w_scale, const float* a_scale,
                             const float* bias, void* out, void* partial,
                             void* counters, int n, int h, int w_in, int cin,
                             int cout, int ho, int wo, int kh, int kw, int sh,
                             int sw, int ph, int pw, int dh, int dw,
                             int out_kind, int variant, int bn, int stages,
                             int splits, int smem_bytes, int blocks,
                             void* stream) {
  Params p{};
  p.x = x;
  p.w = w;
  p.w_scale = w_scale;
  p.a_scale = a_scale;
  p.bias = bias;
  p.out = out;
  p.partial = static_cast<int4*>(partial);
  p.counters = static_cast<unsigned int*>(counters);
  p.n = n;
  p.h = h;
  p.w_in = w_in;
  p.cin = cin;
  p.cout = cout;
  p.ho = ho;
  p.wo = wo;
  p.kh = kh;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  p.dh = dh;
  p.dw = dw;
  p.m = n * ho * wo;
  p.k = kh * kw * cin;
  p.k_stages = (p.k + kBK - 1) / kBK;
  p.splits = splits;
  p.n_tiles = (cout + bn - 1) / bn;
  p.m_tiles = (p.m + kBM - 1) / kBM;
  p.units = p.n_tiles * p.m_tiles * splits;
  p.stages = stages;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    if (kh != 1 || kw != 1 || sh != 1 || sw != 1 || ph != 0 || pw != 0 ||
        cin % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (out_kind) {
      case 0: return static_cast<int>(launch_tiny<0>(p, s));
      case 1: return static_cast<int>(launch_tiny<1>(p, s));
      case 2: return static_cast<int>(launch_tiny<2>(p, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (splits < 1 || splits > p.k_stages || stages < 2 || blocks < 1 ||
      (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool packed = variant == 1;
  const bool direct = kh == 1 && kw == 1 && sh == 1 && sw == 1 && ph == 0 &&
                      pw == 0;
  p.a_tma = variant != 3 ? 0 : direct ? 1 : 2;
  if (!packed) {
    if ((variant != 0 && variant != 3) || cin % 16 != 0 ||
        (p.a_tma == 2 && (cin % kBK != 0 || sh != 1 || sw != 1 ||
                          ho % kPatchH != 0 || wo % kPatchW != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return 999;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k),
                                static_cast<cuuint64_t>(cout)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                               static_cast<cuuint32_t>(bn)};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(
        &p.tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
        const_cast<int8_t*>(w), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
    if (p.a_tma == 1) {  // x as (M, Cin): zero past Cin and past M
      const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(cin),
                                    static_cast<cuuint64_t>(p.m)};
      const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(cin)};
      const cuuint32_t x_box[2] = {static_cast<cuuint32_t>(kBK),
                                   static_cast<cuuint32_t>(kBM)};
      const CUresult x_res = encode(
          &p.tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
          const_cast<int8_t*>(x), x_dims, x_strides, x_box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (x_res != CUDA_SUCCESS) return 1000 + static_cast<int>(x_res);
    } else if (p.a_tma == 2) {  // x as (N, H, W, Cin): zero outside
      const cuuint64_t x_dims[4] = {
          static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w_in),
          static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
      const cuuint64_t x_strides[3] = {
          static_cast<cuuint64_t>(cin),
          static_cast<cuuint64_t>(cin) * static_cast<cuuint64_t>(w_in),
          static_cast<cuuint64_t>(cin) * static_cast<cuuint64_t>(w_in) *
              static_cast<cuuint64_t>(h)};
      const cuuint32_t x_box[4] = {static_cast<cuuint32_t>(kBK),
                                   static_cast<cuuint32_t>(kPatchW),
                                   static_cast<cuuint32_t>(kPatchH), 1};
      const cuuint32_t x_elem[4] = {1, 1, 1, 1};
      const CUresult x_res = encode(
          &p.tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
          const_cast<int8_t*>(x), x_dims, x_strides, x_box, x_elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (x_res != CUDA_SUCCESS) return 1000 + static_cast<int>(x_res);
    }
  }
  switch (out_kind) {
    case 0:
      return static_cast<int>(
          launch_bn<0>(p, bn, packed, blocks, smem_bytes, s));
    case 1:
      return static_cast<int>(
          launch_bn<1>(p, bn, packed, blocks, smem_bytes, s));
    case 2:
      return static_cast<int>(
          launch_bn<2>(p, bn, packed, blocks, smem_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
