// The activation quantize of the int8 serving layer for Hopper (sm_90a):
// bf16 or fp32 activations -> int8 NHWC, with the per-tensor scale found
// and kept on the device, and the producer's ReLU optionally folded in.
//
// Replaces the quantize that npp_tpu/ops/quantize.py:int8_conv runs before
// its int8 conv (lines 100-109): XLA fused it, and the ReLU in front of
// most dense convs, into one pass over x on the TPU. It computes
//     x' = relu(x) if relu else x
//     dynamic: a_scale = max(max|x'|, 1e-8) / 127,  q = round(x' / a_scale)
//     static:  a_scale given,                        q = clip(round(x' / a_scale),
//                                                             -127, 127)
// and writes q as int8 in NHWC order, which is what the int8 conv
// (int8_conv.cu) reads, whatever the input's layout (NCHW-contiguous or
// channels_last).
//
// Rounding, to agree bit for bit with the plain version
// (npp_tpu_torch/ops/quantize.py:quantize_act_reference) on the card:
// - "/ 127" there divides a CUDA tensor by a Python scalar, which PyTorch's
//   CUDA division (aten/src/ATen/native/cuda/BinaryDivTrueKernel.cu) turns
//   into a multiply by the reciprocal rounded to float, 1.0f / 127.0f.
//   So the scale here is __fmul_rn(max(absmax, 1e-8f), __frcp_rn(127.0f)),
//   not __fdiv_rn(..., 127.0f): the two differ for some absmax.
// - "x / a_scale" divides by a device tensor, which PyTorch computes as an
//   IEEE division: __fdiv_rn. torch.round rounds half to even: rintf.
//   torch.clamp keeps a NaN; fminf / fmaxf would drop it, so the clip
//   tests for it.
// - max|x'| is taken on the bit patterns of |x'| as unsigned integers,
//   which order non-negative floats as the floats do and put a NaN above
//   inf, as torch.amax propagates it.
// - The ReLU comes first, as torch.relu: a NaN stays, negatives and -0.0
//   become 0 (so they neither raise the absmax nor take the division).
//
// What bounds it: bytes. x read once and one byte written per element:
// for the 3x3 128->128 conv's input at 96x96, bs8 bf16, 18.9 MB in and
// 9.4 MB out, 8.45 us at 3.35 TB/s.
//
// Design (channels_last, where element i of x is element i of q):
// - Dynamic scale, one launch that reads x once from device memory
//   (quantize_nhwc_kernel): a persistent grid of at most
//   one block of 512 threads an SM, launched cooperatively
//   (cudaLaunchCooperativeKernel, so a grid that cannot be co-resident is
//   refused, never hung). Block b owns a contiguous slice of x (whole
//   16-element units). Pass 1: one thread issues 1-D bulk copies
//   (cp.async.bulk, 16 KB chunks, all at once) of the slice into a
//   shared-memory stash of up to 14 chunks, each on its own mbarrier; the
//   warps take the block's max as the chunks land, then one atomic max a
//   block on an unsigned word. One grid barrier (generation-counted, so
//   launches on one stream reuse the words without a memset: the last
//   arrival zeroes the next launch's words; a watchdog traps a barrier
//   stuck for about 2^34 cycles instead of hanging the card).
//   Pass 2: each warp quantizes a contiguous run of the stash, 1 KB a
//   step, writes the int8 values in place over the front of its run (which
//   it has read) and sends them out with its own bulk stores
//   (cp.async.bulk shared -> global), so that no block-wide barrier stands
//   between the steps.
//   A slice larger than the stash (the 1,024-channel inputs at 96x96:
//   151 MB at bs8 in bf16) keeps its first 10 chunks in the stash and
//   streams the rest through a 4-chunk ring (full and empty mbarriers) in
//   pass 1 and again in pass 2, newest first, so that what pass 1 read
//   last, and the L2 still holds, is read first; there each warp quantizes
//   its part of a chunk and stores it from registers. The ring's first
//   pass-2 loads are issued before the grid barrier.
//   A tiny input (at most 32 KB: the squeeze-excite convs' (8, C, 1, 1))
//   takes one block and no grid barrier.
// - Static scale (quantize_flat_kernel): a plain grid-stride loop, two
//   16-byte vectors of x a thread an iteration, both loads issued before
//   either is quantized. (A bulk-copy pipeline like the dynamic one's,
//   with no barrier, measured slower on the H100: 6.48 against 5.25 ms
//   an unfused int8 forward at bs8.)
// - The arithmetic is the rounding of `quant_f`: a multiply by the
//   reciprocal and an add of 1.5 * 2^23 decide the rounded quotient
//   wherever that is provably the IEEE quotient's rounding; the division
//   decides the rest (see quant_f).
// - NCHW-contiguous x (quantize_nchw_*): the dynamic scale is one
//   cooperative launch (a flat vector max, the grid barrier, then the
//   quantize), the static one a plain launch; the quantize reads along the
//   pixels (one thread per pixel, coalesced) and writes each pixel's run
//   of channels. x is read twice on the dynamic path.
// The tail of x that is not a whole 16-element unit is read and written
// by the threads of the last block; x's address is 16-byte aligned (the
// wrapper copies an unaligned x).
//
// chip_smoke.py (phase 20a) holds every variant bit for bit (q and
// a_scale) against the plain version at every dense-conv input of the
// flagship's int8 forwards, with and without the ReLU, and on NCHW,
// too-large, tiny and special-value inputs. Built by
// npp_tpu_torch/ops/quantize.py with nvcc into a shared library with a
// plain C interface, called through ctypes; its launch plan is
// quantize._quant_plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;      // a channels_last or dynamic block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16384;      // bytes of x per bulk copy
constexpr int kWarpBytes = kChunk / kWarps;  // a warp's part of a chunk
constexpr int kVecs = kWarpBytes / 16 / 32;  // 16-byte vectors a lane
constexpr int kMaxRing = 4;        // ring chunks (the streamed parts)
constexpr int kUnit = 16;          // elements: a slice's granularity
constexpr int kMaxStash = 14;      // stash chunks a block, at most
constexpr int kBarrierBytes = 512; // the mbarriers
// The most dynamic shared memory a block takes: 14 chunks of stash or
// ring, beside the barriers (within the 232,448 bytes a Hopper block may
// use, with its static shared memory).
constexpr int kSmemMax = kBarrierBytes + kMaxStash * kChunk;
constexpr int kLoopThreads = 256;  // the plain grid-stride loops
constexpr int kPair = 2;           // 16-byte vectors a loop thread an iteration

static_assert((kMaxStash + 2 * kMaxRing) * 8 <= kBarrierBytes,
              "barrier space");
static_assert(kSmemMax + 1024 <= 232448, "shared memory");
static_assert(kVecs >= 1, "a vector a lane");

struct Args {
  const void* x;
  int64_t n;            // elements
  int c, hw;            // NCHW: channels, pixels an image
  float* scale;         // dynamic: written by block 0; static: read
  int8_t* q;
  unsigned int* sync;   // [generation, arrivals[2], max words[2]]
  int stash_chunks;     // stash chunks a block (dynamic)
  int ring;             // ring chunks (0: the slices fit the stash)
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Waits for the phase of parity `parity` to complete; a copy stuck for
// about 2^34 cycles (seconds) traps, so that a fault raises at the next
// synchronisation instead of hanging the card.
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

// `bytes` (a multiple of 16) from global to shared memory, completing on
// the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory, in a bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N bulk groups still reading their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// max(a, b), a NaN if either is one (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// ---- the arithmetic ----------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// torch.relu: a NaN stays (the comparison is false), negatives and -0.0
// become +0.
template <bool RELU>
__device__ __forceinline__ float pre(float v) {
  return (RELU && v < 0.f) ? 0.f : v;
}

template <bool RELU, typename T>
__device__ __forceinline__ unsigned int mag_bits(T v) {
  return __float_as_uint(pre<RELU>(to_float(v))) & 0x7fffffffu;
}

// round(x' / scale) as PyTorch computes it (rintf of the IEEE quotient),
// clipped to +-127 when CLIP (a NaN stays NaN there, then converts to 0).
// inv is __frcp_rn(scale). The quotient's rounding is read off
// r = RN(x' * inv) where that is safe: r and RN(x' / scale) both lie
// within |x' / scale| * 2^-23 (about 3.1e-5 for |r| <= 256) of the true
// quotient, so where r is farther than 2e-4 from a half-integer, both
// round to the same integer. r rounds to the nearest integer, ties to
// even, by adding 1.5 * 2^23 (whose float32 ulp is 1), and the integer is
// read from the sum's low bits: no conversion instruction, which runs at
// a quarter of the float rate. Elsewhere, and for a non-finite r (a NaN
// or inf input or scale), the division itself decides.
template <bool CLIP>
__device__ __noinline__ int quant_exact(float xf, float scale) {
  float q = rintf(__fdiv_rn(xf, scale));
  if (CLIP && q == q) q = fminf(fmaxf(q, -127.f), 127.f);
  return __float2int_rn(q);
}

// xf is x' (the ReLU applied where it is folded in).
template <bool CLIP>
__device__ __forceinline__ int quant_f(float xf, float scale, float inv) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  const float r = __fmul_rn(xf, inv);
  const float t = __fadd_rn(r, kMagic);
  int q = __float_as_int(t) - 0x4B400000;
  if (!(fabsf(r) <= 256.f &&
        fabsf(__fsub_rn(r, __fsub_rn(t, kMagic))) < 0.4998f)) {
    q = quant_exact<CLIP>(xf, scale);
  }
  if (CLIP) q = min(max(q, -127), 127);
  return q;
}

template <bool CLIP, bool RELU, typename T>
__device__ __forceinline__ int quant(T v, float scale, float inv) {
  return quant_f<CLIP>(pre<RELU>(to_float(v)), scale, inv);
}

// The 16 / sizeof(T) elements of a 16-byte vector of x as floats, in
// order: a bf16 is the high half of its float, so two come out of each
// 32-bit word by a shift and a mask. (Reading the vector's elements
// through a T* would let nvcc load them from shared memory one by one.)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 2) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    } else {
      f[k] = __uint_as_float(w[k]);
    }
  }
}

// The low bytes of four quantized values, in order.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  const uint32_t lo = __byte_perm(a, b, 0x0040);
  const uint32_t hi = __byte_perm(c, d, 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ float dynamic_scale(unsigned int bits) {
  const float amax = __uint_as_float(bits);
  const float m = amax != amax ? amax : fmaxf(amax, 1e-8f);
  return __fmul_rn(m, __frcp_rn(127.0f));
}

template <int THREADS>
__device__ __forceinline__ unsigned int block_max(unsigned int v,
                                                  unsigned int* s_warp) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? s_warp[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
  }
  __syncthreads();
  return v;  // valid in warp 0
}

// The grid's max of each block's `mx` (thread 0's), through one grid
// barrier; returns it in thread 0. sync: [generation, arrivals and max
// words of even generations, of odd ones: arrivals[2], max[2]], all 0
// before the first launch. Each block adds its max and then its arrival
// (whose release orders the max before it) to its generation's words and
// waits until the arrivals reach the grid (the acquire that sees the last
// one sees every block's max). The last arrival zeroes the other
// generation's words, which the previous launch on the stream is done
// with, and advances the generation for the next launch; no block waits
// for that.
__device__ unsigned int grid_max(unsigned int mx, unsigned int* sync) {
  const unsigned int g = ld_acquire(sync) & 1u;
  unsigned int* arrivals = sync + 1 + g;
  unsigned int* word = sync + 3 + g;
  asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(word),
               "r"(mx)
               : "memory");
  unsigned int before;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(before)
               : "l"(arrivals)
               : "memory");
  if (before == gridDim.x - 1) {
    *reinterpret_cast<volatile unsigned int*>(sync + 2 - g) = 0u;
    *reinterpret_cast<volatile unsigned int*>(sync + 4 - g) = 0u;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(sync)
                 : "memory");
  } else {
    const long long start = clock64();
    while (ld_acquire(arrivals) != gridDim.x) {
      if (clock64() - start > (1ll << 34)) __trap();
    }
  }
  return ld_acquire(word);
}

// The max of |x'| over the elements of a 16-byte vector of x.
template <bool RELU, typename T>
__device__ __forceinline__ unsigned int vec_max(const uint4& raw,
                                                unsigned int mx) {
  constexpr int kVec = 16 / sizeof(T);
  float f[kVec];
  unpack<T>(raw, f);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mx = max(mx, __float_as_uint(pre<RELU>(f[j])) & 0x7fffffffu);
  }
  return mx;
}

// The max of |x'| over this warp's part of a chunk of `bytes` in shared
// memory (lane l: the 16-byte vectors l, l + 32, ... of the part).
template <bool RELU, typename T>
__device__ __forceinline__ unsigned int part_max(const unsigned char* buf,
                                                 int bytes,
                                                 unsigned int mx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int off = warp * kWarpBytes + 16 * (lane + 32 * i);
    if (off < bytes) {
      mx = vec_max<RELU, T>(*reinterpret_cast<const uint4*>(buf + off), mx);
    }
  }
  return mx;
}

// One 16-byte vector of x quantized: 16 / sizeof(T) int8 values, packed
// into w in order. The fast rounding of `quant_f` for all of them, and the
// exact one for the whole vector in the rare case that one needs it, so
// that a warp branches once a vector and not once an element. The ReLU is
// fmaxf(x, 0) here, which maps a NaN to 0 where torch.relu keeps it: both
// quantize to 0. Without CLIP (a dynamic scale) |r| <= 127 * (1 + 2^-23)
// for every finite x', and a non-finite r fails the fraction test, so the
// |r| test is left out.
template <bool CLIP, bool RELU, typename T>
__device__ __forceinline__ void quant_vec(const uint4& raw, float scale,
                                          float inv, uint32_t* w) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  float f[kVec];
  unpack<T>(raw, f);
  int q[kVec];
  float far = 0.f;  // the largest |r - round(r)|, or NaN
  bool big = false;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (RELU) f[j] = fmaxf(f[j], 0.f);
    const float r = __fmul_rn(f[j], inv);
    const float t = __fadd_rn(r, kMagic);
    q[j] = __float_as_int(t) - 0x4B400000;
    far = max_nan(far, fabsf(__fsub_rn(r, __fsub_rn(t, kMagic))));
    if (CLIP) {
      big |= !(fabsf(r) <= 256.f);
      q[j] = min(max(q[j], -127), 127);
    }
  }
  if (!(far < 0.4998f) || big) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) q[j] = quant_f<CLIP>(f[j], scale, inv);
  }
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    w[k] = pack4(q[4 * k], q[4 * k + 1], q[4 * k + 2], q[4 * k + 3]);
  }
}

// Stores this lane's quantized vector (16 / sizeof(T) bytes) at out + i.
template <typename T>
__device__ __forceinline__ void put_vec(unsigned char* out, int i,
                                        const uint32_t* w) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(out + 8 * i) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(out + 4 * i) = w[0];
  }
}

// This warp's part of a chunk of `bytes` in shared memory quantized into
// `out` (the chunk's int8 values in device memory, in order): kWarpBytes
// of x a warp, 16-byte vectors a lane, stored as 8 or 4 bytes each.
template <bool CLIP, bool RELU, typename T>
__device__ __forceinline__ void part_quant(const unsigned char* buf,
                                           int bytes, float scale, float inv,
                                           unsigned char* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = warp * (kWarpBytes / 16) + lane + 32 * i;
    if (16 * v < bytes) {
      uint32_t w[4 / sizeof(T)];
      quant_vec<CLIP, RELU, T>(*reinterpret_cast<const uint4*>(buf + 16 * v),
                               scale, inv, w);
      put_vec<T>(out, v, w);
    }
  }
}

// ---- channels_last: element i of x is element i of q -------------------------

// The dynamic scale. Shared memory: the mbarriers (stash full; ring full;
// ring empty), the stash, the ring. Thread 0 issues every bulk copy of x.
// Pass 2 of the stash: each warp a contiguous run of 1 KB steps, its int8
// values in place over the front of the run (which the warp has read) and
// out by the warp's bulk stores. A ring chunk (the streamed rest of a
// slice): each warp its kWarpBytes part of it, stored from registers; the
// slot is refilled once all the warps have arrived on its empty barrier.
// No block-wide barrier stands between the steps.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
    quantize_nhwc_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned int s_warp[kWarps];
  __shared__ float s_scale;
  constexpr int kE = sizeof(T);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bars + kMaxStash;
  uint64_t* empty = full + kMaxRing;
  unsigned char* stash = smem + kBarrierBytes;
  unsigned char* ring = stash + a.stash_chunks * kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int depth = a.ring;
  const T* x = static_cast<const T*>(a.x);

  // This block's slice: units [u0, u1) of kUnit elements.
  const int64_t units = a.n / kUnit;
  const int64_t body = units * kUnit;
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int64_t e0 = u0 * kUnit;
  const int64_t bytes = (u1 - u0) * kUnit * kE;
  const int nchunks = static_cast<int>((bytes + kChunk - 1) / kChunk);
  const int ns = min(nchunks, a.stash_chunks);  // chunks in the stash
  const int no = nchunks - ns;                   // streamed
  const int64_t stashed = int64_t{ns} * kChunk;
  const int sbytes = static_cast<int>(bytes < stashed ? bytes : stashed);
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + e0);
  int8_t* dst = a.q + e0;
  const bool last = blockIdx.x == gridDim.x - 1;
  auto len = [&](int chunk) {
    const int64_t rest = bytes - int64_t{chunk} * kChunk;
    return static_cast<int>(rest < kChunk ? rest : kChunk);
  };
  auto load = [&](uint32_t bar, unsigned char* buf, int chunk) {
    const int n_bytes = len(chunk);
    mbar_expect_tx(bar, n_bytes);
    bulk_load(smem_u32(buf), src + int64_t{chunk} * kChunk, n_bytes, bar);
  };
  // Ring use g (pass 1: 0 .. no - 1; pass 2: no .. 2 no - 1) takes
  // slot g % depth; the slot's previous use must be read by every warp.
  auto ring_buf = [&](int g) { return ring + (g % depth) * kChunk; };
  auto ring_load = [&](int g, int chunk) {
    if (g >= depth) {
      mbar_wait(smem_u32(&empty[g % depth]), ((g / depth) - 1) & 1);
    }
    load(smem_u32(&full[g % depth]), ring_buf(g), chunk);
  };
  auto ring_wait = [&](int g) {
    mbar_wait(smem_u32(&full[g % depth]), (g / depth) & 1);
  };
  auto ring_done = [&](int g) {  // this warp has read use g
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[g % depth]));
  };
  // The k-th streamed chunk of pass 2: newest first.
  auto streamed = [&](int k) { return ns + no - 1 - k; };

  // The barriers in use, one a thread: the stash's, the ring's full, its
  // empty ones.
  if (tid < ns) mbar_init(smem_u32(&bars[tid]), 1);
  if (tid < depth) {
    mbar_init(smem_u32(&full[tid]), 1);
    mbar_init(smem_u32(&empty[tid]), kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  // The stash's copies all at once, the ring's first ones.
  if (tid == 0) {
    for (int j = 0; j < ns; ++j) load(smem_u32(&bars[j]), stash + j * kChunk, j);
    for (int g = 0; g < min(no, depth); ++g) ring_load(g, ns + g);
  }
  // Pass 1: the max, chunk by chunk as they land.
  unsigned int mx = 0u;
  for (int j = 0; j < ns; ++j) {
    mbar_wait(smem_u32(&bars[j]), 0);
    mx = part_max<RELU, T>(stash + j * kChunk, len(j), mx);
  }
  for (int g = 0; g < no; ++g) {
    ring_wait(g);
    mx = part_max<RELU, T>(ring_buf(g), len(ns + g), mx);
    ring_done(g);
    if (tid == 0 && g + depth < no) ring_load(g + depth, ns + g + depth);
  }
  if (last) {
    for (int64_t i = body + tid; i < a.n; i += kThreads) {
      mx = max(mx, mag_bits<RELU>(x[i]));
    }
  }
  // Pass 2's first streamed chunks, while the grid meets.
  if (tid == 0) {
    for (int k = 0; k < min(no, depth); ++k) ring_load(no + k, streamed(k));
  }
  mx = block_max<kThreads>(mx, s_warp);
  if (tid == 0) {
    if (gridDim.x > 1) mx = grid_max(mx, a.sync);
    s_scale = dynamic_scale(mx);
    if (blockIdx.x == 0) *a.scale = s_scale;
  }
  __syncthreads();
  const float scale = s_scale;
  const float inv = __frcp_rn(scale);

  // Pass 2, the streamed chunks, newest first.
  for (int k = 0; k < no; ++k) {
    const int g = no + k, chunk = streamed(k);
    ring_wait(g);
    part_quant<false, RELU, T>(
        ring_buf(g), len(chunk), scale, inv,
        reinterpret_cast<unsigned char*>(dst) + int64_t{chunk} * (kChunk / kE));
    ring_done(g);
    if (tid == 0 && k + depth < no) ring_load(g + depth, streamed(k + depth));
  }

  // Pass 2, the stash: warp w takes steps [s0, s1) of it, two 16-byte
  // vectors a lane a step, and writes each step's int8 values in place
  // over the front of its run.
  constexpr int kStep = 1024;  // bytes of x a warp step
  constexpr int kFlush = 2;    // steps a bulk store
  const int steps = (sbytes + kStep - 1) / kStep;
  const int s0 = steps * warp / kWarps, s1 = steps * (warp + 1) / kWarps;
  unsigned char* run = stash + s0 * kStep;
  int flushed = s0;
  for (int st = s0; st < s1; ++st) {
    uint32_t w[2][4 / kE];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = st * kStep + 16 * (lane + 32 * i);
      if (off < sbytes) {
        quant_vec<false, RELU, T>(
            *reinterpret_cast<const uint4*>(stash + off), scale, inv, w[i]);
      }
    }
    __syncwarp();  // the step is read before its values overwrite it
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (st * kStep + 16 * (lane + 32 * i) < sbytes) {
        put_vec<T>(run + (st - s0) * (kStep / kE), lane + 32 * i, w[i]);
      }
    }
    if (st + 1 - flushed == kFlush || st + 1 == s1) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        const int from = flushed * kStep;
        const int to = min((st + 1) * kStep, sbytes);
        bulk_store(dst + from / kE,
                   smem_u32(run + (flushed - s0) * (kStep / kE)),
                   (to - from) / kE);
      }
      flushed = st + 1;
    }
  }
  if (last) {
    for (int64_t i = body + tid; i < a.n; i += kThreads) {
      a.q[i] = static_cast<int8_t>(quant<false, RELU>(x[i], scale, inv));
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the stores have read the shared memory
}

// The static scale: a grid-stride loop over the 16-byte vectors of x,
// kPair a thread an iteration (all the loads before any quantize), each
// written as 16 / sizeof(T) int8 values; the tail element by element.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kLoopThreads)
    quantize_flat_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(T);
  const float scale = __ldg(a.scale);
  const float inv = __frcp_rn(scale);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const uint4* __restrict__ xv = static_cast<const uint4*>(a.x);
  unsigned char* __restrict__ q = reinterpret_cast<unsigned char*>(a.q);
  const int64_t nvec = a.n / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kLoopThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kLoopThreads + threadIdx.x;
  for (; i + (kPair - 1) * stride < nvec; i += kPair * stride) {
    uint4 v[kPair];
#pragma unroll
    for (int k = 0; k < kPair; ++k) v[k] = __ldg(xv + i + k * stride);
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      uint32_t w[4 / sizeof(T)];
      quant_vec<true, RELU, T>(v[k], scale, inv, w);
      put_vec<T>(q, i + k * stride, w);
    }
  }
  for (; i < nvec; i += stride) {
    uint32_t w[4 / sizeof(T)];
    quant_vec<true, RELU, T>(__ldg(xv + i), scale, inv, w);
    put_vec<T>(q, i, w);
  }
  for (int64_t e = nvec * kVec + static_cast<int64_t>(blockIdx.x) *
                   kLoopThreads + threadIdx.x;
       e < a.n; e += stride) {
    a.q[e] = static_cast<int8_t>(quant<true, RELU>(x[e], scale, inv));
  }
}

// ---- NCHW-contiguous x (N, C, H*W): one thread per pixel ---------------------

template <bool CLIP, bool RELU, typename T>
__device__ __forceinline__ void quantize_pixels(const T* x, int c, int hw,
                                                int64_t pixels, float scale,
                                                int8_t* q) {
  const float inv = __frcp_rn(scale);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < pixels; p += stride) {
    const int64_t img = p / hw;
    const T* src = x + img * c * hw + (p - img * hw);
    int8_t* dst = q + p * c;
    for (int ch = 0; ch < c; ++ch) {
      dst[ch] = static_cast<int8_t>(
          quant<CLIP, RELU>(src[static_cast<int64_t>(ch) * hw], scale, inv));
    }
  }
}

// Dynamic: a flat max over x (16-byte loads), the grid barrier, then the
// quantize. One block an SM, launched cooperatively.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
    quantize_nchw_dynamic_kernel(const Args a) {
  __shared__ unsigned int s_warp[kWarps];
  __shared__ float s_scale;
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int64_t nvec = a.n / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  unsigned int mx = 0u;
  for (int64_t i = first; i < nvec; i += stride) {
    mx = vec_max<RELU, T>(__ldg(xv + i), mx);
  }
  for (int64_t i = nvec * kVec + first; i < a.n; i += stride) {
    mx = max(mx, mag_bits<RELU>(x[i]));
  }
  mx = block_max<kThreads>(mx, s_warp);
  if (threadIdx.x == 0) {
    if (gridDim.x > 1) mx = grid_max(mx, a.sync);
    s_scale = dynamic_scale(mx);
    if (blockIdx.x == 0) *a.scale = s_scale;
  }
  __syncthreads();
  quantize_pixels<false, RELU>(x, a.c, a.hw, a.n / a.c, s_scale, a.q);
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(kLoopThreads)
    quantize_nchw_static_kernel(const Args a) {
  quantize_pixels<true, RELU>(static_cast<const T*>(a.x), a.c, a.hw,
                              a.n / a.c, __ldg(a.scale), a.q);
}

// ---- the absmax alone (calibration; a grid's dynamic scale) ----------------

// stats[0] = max|x'|, stats[1] = the dynamic scale, over a dense x (vec: x
// is 16-byte aligned, so 16-byte loads cover all but the tail; x' =
// relu(x) with RELU, as the quantize takes it). The blocks each write a
// partial maximum; the last to finish (a counter, reset by that block)
// reduces them. It runs under calibrate_acts, and on a grid of ranks
// before the MAX all-reduce that makes the dynamic scale the grid's.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kLoopThreads)
    absmax_kernel(const T* x, int64_t n, int vec, unsigned int* partials,
                  unsigned int* counter, float* stats) {
  __shared__ unsigned int s_warp[kLoopThreads / 32];
  __shared__ int s_last;
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kLoopThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kLoopThreads +
                        threadIdx.x;
  unsigned int mx = 0u;
  const int64_t nvec = vec ? n / kVec : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
  for (int64_t i = first; i < nvec; i += stride) {
    mx = vec_max<RELU, T>(__ldg(xv + i), mx);
  }
  for (int64_t i = nvec * kVec + first; i < n; i += stride) {
    mx = max(mx, mag_bits<RELU>(x[i]));
  }
  mx = block_max<kLoopThreads>(mx, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mx;
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  mx = 0u;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += kLoopThreads) {
    mx = max(mx, __ldcg(partials + i));
  }
  mx = block_max<kLoopThreads>(mx, s_warp);
  if (threadIdx.x == 0) {
    stats[0] = __uint_as_float(mx);
    stats[1] = dynamic_scale(mx);
    *counter = 0u;  // ready for the next launch
  }
}

// ---- launches ----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid, int threads, int smem,
                   bool cooperative, const Args& a, cudaStream_t s) {
  if (cooperative) {
    Args copy = a;
    void* params[] = {&copy};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                       dim3(grid), dim3(threads), params,
                                       static_cast<size_t>(smem), s);
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// variant: 0 tiny (channels_last, dynamic, one block), 1 cooperative
// (channels_last, dynamic), 2 flat (channels_last, static), 3 nchw
// (dynamic, cooperative), 4 nchw_static.
template <typename T, bool RELU>
cudaError_t launch_variant(int variant, const Args& a, int grid, int smem,
                           cudaStream_t s) {
  const bool many = grid > 1;
  switch (variant) {
    case 0:
    case 1:
      return launch(quantize_nhwc_kernel<T, RELU>, grid, kThreads, smem,
                    many, a, s);
    case 2:
      return launch(quantize_flat_kernel<T, RELU>, grid, kLoopThreads, 0,
                    false, a, s);
    case 3:
      return launch(quantize_nchw_dynamic_kernel<T, RELU>, grid, kThreads, 0,
                    many, a, s);
    case 4:
      return launch(quantize_nchw_static_kernel<T, RELU>, grid,
                    kLoopThreads, 0, false, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The dynamic channels_last kernel may take up to kSmemMax bytes of
// dynamic shared memory: raised once, for all four.
template <typename T, bool RELU>
cudaError_t raise_smem() {
  return cudaFuncSetAttribute(quantize_nhwc_kernel<T, RELU>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

cudaError_t raise_smem_once() {
  static bool raised = false;
  if (raised) return cudaSuccess;
  cudaError_t err = raise_smem<float, false>();
  if (err == cudaSuccess) err = raise_smem<float, true>();
  if (err == cudaSuccess) err = raise_smem<__nv_bfloat16, false>();
  if (err == cudaSuccess) err = raise_smem<__nv_bfloat16, true>();
  raised = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch_relu(int relu, int variant, const Args& a, int grid,
                        int smem, cudaStream_t s) {
  return relu ? launch_variant<T, true>(variant, a, grid, smem, s)
              : launch_variant<T, false>(variant, a, grid, smem, s);
}

}  // namespace

// Each returns a cudaError_t (0 on success). dtype: 0 float32, 1 bfloat16.

template <typename T>
void launch_absmax(int relu, const void* x, long long n, int vec,
                   unsigned int* part, unsigned int* cnt, float* stats,
                   int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (relu) {
    absmax_kernel<T, true><<<blocks, kLoopThreads, 0, s>>>(xt, n, vec, part,
                                                          cnt, stats);
  } else {
    absmax_kernel<T, false><<<blocks, kLoopThreads, 0, s>>>(xt, n, vec, part,
                                                           cnt, stats);
  }
}

// max|x'| and the dynamic scale into stats (2 floats on the device), over
// the n elements of a dense x (relu: 1 takes x' = torch.relu(x)), with
// `blocks` blocks: partials holds one unsigned int per block, counter one
// that is 0 between launches.
extern "C" int npp_act_absmax(const void* x, int dtype, long long n, int vec,
                              int relu, void* partials, void* counter,
                              float* stats, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* part = static_cast<unsigned int*>(partials);
  unsigned int* cnt = static_cast<unsigned int*>(counter);
  if (dtype == 0) {
    launch_absmax<float>(relu, x, n, vec, part, cnt, stats, blocks, s);
  } else if (dtype == 1) {
    launch_absmax<__nv_bfloat16>(relu, x, n, vec, part, cnt, stats, blocks,
                                 s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (N, H, W, C) int8 from the n elements of x, in quantize._quant_plan's
// launch: variant, grid, stash_chunks, ring (chunks) and smem_bytes. x is
// 16-byte aligned, channels_last (variants 0-2) or NCHW-contiguous (3-4,
// C channels of hw pixels an image). relu: 1 applies torch.relu first.
// scale: a device float, written with the dynamic scale (variants 0, 1,
// 3) or read as the static one (2, 4), whose q is clipped to +-127. sync:
// 5 unsigned ints, 0 before the first launch, for one stream at a time.
extern "C" int npp_quantize_act(const void* x, int dtype, int variant,
                                long long n, int c, int hw, int relu,
                                float* scale, int8_t* q, void* sync, int grid,
                                int stash_chunks, int ring, int smem_bytes,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant < 0 || variant > 4 || grid < 1 || n < 1 ||
      stash_chunks < 0 || stash_chunks > kMaxStash || ring < 0 ||
      ring > kMaxRing ||
      smem_bytes > kSmemMax || (variant >= 3 && c < 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int need = kBarrierBytes + (stash_chunks + ring) * kChunk;
  if (variant <= 1 ? smem_bytes != need : smem_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.x = x;
  a.n = n;
  a.c = c;
  a.hw = hw;
  a.scale = scale;
  a.q = q;
  a.sync = static_cast<unsigned int*>(sync);
  a.stash_chunks = stash_chunks;
  a.ring = ring;
  const cudaError_t raised = raise_smem_once();
  if (raised != cudaSuccess) return static_cast<int>(raised);
  if (dtype == 0) {
    return static_cast<int>(
        launch_relu<float>(relu, variant, a, grid, smem_bytes, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch_relu<__nv_bfloat16>(relu, variant, a, grid, smem_bytes, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
