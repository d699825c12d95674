// The activation quantize of the int8 serving layer for Hopper (sm_90a):
// bf16 or fp32 activations -> int8 NHWC, with the per-tensor scale found
// and kept on the device.
//
// Replaces the quantize that npp_tpu/ops/quantize.py:int8_conv runs before
// its int8 conv (lines 100-109): XLA fused it into the conv's producer on
// the TPU; eager PyTorch ran it as about eight elementwise kernels and
// dtype copies per conv, each moving a 4-byte intermediate. It computes
//     dynamic: a_scale = max(max|x|, 1e-8) / 127,  q = round(x / a_scale)
//     static:  a_scale given,                       q = clip(round(x / a_scale),
//                                                            -127, 127)
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
//   not __fdiv_rn(..., 127.0f): the two differ for some absmax. (On the
//   CPU, PyTorch and npp_tpu divide; the card's plain version is the rule
//   here.)
// - "x / a_scale" divides by a device tensor, which PyTorch computes as an
//   IEEE division: __fdiv_rn. torch.round rounds half to even: rintf.
//   torch.clamp keeps a NaN; fminf / fmaxf would drop it, so the clip
//   tests for it.
// - max|x| is taken on the bit patterns of |x| as unsigned integers, which
//   order non-negative floats as the floats do and put a NaN above inf, as
//   torch.amax propagates it.
//
// What bounds it: bytes. It reads x once per launch and writes one byte
// per element; an absmax launch reads x once more (dynamic scale only).
// Launches: the static scale one (quantize); the dynamic two (absmax, then
// quantize), with no host synchronisation: the absmax launch's blocks each
// write a partial maximum, and the last block to finish (a counter, reset
// by that block) reduces them and writes max|x| and a_scale to the device.
// The quantize launch reads a_scale from there. A channels_last input maps
// element i to output i: 16-byte loads, 8-byte stores. An NCHW input is
// read along the pixels (one thread per pixel, coalesced) and written as
// that pixel's run of channels.
//
// chip_smoke.py (phase 20a) holds both launches bit for bit (q and
// a_scale) against the plain version at every dense-conv input of the
// flagship's int8 forwards. Built by npp_tpu_torch/ops/quantize.py with
// nvcc into a shared library with a plain C interface, called through
// ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned int abs_bits(__nv_bfloat16 v) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(v) & 0x7fffu) << 16;
}

// A zero (half of a ReLU's outputs) quantizes to 0 without the division,
// whose slow path it would take; the result is the same.
template <bool CLIP, typename T>
__device__ __forceinline__ uint32_t quant(T v, float scale) {
  const float xf = to_float(v);
  if (xf == 0.f) return 0u;
  float q = rintf(__fdiv_rn(xf, scale));
  if (CLIP && q == q) q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(q))));
}

__device__ __forceinline__ unsigned int block_max(unsigned int v,
                                                  unsigned int* s_warp) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? s_warp[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
  }
  __syncthreads();
  return v;  // valid in warp 0
}

// stats[0] = max|x|, stats[1] = the dynamic scale. vec: x is 16-byte
// aligned, so 16-byte loads cover all but the tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* x, int64_t n, int vec, unsigned int* partials,
                  unsigned int* counter, float* stats) {
  __shared__ unsigned int s_warp[kThreads / 32];
  __shared__ int s_last;
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  unsigned int mx = 0u;
  const int64_t nvec = vec ? n / kVec : 0;
  const int4* xv = reinterpret_cast<const int4*>(x);
#pragma unroll 4
  for (int64_t i = first; i < nvec; i += stride) {
    const int4 v = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) mx = max(mx, abs_bits(e[j]));
  }
  for (int64_t i = nvec * kVec + first; i < n; i += stride) {
    mx = max(mx, abs_bits(x[i]));
  }
  mx = block_max(mx, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mx;
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  mx = 0u;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    mx = max(mx, __ldcg(partials + i));
  }
  mx = block_max(mx, s_warp);
  if (threadIdx.x == 0) {
    const float amax = __uint_as_float(mx);
    const float m = amax != amax ? amax : fmaxf(amax, 1e-8f);
    stats[0] = amax;
    stats[1] = __fmul_rn(m, __frcp_rn(127.0f));
    *counter = 0u;  // ready for the next launch
  }
}

// Element i of a channels_last x is element i of q.
template <bool CLIP, typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_flat_kernel(const T* x, int64_t n, int vec, const float* scale_p,
                         int8_t* q) {
  const float scale = *scale_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int64_t n8 = vec ? n / 8 : 0;
  for (int64_t i = first; i < n8; i += stride) {
    alignas(16) T e[8];
    const int4* src = reinterpret_cast<const int4*>(x + 8 * i);
#pragma unroll
    for (int j = 0; j < static_cast<int>(sizeof(T)) / 2; ++j) {
      reinterpret_cast<int4*>(e)[j] = __ldg(src + j);
    }
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= quant<CLIP>(e[j], scale) << (8 * j);
      hi |= quant<CLIP>(e[4 + j], scale) << (8 * j);
    }
    reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
  }
  for (int64_t i = n8 * 8 + first; i < n; i += stride) {
    q[i] = static_cast<int8_t>(quant<CLIP>(x[i], scale));
  }
}

// An NCHW-contiguous x (N, C, H*W): one thread per pixel.
template <bool CLIP, typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_nchw_kernel(const T* x, int c, int hw, int64_t pixels,
                         const float* scale_p, int8_t* q) {
  const float scale = *scale_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < pixels; p += stride) {
    const int64_t img = p / hw;
    const T* src = x + img * c * hw + (p - img * hw);
    int8_t* dst = q + p * c;
    for (int ch = 0; ch < c; ++ch) {
      dst[ch] = static_cast<int8_t>(
          quant<CLIP>(src[static_cast<int64_t>(ch) * hw], scale));
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, int layout, int64_t n, int c,
                            int hw, int vec, const float* scale, int clip,
                            int8_t* q, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (layout == 0) {
    if (clip) {
      quantize_flat_kernel<true><<<blocks, kThreads, 0, s>>>(xt, n, vec,
                                                             scale, q);
    } else {
      quantize_flat_kernel<false><<<blocks, kThreads, 0, s>>>(xt, n, vec,
                                                              scale, q);
    }
  } else {
    const int64_t pixels = n / c;
    if (clip) {
      quantize_nchw_kernel<true><<<blocks, kThreads, 0, s>>>(xt, c, hw,
                                                             pixels, scale, q);
    } else {
      quantize_nchw_kernel<false><<<blocks, kThreads, 0, s>>>(
          xt, c, hw, pixels, scale, q);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 on success). dtype: 0 float32, 1 bfloat16.

// max|x| and the dynamic scale into stats (2 floats on the device), over
// the n elements of a dense x, with `blocks` blocks: partials holds one
// unsigned int per block, counter one that is 0 between launches.
extern "C" int npp_act_absmax(const void* x, int dtype, long long n, int vec,
                              void* partials, void* counter, float* stats,
                              int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* part = static_cast<unsigned int*>(partials);
  unsigned int* cnt = static_cast<unsigned int*>(counter);
  if (dtype == 0) {
    absmax_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                              vec, part, cnt, stats);
  } else if (dtype == 1) {
    absmax_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, vec, part, cnt, stats);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (N, H, W, C) int8 from x by the scale at `scale` (a device float),
// clipped to +-127 when clip is 1. layout: 0 channels_last (element i to
// element i; vec: 16-byte loads), 1 NCHW-contiguous (C channels of hw
// pixels an image).
extern "C" int npp_quantize_act(const void* x, int dtype, int layout,
                                long long n, int c, int hw, int vec,
                                const float* scale, int clip, int8_t* q,
                                int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout != 0 && layout != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(launch_quantize<float>(x, layout, n, c, hw, vec,
                                                   scale, clip, q, blocks, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_quantize<__nv_bfloat16>(
        x, layout, n, c, hw, vec, scale, clip, q, blocks, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
