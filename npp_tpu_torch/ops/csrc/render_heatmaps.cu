// Gaussian pose-heatmap renderer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel npp_tpu/ops/pallas_kernels.py:
// _render_kernel / render_heatmaps_pallas (pl.pallas_call at line 71).
// For batch element b and joint j it renders
//     m = exp(-((x - cx)^2 + (y - cy)^2) / (2 sigma^2)),
// set to 0 where the exponent is > 4.6052, times vis[b, j], on a grid
// whose centres sit at stride/2 - 0.5 + i * stride; then a background
// channel 1 - max_j m. The same is rendered at 2 sigma (the aux maps).
//
// What bounds it on this card: the output bytes. At the eval slice's
// shape (B=8, J=16, 96x96) the two outputs are 2 * 8*96*96*17*4 bytes
// = 10 MB against 1.5 KB of input, and each output value costs one expf.
// The design therefore writes every output byte once and nothing else:
// one thread per output pixel (b, y, x) loops over the J joints with the
// joints of its batch element in shared memory, keeps the running max of
// both sigmas in registers, and writes its J+1 channels contiguously,
// directly in NHWC. The Pallas kernel wrote channel-major and then
// transposed (pallas_kernels.py:89-90); that pass is gone.
//
// Rounding: the exponent is computed in the op order of the plain
// version (npp_tpu_torch/ops/heatmaps.py:render_heatmaps_reference):
// dx*dx + dy*dy, then a true division by 2 sigma^2, with explicit
// round-to-nearest intrinsics so that nvcc cannot contract them into an
// FMA. A different rounding can flip the > 4.6052 cut on a boundary
// pixel: 0 against ~0.01. expf, never __expf; no --use_fast_math. The
// file is built without -fmad=false so that expf compiles as it does in
// PyTorch's own exp kernel, which the plain version calls.
//
// Built by npp_tpu_torch/ops/heatmaps.py with nvcc into a shared library
// with a plain C interface, and called through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr float kTrunc = 4.6052f;

__device__ __forceinline__ float gaussian(float xs, float ys, float cx,
                                          float cy, float two_sig2,
                                          float v) {
  const float dx = __fsub_rn(xs, cx);
  const float dy = __fsub_rn(ys, cy);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float expo = __fdiv_rn(d2, two_sig2);
  const float m = expo > kTrunc ? 0.0f : expf(-expo);
  return __fmul_rn(m, v);
}

__global__ void render_heatmaps_kernel(const float* __restrict__ joints,
                                       const float* __restrict__ vis,
                                       float* __restrict__ main_out,
                                       float* __restrict__ aux_out,
                                       int num_joints, int grid_y, int grid_x,
                                       float stride, float two_sig2_main,
                                       float two_sig2_aux) {
  extern __shared__ float smem[];  // cx[J], cy[J], v[J]
  float* s_cx = smem;
  float* s_cy = smem + num_joints;
  float* s_v = smem + 2 * num_joints;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < num_joints; j += blockDim.x) {
    s_cx[j] = joints[(b * num_joints + j) * 2 + 0];
    s_cy[j] = joints[(b * num_joints + j) * 2 + 1];
    s_v[j] = vis[b * num_joints + j];
  }
  __syncthreads();

  const int n_pix = grid_y * grid_x;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int y = p / grid_x;
  const int x = p - y * grid_x;
  const float start = __fsub_rn(__fmul_rn(stride, 0.5f), 0.5f);
  const float xs = __fadd_rn(start, __fmul_rn(static_cast<float>(x), stride));
  const float ys = __fadd_rn(start, __fmul_rn(static_cast<float>(y), stride));

  const long long out_off =
      (static_cast<long long>(b) * n_pix + p) * (num_joints + 1);
  float* m_out = main_out + out_off;
  float* a_out = aux_out + out_off;
  float bg_main = 0.0f;
  float bg_aux = 0.0f;
  for (int j = 0; j < num_joints; ++j) {
    const float cx = s_cx[j], cy = s_cy[j], v = s_v[j];
    const float m = gaussian(xs, ys, cx, cy, two_sig2_main, v);
    const float a = gaussian(xs, ys, cx, cy, two_sig2_aux, v);
    m_out[j] = m;
    a_out[j] = a;
    bg_main = fmaxf(bg_main, m);
    bg_aux = fmaxf(bg_aux, a);
  }
  m_out[num_joints] = __fsub_rn(1.0f, bg_main);
  a_out[num_joints] = __fsub_rn(1.0f, bg_aux);
}

}  // namespace

// joints (B, J, 2) f32, vis (B, J) f32 -> main, aux (B, gy, gx, J+1) f32,
// all contiguous on the device. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int npp_render_heatmaps(const float* joints, const float* vis,
                                   float* main_out, float* aux_out,
                                   int batch, int num_joints, int grid_y,
                                   int grid_x, int stride, float sigma,
                                   void* stream) {
  const int threads = 256;
  const int n_pix = grid_y * grid_x;
  const dim3 grid((n_pix + threads - 1) / threads, batch);
  const size_t smem = 3 * static_cast<size_t>(num_joints) * sizeof(float);
  // 2 sigma^2 in double, as the reference's Python scalar; exact for the
  // integer and half-integer sigmas in use.
  const float two_sig2_main = static_cast<float>(2.0 * sigma * sigma);
  const float two_sig2_aux = static_cast<float>(2.0 * (2.0 * sigma) *
                                                (2.0 * sigma));
  render_heatmaps_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      joints, vis, main_out, aux_out, num_joints, grid_y, grid_x,
      static_cast<float>(stride), two_sig2_main, two_sig2_aux);
  return static_cast<int>(cudaGetLastError());
}
