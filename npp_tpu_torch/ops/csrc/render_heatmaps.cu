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
// What bounds it on this card: the bytes it writes. At the eval slice's
// shape (B=8, J=16, 96x96) the two NHWC outputs are 2 * 8*96*96*17*4 B
// = 10,027,008 B against 1.5 KB of input: 2.99 us at 3.35 TB/s. The work
// is one division and two expf per (pixel, joint) and no product, so the
// tensor cores play no part.
//
// Design. Each output is one contiguous (B*gy*gx, J+1) array, cut into
// tiles of P consecutive pixels (P a multiple of 4, from the wrapper's
// launch_geometry): one tile is one contiguous span of P*(J+1)*4 bytes,
// 16-byte aligned, and may cross from one batch element into the next.
// Persistent blocks walk over the tiles. For each tile a block
//   1. loads (cx, cy, v) of the batch elements the tile spans, and each
//      pixel's centre and batch row, into shared memory;
//   2. spreads the P*J (pixel, joint) pairs over its threads, consecutive
//      threads on consecutive joints, into two shared tiles s_main and
//      s_aux of P rows of pitch J+1 (odd at J=16: no bank conflicts);
//   3. takes, one thread per (pixel, output), the max over J in shared
//      memory and writes the background channel;
//   4. hands each tile to the Tensor Memory Accelerator as one bulk copy
//      (cp.async.bulk, shared -> global), started by one thread.
// Every output byte is written once. Each block keeps two tile buffers
// per output, so that computing tile k+1 overlaps the drain of tile k: a
// buffer is reused only after cp.async.bulk.wait_group.read 1 says its
// copy has read it. The last tile, when its byte count is not a multiple
// of 16 (what a bulk copy needs), is written with plain stores,
// consecutive threads on consecutive floats.
//
// Rounding: the exponent is computed in the op order of the plain
// version (npp_tpu_torch/ops/heatmaps.py:render_heatmaps_reference):
// dx*dx + dy*dy, then a true division by 2 sigma^2, with explicit
// round-to-nearest intrinsics so that nvcc cannot contract them into an
// FMA. A different rounding can flip the > 4.6052 cut on a boundary
// pixel: 0 against ~0.01. expf, never __expf; no --use_fast_math.
// One division serves both sigmas: the aux divisor float(8 sigma^2) is
// exactly 4 * float(2 sigma^2) (a power-of-two scale commutes with
// rounding, in double and in float), so RN(d2 / 8 sigma^2) equals
// RN(d2 / 2 sigma^2) * 0.25, and the product by 0.25 is exact. (Only an
// exponent in float's subnormal range could differ, and there exp(-x)
// rounds to 1 either way.) Most pairs lie beyond the cut at both sigmas
// (at sigma 3 on a 96x96 grid, a joint reaches about 65 of the 9,216
// pixels at 2 sigma). A pair whose d2 exceeds cut_d2 skips the division
// and both expf and renders 0 * v: cut_d2 (heatmaps.cut_threshold) is
// the float at or above c+ * float(2 sigma^2), c+ the float after
// 4 * 4.6052f, so d2 > cut_d2 gives RN(d2 / 2 sigma^2) >= c+ and both
// exponents over the cut, with no change in any bit.
//
// chip_smoke.py (phase 3) holds it bit for bit against the plain version
// and times it against the write bound; PERF.md keeps the numbers.
//
// Built by npp_tpu_torch/ops/heatmaps.py with nvcc into a shared library
// with a plain C interface, and called through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kTrunc = 4.6052f;
constexpr int kThreads = 256;  // heatmaps.THREADS

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
}

__global__ void __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ joints,
                       const float* __restrict__ vis,
                       float* __restrict__ main_out,
                       float* __restrict__ aux_out, int batch,
                       int num_joints, int grid_y, int grid_x, float stride,
                       float two_sig2, float cut_d2, int tile_pixels,
                       int num_tiles, int span, int tail_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int nc = num_joints + 1;
  const int tile_floats = tile_pixels * nc;
  // [main x2][aux x2][cx, cy, v: span*J each][xs, ys, batch row: P each]
  float* s_main = smem;
  float* s_aux = smem + 2 * tile_floats;
  float* s_cx = smem + 4 * tile_floats;
  float* s_cy = s_cx + span * num_joints;
  float* s_v = s_cy + span * num_joints;
  float* s_xs = s_v + span * num_joints;
  float* s_ys = s_xs + tile_pixels;
  int* s_row = reinterpret_cast<int*>(s_ys + tile_pixels);

  const int tid = threadIdx.x;
  const int hw = grid_y * grid_x;
  const int n_pix = batch * hw;  // < 2^31: checked by the wrapper
  const float start = __fsub_rn(__fmul_rn(stride, 0.5f), 0.5f);
  // This thread's first (pixel, joint) pair of a tile, and its step.
  const int p_first = tid / num_joints, j_first = tid % num_joints;
  const int dp = kThreads / num_joints, dj = kThreads % num_joints;

  int k = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++k) {
    const int p0 = tile * tile_pixels;
    const int n_here = min(tile_pixels, n_pix - p0);
    const int b0 = p0 / hw;
    const int n_rows = ((p0 + n_here - 1) / hw - b0 + 1) * num_joints;
    float* t_main = s_main + (k & 1) * tile_floats;
    float* t_aux = s_aux + (k & 1) * tile_floats;

    // 1. Joints and pixel centres. This buffer's copy from two tiles ago
    // must have read it before the barrier lets anyone write it.
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    }
    for (int i = tid; i < n_rows; i += kThreads) {
      const int g = b0 * num_joints + i;
      s_cx[i] = joints[2 * g];
      s_cy[i] = joints[2 * g + 1];
      s_v[i] = vis[g];
    }
    for (int p = tid; p < n_here; p += kThreads) {
      const int b = (p0 + p) / hw;
      const int r = p0 + p - b * hw;
      const int y = r / grid_x;
      const int x = r - y * grid_x;
      s_xs[p] = __fadd_rn(start, __fmul_rn(static_cast<float>(x), stride));
      s_ys[p] = __fadd_rn(start, __fmul_rn(static_cast<float>(y), stride));
      s_row[p] = (b - b0) * num_joints;
    }
    __syncthreads();

    // 2. The (pixel, joint) pairs: one division for both sigmas, and none
    // where d2 alone shows both exponents over the cut.
    for (int p = p_first, j = j_first; p < n_here;) {
      const int g = s_row[p] + j;
      const float dx = __fsub_rn(s_xs[p], s_cx[g]);
      const float dy = __fsub_rn(s_ys[p], s_cy[g]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      float m = 0.0f, a = 0.0f;
      if (!(d2 > cut_d2)) {  // NaN goes this way, as in the plain version
        const float expo = __fdiv_rn(d2, two_sig2);
        const float expo_aux = __fmul_rn(expo, 0.25f);
        if (!(expo > kTrunc)) m = expf(-expo);
        if (!(expo_aux > kTrunc)) a = expf(-expo_aux);
      }
      const float v = s_v[g];
      t_main[p * nc + j] = __fmul_rn(m, v);
      t_aux[p * nc + j] = __fmul_rn(a, v);
      p += dp;
      j += dj;
      if (j >= num_joints) {
        j -= num_joints;
        ++p;
      }
    }
    __syncthreads();

    // 3. Background channel, one thread per (pixel, output); the max is
    // exact in any order.
    for (int q = tid; q < 2 * n_here; q += kThreads) {
      float* row = q < n_here ? t_main + q * nc : t_aux + (q - n_here) * nc;
      float bg = row[0];
      for (int j = 1; j < num_joints; ++j) bg = fmaxf(bg, row[j]);
      row[num_joints] = __fsub_rn(1.0f, bg);
    }

    // 4. Store the tile.
    const int bytes = tile == num_tiles - 1 ? tail_bytes : tile_floats * 4;
    float* g_main = main_out + static_cast<long long>(p0) * nc;
    float* g_aux = aux_out + static_cast<long long>(p0) * nc;
    if (bytes % 16 == 0) {
      // The generic-proxy writes above must be visible to the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        bulk_store(g_main, t_main, bytes);
        bulk_store(g_aux, t_aux, bytes);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      __syncthreads();
      for (int i = tid; i < bytes / 4; i += kThreads) {
        g_main[i] = t_main[i];
        g_aux[i] = t_aux[i];
      }
    }
  }
  if (tid == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace

// joints (B, J, 2) f32, vis (B, J) f32 -> main, aux (B, gy, gx, J+1) f32,
// all contiguous on the device, both outputs 16-byte aligned, B*gy*gx
// < 2^31. two_sig2 is float(2 sigma^2) and cut_d2 heatmaps.cut_threshold
// of it. The tile size, tile count, joint-table rows, grid, shared-memory
// bytes and the last tile's bytes come from heatmaps.launch_geometry.
// Launches on `stream` and returns the cudaError_t (0 on success); it
// does not synchronise.
extern "C" int npp_render_heatmaps(const float* joints, const float* vis,
                                   float* main_out, float* aux_out,
                                   int batch, int num_joints, int grid_y,
                                   int grid_x, int stride, float two_sig2,
                                   float cut_d2, int tile_pixels,
                                   int num_tiles, int span, int grid,
                                   int smem_bytes, int tail_bytes,
                                   void* stream) {
  if (smem_bytes > 48 * 1024) {  // above 48 KB only by this opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        render_heatmaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  render_heatmaps_kernel<<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      joints, vis, main_out, aux_out, batch, num_joints, grid_y, grid_x,
      static_cast<float>(stride), two_sig2, cut_d2, tile_pixels, num_tiles,
      span, tail_bytes);
  return static_cast<int>(cudaGetLastError());
}
