// AccGrad reduction kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// accgrad_reduce_kernel replaces
//   src/repro/kernels/accgrad_reduce/kernel.py::accgrad_reduce_pallas
//   (body _kernel): per 16x16 macroblock, the sum over its pixels of
//   (sum_c |g|) * (sum_c |H - L|), where g is the gradient of the final
//   DNN's accuracy proxy at the low-quality frame L and H the high-quality
//   frame (AccGrad, the paper's Eq. 1, before its per-frame normalisation).
//
// Design. The TPU kernel walked one macroblock row per grid step, a whole
// (16, W, C) tile in VMEM, one frame per call. Here one thread block of
// 256 threads owns one macroblock of one frame, thread (r, c) owns pixel
// (r, c) of it, grid.x walks the macroblocks and grid.y the frames, so a
// batch of B frames is one launch and the (H, W) per-pixel product never
// reaches device memory. Each thread sums |g| and |H - L| over the C
// channels in fp32 and multiplies the two; the 256 products are summed
// with warp shuffles, then the 8 warp partials in shared memory, and one
// thread writes the macroblock's sum.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s). At the label batch (B=4,
// 384x640x3) the three inputs are 11.8 MB each, read once, and 3.8 KB is
// written: 35.4 MB, ~10.6 us. The arithmetic is ~4 operations per input
// element (abs, subtract, abs, two adds), so the kernel is bound by bytes.
// This first version is simple: a warp reads two 16-pixel rows (2 x 192 B
// for RGB) with scalar 4-byte loads, and a thread block covers one
// macroblock.
//
// Numerics: plain fp32, no fast math; the result differs from the plain
// version only in the order of the sums.

#include <cuda_runtime.h>

namespace {

constexpr int MB = 16;
constexpr int NT = MB * MB;  // threads per thread block, one per pixel
constexpr int WARPS = NT / 32;

// g, hq, lq (B, H, W, C) -> out (B, H/16, W/16).
__global__ void __launch_bounds__(NT)
accgrad_reduce_kernel(const float* __restrict__ g,
                      const float* __restrict__ hq,
                      const float* __restrict__ lq, float* __restrict__ out,
                      int H, int W, int C) {
  __shared__ float partial[WARPS];
  const int mb_w = W / MB;
  const int my = blockIdx.x / mb_w, mx = blockIdx.x % mb_w;
  const int r = threadIdx.x / MB, c = threadIdx.x % MB;
  const long long pix = (static_cast<long long>(blockIdx.y) * H
                         + my * MB + r) * W + mx * MB + c;
  const long long base = pix * C;
  float sum_g = 0.0f, sum_d = 0.0f;
  for (int ch = 0; ch < C; ++ch) {
    sum_g += fabsf(g[base + ch]);
    sum_d += fabsf(hq[base + ch] - lq[base + ch]);
  }
  float v = sum_g * sum_d;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? partial[lane] : 0.0f;
    for (int off = WARPS / 2; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0)
      out[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = v;
  }
}

}  // namespace

// g, hq, lq (B, H, W, C) f32 with H % 16 == W % 16 == 0 -> out (B, H/16,
// W/16). One launch of (H/16 * W/16) x B thread blocks.
extern "C" int accgrad_reduce(const float* g, const float* hq,
                              const float* lq, float* out, int B, int H,
                              int W, int C, void* stream) {
  const dim3 grid((H / MB) * (W / MB), B);
  accgrad_reduce_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      g, hq, lq, out, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
