// Macroblock codec kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// mbcodec_chunk_kernel<CLIP, QpSource> replaces two TPU kernels of
// src/repro/kernels/mbcodec/kernel.py: with QpFromArray,
// mbcodec_chunk_pallas (body _chunk_kernel / _encode_tile_step); with
// QpFromScores, mbcodec_chunk_scores_pallas (body _chunk_scores_kernel),
// stream-batched as the reference's jax.vmap over it. Per 16x16 block, a
// scan over the chunk's T frames of DCT(x - ref) -> quantize by
// qstep(qp) * w -> entropy bits -> dequantize -> IDCT -> ref += rec, with
// the frame-0 reference zero and, when CLIP, the reference clipped to
// [0, 1] each step. QpFromScores assigns the two-level QP inside the
// kernel from the stream's dilated AccModel scores and a knob triple
// (alpha, qp_hi, qp_lo) read from device memory, so no QP map exists in
// device memory and the host never reads the knobs.
// mbcodec_frame_kernel replaces
//   src/repro/kernels/mbcodec/kernel.py::mbcodec_pallas (body _kernel):
//   the same block transform for one frame with no reference.
//
// Design. The TPU kernel carried the decoded reference in VMEM scratch
// along a sequential grid axis; CUDA thread blocks run in no order, so the
// T loop runs inside the thread block instead and the reference stays in a
// register for the whole chunk. One thread block of 256 threads owns one
// (macroblock, channel) block of one stream: thread (r, c) holds pixel /
// coefficient (r, c); grid.x walks the blocks and grid.y the streams. A
// single stream's 24 x 40 x 3 = 2880 blocks fill the 132 SMs (the TPU's
// 64-block tiles would give 45 programs), an 8-stream fleet chunk is one
// launch of 23,040 thread blocks, and since each thread block owns a whole
// block there is no ragged tile to pad or mask. D, D^T and w are staged in
// shared memory once per thread block; D X D^T and its inverse are two
// 16-term fp32 dot products per thread through two shared buffers laid
// out so that a warp reads either one broadcast word or 16 consecutive
// words (no bank conflicts). Block bits are summed with warp shuffles,
// then across the 8 warps in shared memory.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores). One single-stream chunk call (T=10, N=2880) reads and
// writes 10 * 2880 * 256 * 4 B = 29.5 MB each way: ~17.6 us of memory
// traffic. Its transforms are 10 * 2880 * 32,768 = 0.94 GFLOP: ~14 us. The
// call is near balance, slightly memory-bound; an 8-stream fleet chunk is
// eight times both. This first version is simple: each frame's load is
// exposed (no cp.async/TMA prefetch of frame t+1), one block per thread
// block, CUDA-core FMAs rather than mma for the transforms.
//
// Numerics follow the reference so that quantized values match: IEEE
// division c / step (no fast math), rintf (half to even), exp2f / log2f
// rather than the __exp2f / __log2f intrinsics, and D and w passed in from
// the host exactly as the TPU kernel receives them.

#include <cuda_runtime.h>

namespace {

constexpr int MB = 16;
constexpr int NT = MB * MB;  // threads per thread block, one per coefficient
constexpr float BITS_PER_MAG = 1.7f;
constexpr float RUN_BITS = 0.9f;
constexpr float BLOCK_OVERHEAD = 10.0f;

// Per-block QP read from an explicit (S, T, N) array.
struct QpFromArray {
  const float* qp;
  __device__ float operator()(int s, int t, int n, int T, int N) const {
    return qp[(static_cast<size_t>(s) * T + t) * N + n];
  }
};

// Per-block QP from stream s's pooled (dilated) score of macroblock n / C:
// knobs[1] (qp_hi) where it reaches knobs[0] (alpha), else knobs[2]. The
// >= matches the reference: max-pooling commutes with a monotone
// threshold, so dilate_scores(s) >= alpha is dilate(s >= alpha).
struct QpFromScores {
  const float* pooled;  // (S, n_mb)
  const float* knobs;   // (3,): alpha, qp_hi, qp_lo
  int n_mb, C;
  __device__ float operator()(int s, int, int n, int, int) const {
    const float score = pooled[static_cast<size_t>(s) * n_mb + n / C];
    return score >= knobs[0] ? knobs[1] : knobs[2];
  }
};

struct Smem {
  float d[NT];   // D[r][k] at r * 16 + k
  float dt[NT];  // D[k][r] at r * 16 + k
  float w[NT];
  float a[NT];
  float b[NT];
  float warp_bits[NT / 32];
};

__device__ __forceinline__ void stage_constants(Smem& s, const float* d,
                                                const float* w, int r,
                                                int c) {
  const int tid = r * MB + c;
  s.d[tid] = d[tid];
  s.dt[tid] = d[c * MB + r];
  s.w[tid] = w[tid];
}

// One 16x16 block through transform, quantizer and inverse. Thread (r, c)
// passes src[r][c] and gets back the residual reconstruction at (r, c) and
// its quantized coefficient in *q. Thread 0 also gets the block's bits.
// Contains the __syncthreads that make stage_constants visible.
__device__ __forceinline__ float encode_block(float src, float qp, Smem& s,
                                              int r, int c, float* q,
                                              float* bits) {
  const int tid = r * MB + c;
  s.a[tid] = src;
  __syncthreads();
  float y = 0.0f;  // (X D^T)[r][c]
#pragma unroll
  for (int k = 0; k < MB; ++k) y += s.a[r * MB + k] * s.dt[k * MB + c];
  s.b[tid] = y;
  __syncthreads();
  float coef = 0.0f;  // (D X D^T)[r][c]
#pragma unroll
  for (int j = 0; j < MB; ++j) coef += s.d[r * MB + j] * s.b[j * MB + c];

  const float qstep = 0.625f * exp2f((qp - 4.0f) / 6.0f) / 255.0f;
  const float step = qstep * s.w[tid];
  const float qv = rintf(coef / step);
  const float aq = fabsf(qv);
  float bit = BITS_PER_MAG * log2f(1.0f + aq) + (aq > 0.5f ? RUN_BITS : 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bit += __shfl_down_sync(0xffffffffu, bit, off);
  if ((tid & 31) == 0) s.warp_bits[tid >> 5] = bit;
  s.a[tid] = qv * step;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) total += s.warp_bits[i];
    *bits = total + BLOCK_OVERHEAD;
  }
  float z = 0.0f;  // (deq D)[r][c]
#pragma unroll
  for (int k = 0; k < MB; ++k) z += s.a[r * MB + k] * s.d[k * MB + c];
  s.b[tid] = z;
  __syncthreads();
  float rec = 0.0f;  // (D^T deq D)[r][c]
#pragma unroll
  for (int j = 0; j < MB; ++j) rec += s.dt[r * MB + j] * s.b[j * MB + c];
  *q = qv;
  return rec;
}

template <bool CLIP, class QpSource>
__global__ void __launch_bounds__(NT)
mbcodec_chunk_kernel(const float* __restrict__ blocks, QpSource qps,
                     const float* __restrict__ d, const float* __restrict__ w,
                     float* __restrict__ rec_out, float* __restrict__ bits_out,
                     float* __restrict__ q_out, int T, int N) {
  __shared__ Smem s;
  const int n = blockIdx.x, stream = blockIdx.y;
  const int r = threadIdx.x / MB, c = threadIdx.x % MB;
  stage_constants(s, d, w, r, c);
  float ref = 0.0f;  // chunk head: I-frame against a zero reference
  for (int t = 0; t < T; ++t) {
    const size_t blk = (static_cast<size_t>(stream) * T + t) * N + n;
    const size_t off = blk * NT + threadIdx.x;
    float q = 0.0f, bits = 0.0f;
    const float resid = encode_block(blocks[off] - ref,
                                     qps(stream, t, n, T, N), s, r, c, &q,
                                     &bits);
    ref = ref + resid;
    if (CLIP) ref = fminf(fmaxf(ref, 0.0f), 1.0f);
    rec_out[off] = ref;
    if (q_out != nullptr) q_out[off] = q;
    if (threadIdx.x == 0) bits_out[blk] = bits;
  }
}

__global__ void __launch_bounds__(NT)
mbcodec_frame_kernel(const float* __restrict__ blocks,
                     const float* __restrict__ qp,
                     const float* __restrict__ d, const float* __restrict__ w,
                     float* __restrict__ rec_out, float* __restrict__ bits_out,
                     float* __restrict__ q_out, int N) {
  __shared__ Smem s;
  const int n = blockIdx.x;
  const int r = threadIdx.x / MB, c = threadIdx.x % MB;
  stage_constants(s, d, w, r, c);
  const size_t off = static_cast<size_t>(n) * NT + threadIdx.x;
  float q = 0.0f, bits = 0.0f;
  rec_out[off] = encode_block(blocks[off], qp[n], s, r, c, &q, &bits);
  if (q_out != nullptr) q_out[off] = q;
  if (threadIdx.x == 0) bits_out[n] = bits;
}

template <class QpSource>
int launch_chunk(const float* blocks, QpSource qps, const float* d,
                 const float* w, float* rec, float* bits, float* q, int S,
                 int T, int N, int clip, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, S);
  if (clip)
    mbcodec_chunk_kernel<true, QpSource>
        <<<grid, NT, 0, st>>>(blocks, qps, d, w, rec, bits, q, T, N);
  else
    mbcodec_chunk_kernel<false, QpSource>
        <<<grid, NT, 0, st>>>(blocks, qps, d, w, rec, bits, q, T, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (T, N, 16, 16), qp (T, N), d / w (16, 16) -> rec (T, N, 16, 16),
// bits (T, N), and q (T, N, 16, 16) when q is not null. All float32,
// contiguous, on the device of `stream`. Returns cudaGetLastError().
extern "C" int mbcodec_chunk(const float* blocks, const float* qp,
                             const float* d, const float* w, float* rec,
                             float* bits, float* q, int T, int N, int clip,
                             void* stream) {
  return launch_chunk(blocks, QpFromArray{qp}, d, w, rec, bits, q, 1, T, N,
                      clip, stream);
}

// blocks (S, T, N, 16, 16), pooled (S, n_mb) with N = n_mb * C, knobs (3,),
// d / w (16, 16) -> rec (S, T, N, 16, 16), bits (S, T, N), and q (S, T, N,
// 16, 16) when q is not null. One launch of N x S thread blocks.
extern "C" int mbcodec_chunk_scores(const float* blocks, const float* pooled,
                                    const float* knobs, const float* d,
                                    const float* w, float* rec, float* bits,
                                    float* q, int S, int T, int N, int n_mb,
                                    int C, int clip, void* stream) {
  return launch_chunk(blocks, QpFromScores{pooled, knobs, n_mb, C}, d, w,
                      rec, bits, q, S, T, N, clip, stream);
}

// blocks (N, 16, 16), qp (N,) -> rec (N, 16, 16), bits (N,), q optional.
extern "C" int mbcodec_frame(const float* blocks, const float* qp,
                             const float* d, const float* w, float* rec,
                             float* bits, float* q, int N, void* stream) {
  mbcodec_frame_kernel<<<N, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, qp, d, w, rec, bits, q, N);
  return static_cast<int>(cudaGetLastError());
}
