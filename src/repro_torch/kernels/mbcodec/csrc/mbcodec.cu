// Macroblock codec kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// mbcodec_chunk_kernel<CLIP, QpSource>, the one kernel of this file,
// replaces the three TPU kernels of src/repro/kernels/mbcodec/kernel.py:
// with QpFromArray, mbcodec_chunk_pallas (body _chunk_kernel /
// _encode_tile_step) and, at T = 1, mbcodec_pallas (see mbcodec_frame
// below); with QpFromScores, mbcodec_chunk_scores_pallas (body
// _chunk_scores_kernel), stream-batched as the reference's jax.vmap over
// it. Per 16x16 block, a scan over the chunk's T frames of DCT(x - ref)
// -> quantize by qstep(qp) * w -> entropy bits -> dequantize -> IDCT ->
// ref += rec, with the frame-0 reference zero and, when CLIP, the
// reference clipped to [0, 1] each step. QpFromScores assigns the two-level QP inside the
// kernel from the stream's dilated AccModel scores and a knob triple
// (alpha, qp_hi, qp_lo) read from device memory, so no QP map exists in
// device memory and the host never reads the knobs.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores). A fleet chunk (8 streams, T=10, N=2880) reads 236 MB of
// blocks and writes 236 MB of rec: 0.141 ms of memory traffic. Its four
// 16x16x16 products per block and frame are 7.5 GFLOP, 0.113 ms at the
// fp32 rate (0.124 ms with the quantizer's elementwise work), so the
// operations sit at about 80-90% of the bytes: the kernel is bound by
// bytes, with little slack for anything but the FMAs themselves. A
// single-stream chunk is an eighth of both, one frame a tenth of that. The transforms stay on the
// CUDA cores in plain fp32: TF32 or bf16 products would round
// coefficients differently and flip quantized values, which changes bytes.
//
// Design of the chunk kernel. The TPU kernel carried the decoded reference
// in VMEM scratch along a sequential grid axis; CUDA thread blocks run in
// no order, so the T loop runs inside the thread block and the reference
// stays in registers for the whole chunk. The first CUDA version gave each
// 16x16 block a thread block of 256 threads, one per coefficient: every
// transform FMA then read both operands from shared memory (about 80
// shared-memory wavefronts per warp and frame against 64 FMAs) and each
// frame took 5 __syncthreads, with the frame's load issued only after the
// last of them. That kernel was bound by shared-memory traffic and
// barrier latency, at 6x its byte bound. This one:
// - Row per thread. 16 threads own one block, thread i its row i; a warp
//   holds 2 blocks (adjacent n), a thread block 4 warps, 8 blocks. Each
//   thread keeps its row of the source, of the carried reference and of
//   the accumulators in registers, indexed only at compile time.
// - D as an operand that costs no load. Every transform FMA has a
//   compile-time index into D, and D is compiled in (MBCODEC_DCT_16, the
//   exact float32 values of codec/dct.py, checked against the host's D at
//   each launch), so each FMA takes its D entry as an immediate. Passed
//   in the kernel's parameters instead, D cost 338 ULDC and 318 LDC a
//   frame beside the 1,024 FMAs: ptxas staged the constant bank through
//   registers rather than reading it as an operand. w comes in the
//   parameters (1 KB by value, so a captured CUDA graph holds it); each
//   thread loads its column of w once.
// - Half the FMAs through D's symmetry. D[k][15 - j] = (-1)^k D[k][j]
//   holds exactly in float32, so each 16-term sum of a pass is 8 terms on
//   pairwise sums or differences (forward16, inverse16): 576 FMAs and 64
//   adds a thread and frame in place of 1,024 FMAs. The values of D do not
//   change; the order of the sums does, as any other order would.
// - Two transposes per frame through a padded 16x20 shared tile per
//   block, under __syncwarp only: row pass Y = (x - ref) D^T; transpose;
//   column pass C = D Y; quantize down the column; column pass
//   W = D^T deq; transpose; row pass rec = W D; ref += rec. The tile's
//   row stride of 20 floats keeps the 16-byte row stores free of bank
//   conflicts, and the warp's second tile starts 16 banks on, so the
//   column reads are too. No block-wide barrier remains.
// - Frame t+1 in flight. Each thread's row of frame t+1 (64 contiguous
//   bytes, four 16-byte loads) is loaded into registers before frame t's
//   transforms; rec goes out as 16-byte stores.
// - A block's bits: each thread sums its column's 16 costs in order, then
//   a 16-lane butterfly (xor 8, 4, 2, 1) adds the columns and lane 0 of
//   the block writes the total plus the block header. No atomics, so two
//   calls give the same bits. ref.py::mbcodec_chunk_rowcol repeats this
//   association in plain PyTorch.
// - QP is read once per block and frame (QpFromArray) or once per block
//   (QpFromScores); both run one body, so the scores kernel gives the
//   explicit-array kernel's bits on the QP map its threshold implies.
//
// The frame entry point, mbcodec_frame, replaces a third TPU kernel,
// src/repro/kernels/mbcodec/kernel.py::mbcodec_pallas (body _kernel): one
// frame's block transform with no reference. It launches the chunk kernel
// <false, QpFromArray> at S = 1, T = 1, which is the same function
// exactly: with the reference zero, a = x - 0 is x bit for bit (-0 - 0
// stays -0), and the stored ref = 0 + rec is rec (0 + (-0) gives +0, which
// compares equal). So it equals mbcodec_chunk at T = 1 bit for bit, and
// keeps the chunk kernel's contract: D compiled in and checked, w in the
// launch parameters, rows read as 16-byte vectors, no atomics. At N = 2880
// a launch is 360 thread blocks of 128 threads, one wave at 5 an SM; with
// one frame there is no frame t+1 to load ahead, so the frame's load is
// exposed once. (The first CUDA version gave each block 256 threads, one
// per coefficient, with D and w staged in shared memory per block and 4
// __syncthreads a block.)
//
// Numerics follow the reference so that quantized values match: IEEE
// division c / step (no fast math), rintf (half to even), exp2f / log2f
// rather than the __exp2f / __log2f intrinsics, qstep exactly
// 0.625f * exp2f((qp - 4) / 6) / 255, D and w the float32 values the host
// builds (codec/dct.py), and nothing allocated in a kernel.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int MB = 16;
constexpr int NT = MB * MB;  // coefficients of a block
constexpr float BITS_PER_MAG = 1.7f;
constexpr float RUN_BITS = 0.9f;
constexpr float BLOCK_OVERHEAD = 10.0f;

__device__ __forceinline__ float qstep_of(float qp) {
  return 0.625f * exp2f((qp - 4.0f) / 6.0f) / 255.0f;
}

// Per-block QP read from an explicit (S, T, N) array, once per frame.
struct QpFromArray {
  static constexpr bool kPerFrame = true;
  const float* qp;
  __device__ float operator()(int s, int t, int n, int T, int N) const {
    return qp[(static_cast<size_t>(s) * T + t) * N + n];
  }
};

// Per-block QP from stream s's pooled (dilated) score of macroblock n / C:
// knobs[1] (qp_hi) where it reaches knobs[0] (alpha), else knobs[2]. The
// >= matches the reference: max-pooling commutes with a monotone
// threshold, so dilate_scores(s) >= alpha is dilate(s >= alpha). The same
// for every frame of the chunk.
struct QpFromScores {
  static constexpr bool kPerFrame = false;
  const float* pooled;  // (S, n_mb)
  const float* knobs;   // (3,): alpha, qp_hi, qp_lo
  int n_mb, C;
  __device__ float operator()(int s, int, int n, int, int) const {
    const float score = pooled[static_cast<size_t>(s) * n_mb + n / C];
    return score >= knobs[0] ? knobs[1] : knobs[2];
  }
};

// ---------------------------------------------------------------------------
// The chunk kernel: 16 threads per block, thread i owns row i.
// ---------------------------------------------------------------------------
constexpr int CHUNK_WARPS = 4;
constexpr int CHUNK_THREADS = 32 * CHUNK_WARPS;
constexpr int CHUNK_BLOCKS = CHUNK_THREADS / MB;  // blocks per thread block
constexpr int TILE_LD = 20;  // tile row stride, floats: 16-byte rows, no
                             // bank conflict among 8 row stores
// floats per block's tile; the 16 past 16 rows put the warp's second tile
// on the other 16 banks for the column reads
constexpr int TILE = MB * TILE_LD + MB;

// The orthonormal 16x16 DCT-II matrix D, D[k][j] at k * 16 + j: the
// float32 values of codec/dct.py::dct_matrix(), written out exactly as hex
// floats. The host side of a launch compares them with the D it is handed
// (launch_chunk), and tests/test_torch_mbcodec.py with dct_matrix().
#define MBCODEC_DCT_16 \
  { \
  0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,                                 \
  0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,                                 \
  0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,                                 \
  0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,                                 \
  0x1.684b9cp-2f, 0x1.5a730cp-2f, 0x1.3f4a24p-2f, 0x1.17dc14p-2f,     \
  0x1.cb598cp-3f, 0x1.5553e4p-3f, 0x1.a4608ap-4f, 0x1.1be352p-5f,     \
  -0x1.1be352p-5f, -0x1.a4608ap-4f, -0x1.5553e4p-3f, -0x1.cb598cp-3f, \
  -0x1.17dc14p-2f, -0x1.3f4a24p-2f, -0x1.5a730cp-2f, -0x1.684b9cp-2f, \
  0x1.63150cp-2f, 0x1.2d062ep-2f, 0x1.92469cp-3f, 0x1.1a855ep-4f,     \
  -0x1.1a855ep-4f, -0x1.92469cp-3f, -0x1.2d062ep-2f, -0x1.63150cp-2f, \
  -0x1.63150cp-2f, -0x1.2d062ep-2f, -0x1.92469cp-3f, -0x1.1a855ep-4f, \
  0x1.1a855ep-4f, 0x1.92469cp-3f, 0x1.2d062ep-2f, 0x1.63150cp-2f,     \
  0x1.5a730cp-2f, 0x1.cb598cp-3f, 0x1.1be352p-5f, -0x1.5553e4p-3f,    \
  -0x1.3f4a24p-2f, -0x1.684b9cp-2f, -0x1.17dc14p-2f, -0x1.a4608ap-4f, \
  0x1.a4608ap-4f, 0x1.17dc14p-2f, 0x1.684b9cp-2f, 0x1.3f4a24p-2f,     \
  0x1.5553e4p-3f, -0x1.1be352p-5f, -0x1.cb598cp-3f, -0x1.5a730cp-2f,  \
  0x1.4e7aeap-2f, 0x1.1517a8p-3f, -0x1.1517a8p-3f, -0x1.4e7aeap-2f,   \
  -0x1.4e7aeap-2f, -0x1.1517a8p-3f, 0x1.1517a8p-3f, 0x1.4e7aeap-2f,   \
  0x1.4e7aeap-2f, 0x1.1517a8p-3f, -0x1.1517a8p-3f, -0x1.4e7aeap-2f,   \
  -0x1.4e7aeap-2f, -0x1.1517a8p-3f, 0x1.1517a8p-3f, 0x1.4e7aeap-2f,   \
  0x1.3f4a24p-2f, 0x1.1be352p-5f, -0x1.17dc14p-2f, -0x1.5a730cp-2f,   \
  -0x1.a4608ap-4f, 0x1.cb598cp-3f, 0x1.684b9cp-2f, 0x1.5553e4p-3f,    \
  -0x1.5553e4p-3f, -0x1.684b9cp-2f, -0x1.cb598cp-3f, 0x1.a4608ap-4f,  \
  0x1.5a730cp-2f, 0x1.17dc14p-2f, -0x1.1be352p-5f, -0x1.3f4a24p-2f,   \
  0x1.2d062ep-2f, -0x1.1a855ep-4f, -0x1.63150cp-2f, -0x1.92469cp-3f,  \
  0x1.92469cp-3f, 0x1.63150cp-2f, 0x1.1a855ep-4f, -0x1.2d062ep-2f,    \
  -0x1.2d062ep-2f, 0x1.1a855ep-4f, 0x1.63150cp-2f, 0x1.92469cp-3f,    \
  -0x1.92469cp-3f, -0x1.63150cp-2f, -0x1.1a855ep-4f, 0x1.2d062ep-2f,  \
  0x1.17dc14p-2f, -0x1.5553e4p-3f, -0x1.5a730cp-2f, 0x1.1be352p-5f,   \
  0x1.684b9cp-2f, 0x1.a4608ap-4f, -0x1.3f4a24p-2f, -0x1.cb598cp-3f,   \
  0x1.cb598cp-3f, 0x1.3f4a24p-2f, -0x1.a4608ap-4f, -0x1.684b9cp-2f,   \
  -0x1.1be352p-5f, 0x1.5a730cp-2f, 0x1.5553e4p-3f, -0x1.17dc14p-2f,   \
  0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,                               \
  0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,                               \
  0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,                               \
  0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,                               \
  0x1.cb598cp-3f, -0x1.3f4a24p-2f, -0x1.a4608ap-4f, 0x1.684b9cp-2f,   \
  -0x1.1be352p-5f, -0x1.5a730cp-2f, 0x1.5553e4p-3f, 0x1.17dc14p-2f,   \
  -0x1.17dc14p-2f, -0x1.5553e4p-3f, 0x1.5a730cp-2f, 0x1.1be352p-5f,   \
  -0x1.684b9cp-2f, 0x1.a4608ap-4f, 0x1.3f4a24p-2f, -0x1.cb598cp-3f,   \
  0x1.92469cp-3f, -0x1.63150cp-2f, 0x1.1a855ep-4f, 0x1.2d062ep-2f,    \
  -0x1.2d062ep-2f, -0x1.1a855ep-4f, 0x1.63150cp-2f, -0x1.92469cp-3f,  \
  -0x1.92469cp-3f, 0x1.63150cp-2f, -0x1.1a855ep-4f, -0x1.2d062ep-2f,  \
  0x1.2d062ep-2f, 0x1.1a855ep-4f, -0x1.63150cp-2f, 0x1.92469cp-3f,    \
  0x1.5553e4p-3f, -0x1.684b9cp-2f, 0x1.cb598cp-3f, 0x1.a4608ap-4f,    \
  -0x1.5a730cp-2f, 0x1.17dc14p-2f, 0x1.1be352p-5f, -0x1.3f4a24p-2f,   \
  0x1.3f4a24p-2f, -0x1.1be352p-5f, -0x1.17dc14p-2f, 0x1.5a730cp-2f,   \
  -0x1.a4608ap-4f, -0x1.cb598cp-3f, 0x1.684b9cp-2f, -0x1.5553e4p-3f,  \
  0x1.1517a8p-3f, -0x1.4e7aeap-2f, 0x1.4e7aeap-2f, -0x1.1517a8p-3f,   \
  -0x1.1517a8p-3f, 0x1.4e7aeap-2f, -0x1.4e7aeap-2f, 0x1.1517a8p-3f,   \
  0x1.1517a8p-3f, -0x1.4e7aeap-2f, 0x1.4e7aeap-2f, -0x1.1517a8p-3f,   \
  -0x1.1517a8p-3f, 0x1.4e7aeap-2f, -0x1.4e7aeap-2f, 0x1.1517a8p-3f,   \
  0x1.a4608ap-4f, -0x1.17dc14p-2f, 0x1.684b9cp-2f, -0x1.3f4a24p-2f,   \
  0x1.5553e4p-3f, 0x1.1be352p-5f, -0x1.cb598cp-3f, 0x1.5a730cp-2f,    \
  -0x1.5a730cp-2f, 0x1.cb598cp-3f, -0x1.1be352p-5f, -0x1.5553e4p-3f,  \
  0x1.3f4a24p-2f, -0x1.684b9cp-2f, 0x1.17dc14p-2f, -0x1.a4608ap-4f,   \
  0x1.1a855ep-4f, -0x1.92469cp-3f, 0x1.2d062ep-2f, -0x1.63150cp-2f,   \
  0x1.63150cp-2f, -0x1.2d062ep-2f, 0x1.92469cp-3f, -0x1.1a855ep-4f,   \
  -0x1.1a855ep-4f, 0x1.92469cp-3f, -0x1.2d062ep-2f, 0x1.63150cp-2f,   \
  -0x1.63150cp-2f, 0x1.2d062ep-2f, -0x1.92469cp-3f, 0x1.1a855ep-4f,   \
  0x1.1be352p-5f, -0x1.a4608ap-4f, 0x1.5553e4p-3f, -0x1.cb598cp-3f,   \
  0x1.17dc14p-2f, -0x1.3f4a24p-2f, 0x1.5a730cp-2f, -0x1.684b9cp-2f,   \
  0x1.684b9cp-2f, -0x1.5a730cp-2f, 0x1.3f4a24p-2f, -0x1.17dc14p-2f,   \
  0x1.cb598cp-3f, -0x1.5553e4p-3f, 0x1.a4608ap-4f, -0x1.1be352p-5f,   \
  }

constexpr float kDctHost[NT] = MBCODEC_DCT_16;

// D[idx] for a compile-time idx: the loads from this local constant table
// fold away, so each transform FMA takes D as an immediate operand.
__device__ __forceinline__ float dct(int idx) {
  constexpr float table[NT] = MBCODEC_DCT_16;
  return table[idx];
}

// w by value: a kernel parameter, so a captured CUDA graph holds it.
struct Consts {
  float w[NT];  // w[k][j] at k * 16 + j
};

// Bits of one quantized magnitude |q|, the reference's cost model, with
// the product and the sum rounded apart (no contraction into an FMA).
__device__ __forceinline__ float bit_cost(float aq) {
  return __fadd_rn(__fmul_rn(BITS_PER_MAG, log2f(1.0f + aq)),
                   aq > 0.5f ? RUN_BITS : 0.0f);
}

__device__ __forceinline__ void load_row(const float* p, float (&x)[MB]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < MB / 4; ++q) {
    const float4 f = __ldg(v + q);
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&x)[MB]) {
  float4* v = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int q = 0; q < MB / 4; ++q)
    v[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// The 16-point transforms through D's symmetry, which holds exactly in
// float32: D[k][15 - j] = (-1)^k D[k][j]. Each output is an 8-term sum
// (a product, then 7 FMAs in order), so a pass takes 128 FMAs and 16
// adds in place of 256 FMAs. ref.py::mbcodec_chunk_rowcol repeats the
// same sums.
//
// forward16: y[k] = sum_j x[j] D[k][j], as sum_{j<8} D[k][j] h[j] with
// h = x[j] + x[15 - j] for even k and x[j] - x[15 - j] for odd k.
__device__ __forceinline__ void forward16(const float (&x)[MB],
                                          float (&y)[MB]) {
  float u[MB / 2], v[MB / 2];
#pragma unroll
  for (int j = 0; j < MB / 2; ++j) {
    u[j] = x[j] + x[MB - 1 - j];
    v[j] = x[j] - x[MB - 1 - j];
  }
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    float s = (k & 1 ? v[0] : u[0]) * dct(k * MB);
#pragma unroll
    for (int j = 1; j < MB / 2; ++j)
      s = fmaf(k & 1 ? v[j] : u[j], dct(k * MB + j), s);
    y[k] = s;
  }
}

// inverse16: x[m] = sum_k y[k] D[k][m]: e = the even k's terms and o = the
// odd k's, each in order of k; x[m] = e + o and x[15 - m] = e - o.
__device__ __forceinline__ void inverse16(const float (&y)[MB],
                                          float (&x)[MB]) {
#pragma unroll
  for (int m = 0; m < MB / 2; ++m) {
    float e = y[0] * dct(m), o = y[1] * dct(MB + m);
#pragma unroll
    for (int k = 2; k < MB; k += 2) {
      e = fmaf(y[k], dct(k * MB + m), e);
      o = fmaf(y[k + 1], dct((k + 1) * MB + m), o);
    }
    x[m] = e + o;
    x[MB - 1 - m] = e - o;
  }
}

// Thread i's vector x goes out as row i of its block's tile; it comes back
// with column i of the tile, i.e. the transposed vector of the block.
__device__ __forceinline__ void transpose(float* tile, int i,
                                          const float (&x)[MB],
                                          float (&y)[MB]) {
  __syncwarp();  // the tile's previous readers are done
  store_row(tile + i * TILE_LD, x);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MB; ++j) y[j] = tile[j * TILE_LD + i];
}

template <bool CLIP, class QpSource>
__global__ void __launch_bounds__(CHUNK_THREADS)
mbcodec_chunk_kernel(const float* __restrict__ blocks, QpSource qps,
                     const __grid_constant__ Consts c,
                     float* __restrict__ rec_out, float* __restrict__ bits_out,
                     float* __restrict__ q_out, int T, int N) {
  __shared__ __align__(16) float tiles[CHUNK_BLOCKS * TILE];
  const int i = threadIdx.x % MB;     // the row (then column) it owns
  const int slot = threadIdx.x / MB;  // its block within the thread block
  const int stream = blockIdx.y;
  const int n_own = blockIdx.x * CHUNK_BLOCKS + slot;
  const bool valid = n_own < N;
  // a slot past N recomputes block N - 1 and stores nothing, so all 32
  // lanes of every warp reach each __syncwarp and shuffle
  const int n = valid ? n_own : N - 1;
  float* tile = tiles + slot * TILE;

  float w[MB];  // column i of w
#pragma unroll
  for (int k = 0; k < MB; ++k) w[k] = c.w[k * MB + i];

  const size_t frame = static_cast<size_t>(N) * NT;  // floats per frame
  const size_t first = (static_cast<size_t>(stream) * T * N + n) * NT;
  float x[MB];  // this frame's row; then frame t+1's, in flight
  load_row(blocks + first + i * MB, x);
  float qp = qps(stream, 0, n, T, N);
  float qstep = qstep_of(qp);
  float ref[MB];
#pragma unroll
  for (int j = 0; j < MB; ++j) ref[j] = 0.0f;  // I-frame: zero reference

  for (int t = 0; t < T; ++t) {
    const size_t blk = (static_cast<size_t>(stream) * T + t) * N + n;
    float a[MB];
#pragma unroll
    for (int j = 0; j < MB; ++j) a[j] = x[j] - ref[j];
    if (t + 1 < T) {
      load_row(blocks + first + (t + 1) * frame + i * MB, x);
      if (QpSource::kPerFrame) qp = qps(stream, t + 1, n, T, N);
    }

    // row pass: y[k] = (A D^T)[i][k] = sum_j A[i][j] D[k][j]
    float y[MB];
    forward16(a, y);
    float yc[MB];  // column i of Y
    transpose(tile, i, y, yc);

    // column pass: coefficient (k, i) = sum_j D[k][j] Y[j][i]; quantize
    float coef[MB];
    forward16(yc, coef);
    float deq[MB];
    float bit_sum = 0.0f;
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      const float step = qstep * w[k];
      const float qv = rintf(coef[k] / step);
      bit_sum += bit_cost(fabsf(qv));
      deq[k] = qv * step;
      if (q_out != nullptr && valid) q_out[blk * NT + k * MB + i] = qv;
    }
#pragma unroll
    for (int off = MB / 2; off > 0; off >>= 1)
      bit_sum += __shfl_xor_sync(0xffffffffu, bit_sum, off);
    if (i == 0 && valid) bits_out[blk] = bit_sum + BLOCK_OVERHEAD;

    // inverse column pass: W[m][i] = sum_k D[k][m] deq[k][i]
    float wc[MB];
    inverse16(deq, wc);
    float wr[MB];  // row i of W
    transpose(tile, i, wc, wr);

    // inverse row pass: rec[i][j] = sum_m W[i][m] D[m][j]; ref += rec
    float rec[MB];
    inverse16(wr, rec);
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      float r = ref[j] + rec[j];
      if (CLIP) r = fminf(fmaxf(r, 0.0f), 1.0f);
      ref[j] = r;
    }
    if (valid) store_row(rec_out + blk * NT + i * MB, ref);
    if (QpSource::kPerFrame && t + 1 < T) qstep = qstep_of(qp);
  }
}

constexpr int kDctMismatch = -1;  // the host's D is not the compiled D

template <class QpSource>
int launch_chunk(const float* blocks, QpSource qps, const float* d_host,
                 const float* w_host, float* rec, float* bits, float* q,
                 int S, int T, int N, int clip, void* stream) {
  if (std::memcmp(d_host, kDctHost, sizeof(kDctHost)) != 0)
    return kDctMismatch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts c;
  std::memcpy(c.w, w_host, sizeof(c.w));
  const dim3 grid((N + CHUNK_BLOCKS - 1) / CHUNK_BLOCKS, S);
  if (clip)
    mbcodec_chunk_kernel<true, QpSource>
        <<<grid, CHUNK_THREADS, 0, st>>>(blocks, qps, c, rec, bits, q, T, N);
  else
    mbcodec_chunk_kernel<false, QpSource>
        <<<grid, CHUNK_THREADS, 0, st>>>(blocks, qps, c, rec, bits, q, T, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (T, N, 16, 16), qp (T, N) on the device; d / w (16, 16) in HOST
// memory, copied into the launch's parameters -> rec (T, N, 16, 16), bits
// (T, N), and q (T, N, 16, 16) when q is not null. All float32 and
// contiguous; blocks, rec and q start on a 16-byte boundary. Returns
// cudaGetLastError().
extern "C" int mbcodec_chunk(const float* blocks, const float* qp,
                             const float* d_host, const float* w_host,
                             float* rec, float* bits, float* q, int T, int N,
                             int clip, void* stream) {
  return launch_chunk(blocks, QpFromArray{qp}, d_host, w_host, rec, bits, q,
                      1, T, N, clip, stream);
}

// blocks (S, T, N, 16, 16), pooled (S, n_mb) with N = n_mb * C, knobs (3,)
// on the device; d / w (16, 16) in host memory -> rec (S, T, N, 16, 16),
// bits (S, T, N), and q (S, T, N, 16, 16) when q is not null. One launch
// of ceil(N / 8) x S thread blocks.
extern "C" int mbcodec_chunk_scores(const float* blocks, const float* pooled,
                                    const float* knobs, const float* d_host,
                                    const float* w_host, float* rec,
                                    float* bits, float* q, int S, int T,
                                    int N, int n_mb, int C, int clip,
                                    void* stream) {
  return launch_chunk(blocks, QpFromScores{pooled, knobs, n_mb, C}, d_host,
                      w_host, rec, bits, q, S, T, N, clip, stream);
}

// blocks (N, 16, 16), qp (N,) on the device; d / w (16, 16) in host memory
// -> rec (N, 16, 16), bits (N,), and q (N, 16, 16) when q is not null: the
// chunk kernel at T = 1 with no clip, so mbcodec_chunk at T = 1 bit for bit.
extern "C" int mbcodec_frame(const float* blocks, const float* qp,
                             const float* d_host, const float* w_host,
                             float* rec, float* bits, float* q, int N,
                             void* stream) {
  return launch_chunk(blocks, QpFromArray{qp}, d_host, w_host, rec, bits, q,
                      1, 1, N, 0, stream);
}
