// Flash-decoding attention for Hopper (sm_90a), plain C interface for ctypes.
//
// decode_attn_kernel replaces
//   src/repro/kernels/decode_attn/kernel.py:59 decode_attn_pallas
//   (body _kernel): one query token per sequence, in GQA layout q (B, KV,
//   G, hd), against the KV cache k, v (B, S, KV, hd); positions after pos
//   are masked; the output (B, KV, G, hd) is fp32. Like the TPU kernel's
//   (1,) int32 array, pos may be read from device memory. The cache is q's
//   type (bf16 or fp32), or the int8 form of the reference's
//   kv_cache_dtype="int8" (src/repro/models/layers.py:164-194): int8
//   values (B, S, KV, hd) and an fp32 scale per position (B, S, KV, 1),
//   read as cache_read(c, T) = T(float(q) * s), T being q's type.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 67 TFLOP/s fp32): bytes.
// Each valid K and V row is read once and serves G query heads, about 6 G
// operations per 4 hd bytes of bf16 cache, far below the ~20 operations
// per byte where fp32 arithmetic would limit. On the smollm decode path
// (B=16, KV=5, hd=64, pos=1087, bf16) that is 22.3 MB of valid K/V, 6.65
// us; at the decode_32k shape (B=128, S=32768) 5.37 GB, 1.60 ms. On
// stablelm-3b's (B=16, KV=32, G=1, hd=80, pos=1087) int8 cache, 84 bytes
// a row with its scale: 93.6 MB, 27.9 us (a dequantize adds 2 operations
// a value, still far below the bytes).
//
// Design. The TPU kernel walks S in blocks of 512 on one core, one (b, kv)
// per grid row, with the running max, denominator and accumulator in VMEM,
// after its wrapper has copied the whole cache to fp32. Here:
// 1. One launch per call. Grid (nsplit, B*KV): each block takes one split
//    of the cache for one (b, kv) and writes its partial (acc, m, l) to
//    scratch; after a barrier, one thread takes the row's ticket (an
//    atomic counter, acquire-release), and the block with the last merges
//    the row's splits in split order, MERGE_GROUP splits per round of
//    loads. The result is bitwise the same whatever order the blocks finish
//    in. A row whose positions all lie in one split is written by that
//    split directly. The counters are a static array of this library, zero
//    at load; the merging block resets its row's, so they are zero again
//    for the next call or graph replay, with no memset. Calls on one device
//    must therefore be ordered on the card (one stream, or streams that
//    wait on each other): overlapping calls would share the counters.
// 2. A pipelined read of the cache as it is stored: a ring of NSTAGE
//    tiles of K and V in shared memory, in the cache's own type (bf16 or
//    fp32), filled by 16-byte cp.async.cg copies. The whole ring is in
//    flight before the first tile is consumed, and each slot is refilled
//    as soon as every warp is done with it. bf16 is widened to fp32 in
//    registers where it is used. At hd 32 and 64 a lane reads 16 (or 8)
//    bytes of a row, so the unpadded rows of a tile are read without bank
//    conflicts.
// 3. Warps that do not wait for each other inside the loop: each warp takes
//    its own positions of every tile and keeps its own online softmax (m,
//    l, accumulator) for all G query rows; the lanes of a warp split each
//    position's channels, and q (pre-scaled) lives in registers. The warps
//    merge once, after the split, with the same log-sum-exp weights as the
//    merge across splits. The only block-wide wait in the loop is the
//    ring's hand-off, one __syncthreads per tile.
// 4. G is a template parameter (1..8), as hd is (32, 64, 80): no guards and
//    no dead accumulators. The channels of a lane shrink as G grows, so q
//    and the accumulator stay within about 2 x QA_REGS registers. At hd 80
//    (5 x 16 channels) 8 or 16 lanes share a position, 10 or 5 channels a
//    lane, read in 8-, 4- or 1-byte pieces (rows stay 16-byte multiples,
//    so the ring's copies are unchanged).
// 6. The int8 cache: the ring holds the int8 rows (a quarter of fp32's
//    bytes per position) and, beside each tile, its K and V scales, copied
//    4 bytes a position by cp.async.ca. A lane widens its int8 values,
//    multiplies by the position's scale and rounds to T (bf16 with
//    round-to-nearest-even, as PyTorch's cast), then goes on as for a
//    cache of type T. No dequantized copy of the cache is ever made.
// 5. The grid and the scratch depend on (B*KV, S) only, never on pos: the
//    wrapper's split plan is a function of S. A block whose split starts
//    after pos leaves at once, and the merge covers splits 0..pos/split_len
//    only. Masked positions are never loaded (the last tile's rows past pos
//    are zero-filled by cp.async without a read). A device pos outside
//    0..S-1 cannot be raised without a synchronise, so the kernel writes
//    NaN to every output of the call instead.
// Numerics: fp32 throughout, no fast math; scores in log2 units (q scaled
// by log2(e) / sqrt(hd), exp2f); the result differs from the plain version
// (fp32 einsum and softmax over all of S) in rounding and summation order
// only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 4;  // warps of a block
constexpr int NT = 32 * NW;
// resident blocks per SM, at least; 3 where G > 6, whose q and
// accumulators do not fit 128 registers without spills
constexpr int min_blocks(int G) { return G > 6 ? 3 : 4; }
constexpr int NSTAGE = 3;         // tiles of the ring
constexpr int TILE_BYTES = 4096;  // bytes of K in a tile (as many of V)
constexpr int QA_REGS = 32;       // G x a lane's channels, at most
constexpr int MAX_GROUP = 8;
constexpr int MERGE_GROUP = 8;   // splits merged per round of loads
constexpr int MAX_ROWS = 65535;  // B * KV: grid.y, and the tickets
constexpr int MAX_TILE = 64;     // positions: the wrapper's split alignment
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ unsigned int g_tickets[MAX_ROWS];

constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// channels of a lane, for cache elements of ES bytes. hd 32, 64: 16 bytes
// of a row, halved until G * CL is within QA_REGS; a quarter-warp then
// reads 128 contiguous bytes of a tile (a half-warp with 8-byte reads), so
// unpadded rows do not conflict. hd 80: 10 (8 lanes a position), or 5 (16
// lanes) where G * 10 would pass QA_REGS
constexpr int lane_channels(int HD, int ES, int G) {
  if (HD % 5 == 0) return G * 10 <= QA_REGS ? 10 : 5;
  int cl = 16 / ES;
  while (G * cl > QA_REGS) cl /= 2;
  return cl;
}

// T: q's type and the compute type; E: the cache's element type, T or
// int8_t (the int8 form, with an fp32 scale per position)
template <typename T, typename E, int HD, int G>
struct Plan {
  static constexpr bool QUANT = std::is_same<E, int8_t>::value;
  static constexpr int ES = sizeof(E);
  static constexpr int CL = lane_channels(HD, ES, G);
  static constexpr int NS = HD / CL;  // lanes sharing one position
  static constexpr int LP = 32 / NS;  // positions of one warp pass
  static constexpr int RB = HD * ES;  // bytes of a cache row
  static constexpr int R0 = TILE_BYTES / (RB * NW * LP);
  // passes of a warp per tile: a power of two, a tile of at most MAX_TILE
  // positions, and R x G scores a lane at most QA_REGS
  static constexpr int R = pow2_floor(
      cmin(cmin(R0, MAX_TILE / (NW * LP)), QA_REGS / G));
  static constexpr int TP = NW * LP * R;     // positions of a tile
  static constexpr int CPR = RB / 16;        // 16-byte chunks of a row
  static constexpr int NCOPY = (TP * CPR + NT - 1) / NT;  // a thread's
  static constexpr int SB = QUANT ? 4 * TP : 0;  // a tile's K (V) scales
  static constexpr int STAGE = 2 * TP * RB + 2 * SB;  // K, V, their scales
  static constexpr int SMEM = NSTAGE * STAGE;
  static_assert(HD % CL == 0 && NS <= 32 && 32 % NS == 0,
                "lanes per position");
  static_assert(RB % 16 == 0, "16-byte row copies");
  static_assert(2 * TP <= NT, "one scale copy per thread");
  static_assert(NW * G * (HD + 2) * 4 <= SMEM, "merge area fits the ring");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ void widen(uint32_t w, float& lo, float& hi) {
  // a bf16 is the top half of an fp32
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// the 4 / sizeof(E) values of a 4-byte word, as fp32
__device__ __forceinline__ void unpack(uint32_t w, float* x, float) {
  x[0] = __uint_as_float(w);
}

__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  widen(w, x[0], x[1]);
}

__device__ __forceinline__ void unpack(uint32_t w, float* x, int8_t) {
#pragma unroll
  for (int i = 0; i < 4; ++i)  // sign-extend byte i
    x[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

__device__ __forceinline__ float value(float e) { return e; }
__device__ __forceinline__ float value(__nv_bfloat16 e) {
  return __bfloat162float(e);
}
__device__ __forceinline__ float value(int8_t e) {
  return static_cast<float>(e);
}

// N consecutive elements at p, as fp32: 16-, 8- or 4-byte loads where N
// elements make a multiple of those bytes (p is then aligned to it), else
// one element a load
template <typename E, int N>
__device__ __forceinline__ void read_row(const E* p, float (&x)[N]) {
  constexpr int BYTES = N * sizeof(E), PER = 4 / sizeof(E);
  const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 t = *reinterpret_cast<const uint4*>(b + 16 * i);
      unpack(t.x, x + 4 * PER * i, E());
      unpack(t.y, x + 4 * PER * i + PER, E());
      unpack(t.z, x + 4 * PER * i + 2 * PER, E());
      unpack(t.w, x + 4 * PER * i + 3 * PER, E());
    }
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) {
      const uint2 t = *reinterpret_cast<const uint2*>(b + 8 * i);
      unpack(t.x, x + 2 * PER * i, E());
      unpack(t.y, x + 2 * PER * i + PER, E());
    }
  } else if constexpr (BYTES % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      unpack(*reinterpret_cast<const uint32_t*>(b + 4 * i), x + PER * i, E());
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = value(p[i]);
  }
}

// an fp32 value rounded to T, as PyTorch's cast (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// a row of the int8 cache read as cache_read(c, T): T(float(q) * s)
template <typename T, int N>
__device__ __forceinline__ void dequantize(float (&x)[N], float s) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = round_to<T>(__fmul_rn(x[i], s));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (through L1, the only route for 4 bytes)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// atomic add of 1 at gpu scope, with release and acquire semantics
__device__ __forceinline__ unsigned ticket_add(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// One block per (split, b * KV + kv). part_acc (B*KV, nsplit, G, HD) and
// part_ml (B*KV, nsplit, G, 2) hold the splits' unnormalised accumulators
// and (max, denominator), in log2 units; out (B*KV, G, HD). k_scale and
// v_scale (B, S, KV) are the int8 form's scales (unused otherwise).
template <typename T, typename E, int HD, int G>
__global__ void __launch_bounds__(NT, min_blocks(G))
decode_attn_kernel(const T* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ pos_dev, int pos_host, int S,
                   int KV, int split_len, float* __restrict__ out,
                   float* __restrict__ part_acc,
                   float* __restrict__ part_ml) {
  using P = Plan<T, E, HD, G>;
  constexpr int CL = P::CL, NS = P::NS, LP = P::LP, R = P::R, TP = P::TP;
  __shared__ __align__(16) unsigned char smem[P::SMEM];
  __shared__ bool is_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.y, split = blockIdx.x, nsplit = gridDim.x;
  float* o = out + static_cast<size_t>(row) * G * HD;
  const int pos = pos_dev ? *pos_dev : pos_host;
  if (pos < 0 || pos >= S) {  // only a device pos gets here
    if (split == 0)
      for (int i = tid; i < G * HD; i += NT)
        o[i] = __int_as_float(0x7fc00000);  // quiet NaN
    return;
  }
  const int nact = pos / split_len + 1;  // splits holding a position <= pos
  if (split >= nact) return;
  const int begin = split * split_len;
  const int end = min(begin + split_len, pos + 1);
  const int ntile = (end - begin + TP - 1) / TP;
  const int b = row / KV, kv = row % KV;
  const size_t step = static_cast<size_t>(KV) * HD;  // between positions
  const size_t row0 = static_cast<size_t>(b) * S * KV + kv;  // position 0
  const E* kb = k + row0 * HD;
  const E* vb = v + row0 * HD;

  // tile t of the split into slot t % NSTAGE of the ring, as commit group
  // t (empty past the last tile, so that the count stays in step)
  auto fetch = [&](int t) {
    if (t < ntile) {
      unsigned char* ks = smem + (t % NSTAGE) * P::STAGE;
      unsigned char* vs = ks + TP * P::RB;
      const int t0 = begin + t * TP;
#pragma unroll
      for (int j = 0; j < P::NCOPY; ++j) {
        const int c = tid + j * NT, p = c / P::CPR, e = c % P::CPR;
        if (TP * P::CPR % NT != 0 && c >= TP * P::CPR) break;
        const bool in = t0 + p < end;
        const size_t off = (in ? t0 + p : begin) * step + e * (16 / P::ES);
        cp_async16(ks + p * P::RB + e * 16, kb + off, in ? 16 : 0);
        cp_async16(vs + p * P::RB + e * 16, vb + off, in ? 16 : 0);
      }
      if constexpr (P::QUANT) {  // K's scales, then V's, after the V tile
        if (tid < 2 * TP) {
          const int p = tid % TP;
          const bool in = t0 + p < end;
          const float* sc = tid < TP ? k_scale : v_scale;
          cp_async4(vs + TP * P::RB + 4 * tid,
                    sc + row0 + static_cast<size_t>(in ? t0 + p : begin) * KV,
                    in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < NSTAGE; ++t) fetch(t);  // the whole ring in flight

  // lane = position group pg x channel slice sl; q of the slice, scaled
  const int sl = lane % NS, pg = lane / NS;
  const float qscale = LOG2E / sqrtf(static_cast<float>(HD));
  float qr[G][CL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    read_row<T, CL>(q + (static_cast<size_t>(row) * G + g) * HD + sl * CL,
                    qr[g]);
#pragma unroll
    for (int c = 0; c < CL; ++c) qr[g][c] *= qscale;
  }
  float m[G], l[G], acc[G][CL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < CL; ++c) acc[g][c] = 0.0f;
  }
  const int wbase = warp * LP * R;  // this warp's first position of a tile

  for (int t = 0; t < ntile; ++t) {
    // NSTAGE + max(t - 1, 0) groups committed: groups 0..t are in (at
    // t = 0, tile 1 too, which was fetched with tile 0)
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t > 0) fetch(t - 1 + NSTAGE);  // into tile t - 1's slot
    const int t0 = begin + t * TP;
    if (t0 + wbase >= end) continue;  // the warp's positions lie past pos
    const unsigned char* ks = smem + (t % NSTAGE) * P::STAGE;
    const unsigned char* vs = ks + TP * P::RB;
    const float* ksc = reinterpret_cast<const float*>(vs + TP * P::RB);

    float s[R][G], mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = wbase + r * LP + pg;
      float kx[CL];
      read_row<E, CL>(reinterpret_cast<const E*>(ks + p * P::RB) + sl * CL,
                      kx);
      if constexpr (P::QUANT) dequantize<T>(kx, ksc[p]);
      const bool valid = t0 + p < end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int c = 0; c < CL; ++c) d = fmaf(qr[g][c], kx[c], d);
#pragma unroll
        for (int off = 1; off < NS; off <<= 1)
          d += __shfl_xor_sync(FULL, d, off);
        s[r][g] = valid ? d : -INFINITY;
        mx[g] = fmaxf(mx[g], s[r][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = NS; off < 32; off <<= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], off));
      // finite: the warp's first position of the tile is valid
      const float mn = fmaxf(m[g], mx[g]);
      if (mn > m[g]) {  // the same on every lane
        const float corr = exp2f(m[g] - mn);  // 0 while m is -inf
        m[g] = mn;
        l[g] *= corr;
#pragma unroll
        for (int c = 0; c < CL; ++c) acc[g][c] *= corr;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][g] = exp2f(s[r][g] - mn);  // 0 past pos
        l[g] += s[r][g];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = wbase + r * LP + pg;
      float vx[CL];  // zeros past pos
      read_row<E, CL>(reinterpret_cast<const E*>(vs + p * P::RB) + sl * CL,
                      vx);
      if constexpr (P::QUANT) dequantize<T>(vx, ksc[TP + p]);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < CL; ++c)
          acc[g][c] = fmaf(s[r][g], vx[c], acc[g][c]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // sum over the position groups; every lane ends with the warp's totals
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = NS; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int c = 0; c < CL; ++c)
        acc[g][c] += __shfl_xor_sync(FULL, acc[g][c], off);
    }
  }
  float* wacc = reinterpret_cast<float*>(smem);  // (NW, G, HD)
  float* wml = wacc + NW * G * HD;               // (NW, G, 2)
  if (pg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < CL; ++c)
        wacc[(warp * G + g) * HD + sl * CL + c] = acc[g][c];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wml[(warp * G + g) * 2] = m[g];
      wml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();

  // the block's partial: warps merged in warp order (warp 0 holds the
  // split's first position, so the max is finite)
  const size_t slot = static_cast<size_t>(row) * nsplit + split;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wml[(w * G + g) * 2]);
    float L = 0.0f, O = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(wml[(w * G + g) * 2] - M);  // 0 for m = -inf
      L = fmaf(c, wml[(w * G + g) * 2 + 1], L);
      O = fmaf(c, wacc[w * G * HD + i], O);
    }
    if (nact == 1) {
      o[i] = O / fmaxf(L, 1e-30f);
    } else {
      part_acc[slot * G * HD + i] = O;
      if (i % HD == 0) {
        part_ml[(slot * G + g) * 2] = M;
        part_ml[(slot * G + g) * 2 + 1] = L;
      }
    }
  }
  if (nact == 1) return;

  __syncthreads();  // the block's partial is written
  if (tid == 0) {
    // release: the partial (all threads', ordered by the barrier) before
    // the ticket; acquire: the other splits' partials, for the last one
    const unsigned ticket = ticket_add(&g_tickets[row]);
    is_last = ticket == static_cast<unsigned>(nact - 1);
    if (is_last) g_tickets[row] = 0;  // every split has its ticket
  }
  __syncthreads();
  if (!is_last) return;

  // the row's last block: merge its splits in split order, MERGE_GROUP at
  // a time with their loads in flight together (L2 reads, as other SMs
  // wrote them), rescaling the running sums by each group's max
  const float* ml = part_ml + static_cast<size_t>(row) * nsplit * G * 2;
  const float* pa = part_acc + static_cast<size_t>(row) * nsplit * G * HD;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD;
    float M = -INFINITY, L = 0.0f, O = 0.0f;
    for (int s0 = 0; s0 < nact; s0 += MERGE_GROUP) {
      float mv[MERGE_GROUP], lv[MERGE_GROUP], ov[MERGE_GROUP];
#pragma unroll
      for (int j = 0; j < MERGE_GROUP; ++j) {
        const int sp = s0 + j;
        const bool in = sp < nact;
        mv[j] = in ? __ldcg(ml + (sp * G + g) * 2) : -INFINITY;
        lv[j] = in ? __ldcg(ml + (sp * G + g) * 2 + 1) : 0.0f;
        ov[j] = in ? __ldcg(pa + static_cast<size_t>(sp) * G * HD + i) : 0.0f;
      }
      float mg = M;  // finite: split 0 holds position 0
#pragma unroll
      for (int j = 0; j < MERGE_GROUP; ++j) mg = fmaxf(mg, mv[j]);
      const float c = exp2f(M - mg);  // 0 on the first group
      L *= c;
      O *= c;
#pragma unroll
      for (int j = 0; j < MERGE_GROUP; ++j) {
        const float w = exp2f(mv[j] - mg);  // 0 past the last split
        L = fmaf(w, lv[j], L);
        O = fmaf(w, ov[j], O);
      }
      M = mg;
    }
    o[i] = O / fmaxf(L, 1e-30f);
  }
}

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int* pos_dev;
  int pos, S, KV, rows, split_len, nsplit;
  float *out, *part_acc, *part_ml;
  cudaStream_t stream;
};

template <typename T, typename E, int HD, int G>
int launch(const Args& a) {
  decode_attn_kernel<T, E, HD, G>
      <<<dim3(a.nsplit, a.rows), NT, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const E*>(a.k),
          static_cast<const E*>(a.v), a.k_scale, a.v_scale, a.pos_dev, a.pos,
          a.S, a.KV, a.split_len, a.out, a.part_acc, a.part_ml);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E, int HD>
int by_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, E, HD, 1>(a);
    case 2: return launch<T, E, HD, 2>(a);
    case 3: return launch<T, E, HD, 3>(a);
    case 4: return launch<T, E, HD, 4>(a);
    case 5: return launch<T, E, HD, 5>(a);
    case 6: return launch<T, E, HD, 6>(a);
    case 7: return launch<T, E, HD, 7>(a);
    case 8: return launch<T, E, HD, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename E>
int by_head_dim(int HD, int G, const Args& a) {
  switch (HD) {
    case 32: return by_group<T, E, 32>(G, a);
    case 64: return by_group<T, E, 64>(G, a);
    case 80: return by_group<T, E, 80>(G, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_cache(bool is_int8, int HD, int G, const Args& a) {
  return is_int8 ? by_head_dim<T, int8_t>(HD, G, a)
                 : by_head_dim<T, T>(HD, G, a);
}

}  // namespace

// q (B, KV, G, HD), k, v (B, S, KV, HD), all bf16 (is_bf16) or all fp32,
// or, with is_int8, k and v int8 with fp32 scales k_scale, v_scale (B, S,
// KV) and q bf16 or fp32; contiguous, 16-byte aligned (the scales 4-byte
// aligned); positions 0..pos attend, pos being *pos_dev
// (an int32 in device memory) when pos_dev is not null, else pos. Splits of
// split_len positions cover 0..S-1: nsplit = ceil(S / split_len). Scratch
// part_acc (B*KV*nsplit*G*HD) and part_ml (B*KV*nsplit*G*2) fp32; out (B,
// KV, G, HD) fp32, NaN throughout if a device pos lies outside 0..S-1.
// One launch on `stream`, nothing else; returns its CUDA error, or 0.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int* pos_dev, float* out, float* part_acc,
                           float* part_ml, int B, int S, int KV, int G,
                           int HD, int pos, int split_len, int nsplit,
                           int is_bf16, int is_int8, void* stream) {
  const long long rows = static_cast<long long>(B) * KV;
  if (G < 1 || G > MAX_GROUP || S < 1 || rows < 1 || rows > MAX_ROWS ||
      split_len < 1 || nsplit < 1 ||
      static_cast<long long>(nsplit - 1) * split_len >= S ||
      static_cast<long long>(nsplit) * split_len < S ||
      (pos_dev == nullptr && (pos < 0 || pos >= S)) ||
      (is_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, pos_dev, pos, S, KV,
               static_cast<int>(rows), split_len, nsplit, out, part_acc,
               part_ml, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? by_cache<__nv_bfloat16>(is_int8, HD, G, a)
                 : by_cache<float>(is_int8, HD, G, a);
}
