// Flash-decoding attention for Hopper (sm_90a), plain C interface for ctypes.
//
// decode_attn_split_kernel + decode_attn_combine_kernel replace
//   src/repro/kernels/decode_attn/kernel.py:59 decode_attn_pallas
//   (body _kernel): one query token per sequence, in GQA layout q (B, KV,
//   G, hd), against the KV cache k, v (B, S, KV, hd); positions after pos
//   are masked; the output (B, KV, G, hd) is fp32.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). Each
// cached K and V row is read once and used by G query heads: about 6 G
// operations per 4 hd bytes of bf16 cache, far below the ~20 operations
// per byte where fp32 arithmetic would limit, so the kernel is bound by
// the cache bytes. At the decode_32k shape (B=128, S=32768, KV=5, hd=64,
// bf16) that is 5.37 GB, 1.60 ms.
//
// Design. The TPU kernel walks S in blocks of 512 on one core, one (b, kv)
// per grid row, with the running max, denominator and accumulator in VMEM,
// after its wrapper has copied the whole cache to fp32. Here:
// - The cache is read as it is stored (bf16 or fp32, 16-byte loads),
//   widened in registers and staged in shared memory as fp32; no fp32 copy
//   of the cache exists in device memory.
// - Only positions 0..pos are read: the valid length is cut into
//   `nsplit` splits and grid (nsplit, B*KV) gives the card enough thread
//   blocks when B*KV is small (80 on the smollm decode path, against 132
//   SMs). Masked positions are never loaded, so a split that lies wholly
//   past pos does not exist; the combine would weigh one by
//   exp(-inf - M) = 0 all the same (its m is -inf and its l 0, where the
//   reference's -1e30 sentinel would give exp(0) = 1 to each masked score).
// - Inside a split, tiles of 4096/hd positions: each thread dots one
//   position with all G query rows over a channel slice (float4 reads of
//   a padded K row and broadcast q), one warp per query row keeps the
//   online softmax (running max m, sum l, rescale factor), and each thread
//   accumulates 4 output channels for every query row over a slice of the
//   positions. The partial (acc, m, l) of each split goes to scratch.
// - decode_attn_combine_kernel merges the splits of each (b, kv) with the
//   usual log-sum-exp weights.
// Numerics: fp32 throughout, no fast math; the result differs from the
// plain version (fp32 einsum and softmax over all of S) in summation order
// only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;          // threads of a split block
constexpr int MAXG = 8;          // query heads per KV head, at most
constexpr int TILE_ELEMS = 4096;  // cache elements per tile and tensor
constexpr int COMBINE_NT = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of the cache, widened to fp32
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of an fp32
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One thread block per (split, b * KV + kv). Writes the split's unnormalised
// accumulator to part_acc (B*KV, nsplit, G, HD) and its running max and
// denominator to part_ml (B*KV, nsplit, G, 2).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, int S, int KV, int G,
                         int valid, int split_len, float scale,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml) {
  constexpr int TILE = TILE_ELEMS / HD;  // positions per tile
  constexpr int KSTRIDE = HD + 4;        // float4-aligned, conflict-free rows
  constexpr int VE = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int VPR = HD / VE;           // 16-byte loads per cache row
  constexpr int NSLICE = NT / TILE;      // threads sharing one position's dot
  constexpr int CH = HD / NSLICE;        // channels of each such thread
  constexpr int NDG = HD / 4;            // float4 groups of output channels
  constexpr int NPART = NT / NDG;        // threads sharing one channel group
  static_assert(NT % TILE == 0 && CH % 4 == 0 && NT % NDG == 0, "shape");
  static_assert(NPART * MAXG * HD <= TILE * HD, "the reduction reuses vs");

  __shared__ __align__(16) float ks[TILE * KSTRIDE];
  __shared__ __align__(16) float vs[TILE * HD];
  __shared__ __align__(16) float qs[MAXG * HD];
  __shared__ float ps[NSLICE * MAXG * TILE];
  __shared__ float m_s[MAXG], l_s[MAXG], corr_s[MAXG];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bk = blockIdx.y, b = bk / KV, kv = bk % KV;
  const int split = blockIdx.x;
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, valid);
  const size_t row = static_cast<size_t>(KV) * HD;  // between positions
  const size_t head = (static_cast<size_t>(b) * S * KV + kv) * HD;
  const T* kb = k + head;
  const T* vb = v + head;

  for (int i = tid; i < G * HD; i += NT)
    qs[i] = to_float(q[static_cast<size_t>(bk) * G * HD + i]);
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  const int sp = tid % TILE, sl = tid / TILE;  // scores: position, slice
  const int dg = tid % NDG, part = tid / NDG;  // P.V: channels, positions
  float acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;

  for (int t0 = s_begin; t0 < s_end; t0 += TILE) {
    const int n = min(TILE, s_end - t0);
    __syncthreads();  // the previous tile is consumed; qs, m_s are set
#pragma unroll 4
    for (int c = tid; c < n * VPR; c += NT) {
      const int p = c / VPR, e = (c % VPR) * VE;
      float kx[VE], vx[VE];
      widen16(kb + (t0 + p) * row + e, kx);
      widen16(vb + (t0 + p) * row + e, vx);
#pragma unroll
      for (int j = 0; j < VE; j += 4) {
        *reinterpret_cast<float4*>(&ks[p * KSTRIDE + e + j]) =
            make_float4(kx[j], kx[j + 1], kx[j + 2], kx[j + 3]);
        *reinterpret_cast<float4*>(&vs[p * HD + e + j]) =
            make_float4(vx[j], vx[j + 1], vx[j + 2], vx[j + 3]);
      }
    }
    __syncthreads();

    // partial q.k of position sp over channel slice sl, all query rows
    if (sp < n) {
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.0f;
#pragma unroll 4
      for (int e = sl * CH; e < (sl + 1) * CH; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(
            &ks[sp * KSTRIDE + e]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qq =
                *reinterpret_cast<const float4*>(&qs[g * HD + e]);
            dot[g] = fmaf(qq.x, kk.x, dot[g]);
            dot[g] = fmaf(qq.y, kk.y, dot[g]);
            dot[g] = fmaf(qq.z, kk.z, dot[g]);
            dot[g] = fmaf(qq.w, kk.w, dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) ps[(sl * MAXG + g) * TILE + sp] = dot[g];
    }
    __syncthreads();

    // online softmax, one warp per query row: scores into slice 0's slots,
    // then their exponentials against the new running max
    for (int g = warp; g < G; g += NT / 32) {
      float mx = -INFINITY;
      for (int p = lane; p < n; p += 32) {
        float s = 0.0f;
        for (int h = 0; h < NSLICE; ++h) s += ps[(h * MAXG + g) * TILE + p];
        s *= scale;
        ps[g * TILE + p] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int p = lane; p < n; p += 32) {
        const float e = expf(ps[g * TILE + p] - m_new);
        ps[g * TILE + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V over this thread's positions
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float c = corr_s[g];
        acc[g][0] *= c;
        acc[g][1] *= c;
        acc[g][2] *= c;
        acc[g][3] *= c;
      }
    }
    for (int p = part; p < n; p += NPART) {
      const float4 vv = *reinterpret_cast<const float4*>(&vs[p * HD + dg * 4]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float w = ps[g * TILE + p];
          acc[g][0] = fmaf(w, vv.x, acc[g][0]);
          acc[g][1] = fmaf(w, vv.y, acc[g][1]);
          acc[g][2] = fmaf(w, vv.z, acc[g][2]);
          acc[g][3] = fmaf(w, vv.w, acc[g][3]);
        }
      }
    }
  }

  // sum the position slices of each channel group; vs is free now
  __syncthreads();
  float* red = vs;
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
      *reinterpret_cast<float4*>(&red[(part * MAXG + g) * HD + dg * 4]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  const size_t base = static_cast<size_t>(bk) * gridDim.x + split;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float s = 0.0f;
    for (int pp = 0; pp < NPART; ++pp) s += red[(pp * MAXG + g) * HD + d];
    part_acc[base * G * HD + i] = s;
  }
  if (tid < G) {
    part_ml[(base * G + tid) * 2] = m_s[tid];
    part_ml[(base * G + tid) * 2 + 1] = l_s[tid];
  }
}

// One thread block per b * KV + kv: out = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max_s m_s).
__global__ void __launch_bounds__(COMBINE_NT)
decode_attn_combine_kernel(const float* __restrict__ part_acc,
                           const float* __restrict__ part_ml, int nsplit,
                           int G, int HD, float* __restrict__ out) {
  const size_t bk = blockIdx.x;
  const float* ml = part_ml + bk * nsplit * G * 2;
  for (int i = threadIdx.x; i < G * HD; i += COMBINE_NT) {
    const int g = i / HD;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[(s * G + g) * 2]);
    float L = 0.0f, O = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[(s * G + g) * 2] - M);  // 0 for m = -inf
      L = fmaf(w, ml[(s * G + g) * 2 + 1], L);
      O = fmaf(w, part_acc[(bk * nsplit + s) * G * HD + i], O);
    }
    out[bk * G * HD + i] = O / fmaxf(L, 1e-30f);
  }
}

template <typename T, int HD>
void launch_split(const void* q, const void* k, const void* v, int B, int S,
                  int KV, int G, int valid, int split_len, int nsplit,
                  float* part_acc, float* part_ml, cudaStream_t stream) {
  const dim3 grid(nsplit, B * KV);
  decode_attn_split_kernel<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, KV, G, valid, split_len,
      1.0f / sqrtf(static_cast<float>(HD)), part_acc, part_ml);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, int B, int S,
                 int KV, int G, int HD, int valid, int split_len, int nsplit,
                 float* part_acc, float* part_ml, cudaStream_t stream) {
  switch (HD) {
    case 32:
      launch_split<T, 32>(q, k, v, B, S, KV, G, valid, split_len, nsplit,
                          part_acc, part_ml, stream);
      return 0;
    case 64:
      launch_split<T, 64>(q, k, v, B, S, KV, G, valid, split_len, nsplit,
                          part_acc, part_ml, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, KV, G, HD), k, v (B, S, KV, HD), all bf16 (is_bf16) or all fp32,
// contiguous; positions 0..pos attend. Scratch part_acc (B*KV*nsplit*G*HD)
// and part_ml (B*KV*nsplit*G*2) fp32; out (B, KV, G, HD) fp32. Splits of
// split_len positions cover 0..pos; nsplit = ceil((pos + 1) / split_len).
// Two launches on `stream`; returns the first CUDA error, or 0.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           float* out, float* part_acc, float* part_ml,
                           int B, int S, int KV, int G, int HD, int pos,
                           int split_len, int nsplit, int is_bf16,
                           void* stream) {
  if (G < 1 || G > MAXG || pos < 0 || pos >= S || nsplit < 1 ||
      (nsplit - 1) * split_len > pos || nsplit * split_len <= pos)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      is_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, B, S, KV, G, HD,
                                            pos + 1, split_len, nsplit,
                                            part_acc, part_ml, s)
              : launch_typed<float>(q, k, v, B, S, KV, G, HD, pos + 1,
                                    split_len, nsplit, part_acc, part_ml, s);
  if (err != 0) return err;
  decode_attn_combine_kernel<<<B * KV, COMBINE_NT, 0, s>>>(
      part_acc, part_ml, nsplit, G, HD, out);
  return static_cast<int>(cudaGetLastError());
}
