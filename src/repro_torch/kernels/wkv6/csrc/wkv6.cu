// RWKV6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// wkv6_kernel replaces
//   src/repro/kernels/wkv6/kernel.py:71 wkv6_pallas
//   (body _kernel): per (b, h), with the (hd, hd) state S carried across
//   the sequence,
//     o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//     S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). Each
// token moves r, k, v, ld and o (5 hd fp32 values per head) and costs
// about 4 hd^2 operations (the state's read-out and update), plus the
// pairwise decays inside a chunk: 20 hd bytes against ~4 hd^2 operations,
// so at hd = 64 both limits are close (prefill B=16, S=1024, H=32: 688 MB,
// 0.205 ms). A decode step (S = 1) only reads and writes the state: 32 KB
// per head, bound by bytes.
//
// Design. The TPU kernel walks the chunks of 64 on one core, the state in
// VMEM, and its wrapper pads S to a multiple of 64. Here one thread block
// of 256 threads owns one (b, h) and walks the sequence in chunks of 16
// tokens, the state in registers (thread (j, iq) keeps column j, rows
// iq*hd/4 .. +hd/4 at hd 64). Nothing is padded: the last chunk is as long
// as it is, and a decode step is one chunk of one token. Per chunk:
// - load r, k, v, ld (bf16 r, k, v are widened on load);
// - L = inclusive cumulative log-decay per channel, Lc = its last row;
// - A[t][s] = sum_i r_t k_s exp(L_t - ld_t - L_s) only for s < t, so every
//   exponent is a sum of log-decays and <= 0; the TPU kernel evaluates
//   exp for all (t, s) and masks afterwards, and exp of the positive
//   exponents of s >= t overflows to inf for fast decays (inf * 0 = NaN);
// - the bonus diag[t] = sum_i r_t u k_t;
// - o_t = sum_{s<t} A[t][s] v_s + diag[t] v_t + (r_t exp(L_t - ld_t)) S,
//   the last term summed per row slice of the state and the slices added;
// - S = diag(exp(Lc)) S + sum_s (k_s exp(Lc - L_s)) v_s^T.
// Numerics: fp32 throughout, no fast math; the order of the sums differs
// from the plain versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per (b, h)
constexpr int C = 16;    // tokens per chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ ld,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  constexpr int RS = HD + 4;   // padded, float4-aligned tile rows
  constexpr int IQ = NT / HD;  // row slices of the state
  constexpr int IPT = HD / IQ;  // state rows (k channels) per thread
  static_assert(NT % HD == 0 && IPT % 4 == 0, "shape");

  __shared__ __align__(16) float rt[C * RS];  // r, then r * exp(L - ld)
  __shared__ __align__(16) float kt[C * RS];  // k, then k * exp(Lc - L)
  __shared__ __align__(16) float vt[C * RS];
  __shared__ __align__(16) float lt[C * RS];  // log-decay
  __shared__ __align__(16) float Lt[C * RS];  // inclusive cumsum over t
  __shared__ float part[IQ * C * HD];  // read-out of each row slice
  __shared__ float At[C * C];          // intra-chunk weights, s < t
  __shared__ float diag[C];            // bonus of each token
  __shared__ float us[HD], ec[HD];     // u; exp(Lc)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = tid % HD, iq = tid / HD, i0 = iq * IPT;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD;
  float st[IPT];  // S[i0 + ii][j]
#pragma unroll
  for (int ii = 0; ii < IPT; ++ii) st[ii] = s0[sbase + (i0 + ii) * HD + j];
  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];

  for (int t0 = 0; t0 < S; t0 += C) {
    const int n = min(C, S - t0);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int c = tid; c < n * HD; c += NT) {
      const int t = c / HD, i = c % HD;
      const size_t g =
          ((static_cast<size_t>(b) * S + t0 + t) * H + h) * HD + i;
      rt[t * RS + i] = to_float(r[g]);
      kt[t * RS + i] = to_float(k[g]);
      vt[t * RS + i] = to_float(v[g]);
      lt[t * RS + i] = ld[g];
    }
    __syncthreads();
    for (int i = tid; i < HD; i += NT) {
      float L = 0.0f;
      for (int t = 0; t < n; ++t) {
        L += lt[t * RS + i];
        Lt[t * RS + i] = L;
      }
      ec[i] = expf(L);
    }
    __syncthreads();

    // intra-chunk weights for s < t only, and the bonus for s == t
    for (int c = tid; c < n * n; c += NT) {
      const int t = c / n, s = c % n;
      if (s < t) {
        float a = 0.0f;
        for (int i = 0; i < HD; ++i) {
          const float lx = Lt[t * RS + i] - lt[t * RS + i];
          a = fmaf(rt[t * RS + i], kt[s * RS + i] * expf(lx - Lt[s * RS + i]),
                   a);
        }
        At[t * C + s] = a;
      } else if (s == t) {
        float a = 0.0f;
        for (int i = 0; i < HD; ++i)
          a = fmaf(rt[t * RS + i], kt[t * RS + i] * us[i], a);
        diag[t] = a;
      }
    }
    __syncthreads();

    // decayed r (reads the state) and k (writes it), in place
    for (int c = tid; c < n * HD; c += NT) {
      const int t = c / HD, i = c % HD;
      const float L = Lt[t * RS + i];
      rt[t * RS + i] *= expf(L - lt[t * RS + i]);
      kt[t * RS + i] *= expf(Lt[(n - 1) * RS + i] - L);
    }
    __syncthreads();

    // this thread's slice of the read-out from the state before the chunk
    for (int t = 0; t < n; ++t) {
      float a = 0.0f;
#pragma unroll
      for (int ii = 0; ii < IPT; ii += 4) {
        const float4 rr =
            *reinterpret_cast<const float4*>(&rt[t * RS + i0 + ii]);
        a = fmaf(rr.x, st[ii], a);
        a = fmaf(rr.y, st[ii + 1], a);
        a = fmaf(rr.z, st[ii + 2], a);
        a = fmaf(rr.w, st[ii + 3], a);
      }
      part[(iq * C + t) * HD + j] = a;
    }
    // then the state update of the slice
    float kv[IPT];
#pragma unroll
    for (int ii = 0; ii < IPT; ++ii) kv[ii] = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float vv = vt[s * RS + j];
#pragma unroll
      for (int ii = 0; ii < IPT; ii += 4) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&kt[s * RS + i0 + ii]);
        kv[ii] = fmaf(kk.x, vv, kv[ii]);
        kv[ii + 1] = fmaf(kk.y, vv, kv[ii + 1]);
        kv[ii + 2] = fmaf(kk.z, vv, kv[ii + 2]);
        kv[ii + 3] = fmaf(kk.w, vv, kv[ii + 3]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < IPT; ++ii) st[ii] = st[ii] * ec[i0 + ii] + kv[ii];
    __syncthreads();

    // outputs: intra-chunk and bonus terms, plus the slices' read-outs
    for (int c = tid; c < n * HD; c += NT) {
      const int t = c / HD, jj = c % HD;
      float a = 0.0f;
      for (int s = 0; s < t; ++s) a = fmaf(At[t * C + s], vt[s * RS + jj], a);
      a = fmaf(diag[t], vt[t * RS + jj], a);
      float inter = 0.0f;
      for (int q = 0; q < IQ; ++q) inter += part[(q * C + t) * HD + jj];
      o[((static_cast<size_t>(b) * S + t0 + t) * H + h) * HD + jj] =
          a + inter;
    }
  }
#pragma unroll
  for (int ii = 0; ii < IPT; ++ii) s_out[sbase + (i0 + ii) * HD + j] = st[ii];
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v,
                 const float* ld, const float* u, const float* s0, float* o,
                 float* s_out, int B, int S, int H, int HD,
                 cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  switch (HD) {
    case 32:
      wkv6_kernel<T, 32><<<B * H, NT, 0, stream>>>(rp, kp, vp, ld, u, s0, o,
                                                   s_out, S, H);
      return 0;
    case 64:
      wkv6_kernel<T, 64><<<B * H, NT, 0, stream>>>(rp, kp, vp, ld, u, s0, o,
                                                   s_out, S, H);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v (B, S, H, HD) bf16 (is_bf16) or fp32; ld (B, S, H, HD), u (H, HD)
// and s0 (B, H, HD, HD) fp32; all contiguous. Writes o (B, S, H, HD) and
// s_out (B, H, HD, HD) in fp32 (s_out must not alias s0). One launch of
// B*H thread blocks on `stream`; returns the CUDA error, or 0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const float* ld, const float* u, const float* s0,
                    float* o, float* s_out, int B, int S, int H, int HD,
                    int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      is_bf16 ? launch_typed<__nv_bfloat16>(r, k, v, ld, u, s0, o, s_out, B,
                                            S, H, HD, st)
              : launch_typed<float>(r, k, v, ld, u, s0, o, s_out, B, S, H,
                                    HD, st);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
