// RWKV6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// wkv6_seq_kernel and wkv6_step_kernel replace
//   src/repro/kernels/wkv6/kernel.py:71 wkv6_pallas
//   (body _kernel): per (b, h), with the (hd, hd) state S carried across
//   the sequence,
//     o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//     S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s; 495 TFLOP/s TF32, so 165
// for the three-product split used here). Each token moves r, k, v (in
// their type), ld and o (fp32) per head and costs about 5 hd^2 operations
// (read-out, decay and update): prefill B=16, S=1024, H=32, hd=64 in bf16
// moves 487 MB, 0.145 ms, against 0.067 ms of operations, so it is bound
// by bytes. A decode step (S = 1) reads and writes the state: 32 KB per
// head, bound by bytes.
//
// Design. The TPU kernel walks the chunks of 64 on one core. Here one
// thread-block cluster of up to 8 CTAs owns one (b, h), and CTA j owns one
// segment of up to TS = 128 tokens (ref.segment_plan; a longer sequence
// takes several rounds of the cluster). Per round:
// 1. Warp c of the CTA copies chunk c (C = 16 tokens) into shared memory
//    with 16-byte cp.async copies (r, k and v in their own type, rows past
//    the sequence zero-filled), waits for its own copies only, and prepares
//    the chunk alone: the inclusive cumulative log-decay L of each channel
//    (written over ld), the chunk's A[t][s], then R~ = r exp(Lx) over L and
//    K~ = k exp(Lc - L) over r|k, with Lx[t] = L[t-1] and Lc = L[15]. A's
//    pairs s < t inside a sub-block of SB = 8 tokens are summed pair by
//    pair, r k exp(Lx[t] - L[s]); a pair across the two sub-blocks
//    factorises about L_ref = L[7], (r exp(Lx - L_ref)) . (k exp(L_ref -
//    L)); the bonus sits on the diagonal. A lane takes a channel; the
//    channel sums of 32 entries at a time are folded across the lanes.
// 2. The segment's local state from zero, dS = sum_c diag(Ea[c]) K~_c^T
//    V_c with Ea[c] = prod_{c' > c} exp(Lc'), and its decay E = prod_c
//    exp(Lc), both exported to shared memory (not needed from the last
//    CTA of the last round).
// 3. After a cluster barrier, CTA p folds its slice of the state's
//    elements over the cluster's segments in rank order, s <- s E_j +
//    dS_j (from s0, or the previous round), reading every CTA's dS and E
//    through distributed shared memory and writing each CTA's incoming
//    state in place of the dS it read there; a second barrier. No atomics
//    and a fixed order: two calls give the same bits.
// 4. The chunks in order from the incoming state: o = A V + R~ S and
//    S = diag(exp(Lc)) S + K~^T V, all operands resident.
// Every exponent is a difference L[x] - L[y] with x <= y, so <= 0; the TPU
// kernel evaluates exp for s >= t too, where it overflows for fast decays.
// The products (dS, read-out, update, A V) run on the tensor cores as
// mma.sync m16n8k8 TF32 with each fp32 operand split into a TF32 high and
// low part, three products summed in fp32 (bf16 operands are exact in
// TF32, so two). The state lives in registers as mma accumulators of the
// transposed state S^T (v channel x k channel): warp w holds rows
// 16 (w % JB).. and a slice of the columns, and its fragments are the
// read-out's A operand as they stand (the k index within an 8-wide step
// taken in the order 0, 2, 4, 6, 1, 3, 5, 7). Shared memory: 113,152 bytes
// at bf16 and hd 64, so two CTAs per SM.
// A decode step (S = 1) takes wkv6_step_kernel: one block per (b, h),
// the state read and written once with 16-byte accesses.
// Numerics: fp32 throughout, accurate expf, no fast math; the order of the
// sums differs from the plain versions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int NW = NT / 32;      // warps per CTA
constexpr int C = 16;            // tokens per chunk
constexpr int SB = 8;            // tokens per sub-block
constexpr int TS = 128;          // most tokens per segment
constexpr int MAX_SEG = 8;       // most CTAs per cluster (portable)
constexpr int NCH = TS / C;      // most chunks per segment

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// --- copies -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// wait until this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// --- cluster ----------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// --- tensor cores -----------------------------------------------------------

// x = hi + lo + e with hi and lo TF32, |e| <= 2^-20 |x|: the three-product
// split. The tensor cores read a TF32 operand's top 19 bits, so hi is x as
// it stands (truncated there) and lo the exact remainder x - trunc(x)
// (truncated in turn).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}
// d += a b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A operand (16 x 8, row-major) as TF32 high and low parts; the low
// part is zero, and skipped, where the values are exact in TF32 (bf16).
template <bool EXACT>
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int e, float x) {
    if (EXACT) {
      hi[e] = __float_as_uint(x);
    } else {
      split(x, hi[e], lo[e]);
    }
  }
  // d += A (b_hi + b_lo), small products first
  __device__ __forceinline__ void mma3(float (&d)[4], float b0,
                                       float b1) const {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    if (!EXACT) mma(d, lo, h0, h1);
    mma(d, hi, l0, l1);
    mma(d, hi, h0, h1);
  }
};

// --- warp reductions --------------------------------------------------------

// Sums each of the M values of v over the lanes of a warp, halving the
// values held at each step (M a power of two, at most 32), in a fixed
// order: lane l ends with the total of value l >> (5 - log2 M) in v[0].
template <int M, int OFF>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (OFF > 0) {
      if constexpr (M > 1) {
        const bool up = lane & OFF;
#pragma unroll
        for (int j = 0; j < M / 2; ++j) {
          const float send = up ? v[j] : v[j + M / 2];
          const float keep = up ? v[j + M / 2] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        }
        ReduceScatter<M / 2, OFF / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
        ReduceScatter<1, OFF / 2>::run(v, lane);
      }
    }
  }
};

// --- shared memory ----------------------------------------------------------

template <typename T, int HD>
struct Plan {
  static constexpr int JB = HD / 16;      // 16-row blocks of S^T (v chan.)
  static constexpr int IS = NW / JB;      // warps sharing a row block
  static constexpr int IW = HD / IS;      // S^T columns (k chan.) per warp
  static constexpr int NI = IW / 8;       // 8-wide column tiles per warp
  static constexpr int FR = NI * 4;       // state floats per thread
  static constexpr int NH = HD / 32;      // 32-channel halves of a row
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  static constexpr int CPR = HD / EPC;    // 16-byte chunks per r, k, v row
  static constexpr int RKT = 2 * HD;      // r|k tile row, in T
  static constexpr int RKF = RKT * static_cast<int>(sizeof(T)) / 4;  // fp32
  static constexpr int RP = HD + 4;       // row stride of a partial o^T
  static constexpr int RA = C + 4;        // row stride of A
  static constexpr int PB = 2 * (IS - 1) * C * RP;  // two partial buffers
  static constexpr int XS = HD * HD > PB ? HD * HD : PB;  // exchange area
  // byte offsets, each a multiple of 16
  static constexpr size_t RK = 0;  // r|k rows, then K~ (fp32)
  static constexpr size_t V = RK + size_t(TS) * RKT * sizeof(T);
  static constexpr size_t L = V + size_t(TS) * HD * sizeof(T);  // ld, L, R~
  static constexpr size_t AB = L + size_t(TS) * HD * 4;  // A per chunk
  static constexpr size_t EC = AB + size_t(NCH) * C * RA * 4;  // exp(Lc)
  static constexpr size_t EA = EC + size_t(NCH) * HD * 4;  // later decay
  static constexpr size_t XD = EA + size_t(NCH) * HD * 4;  // dS, S_in, o^T
  static constexpr size_t EL = XD + size_t(XS) * 4;  // the segment's decay
  static constexpr size_t US = EL + HD * 4;
  static constexpr size_t BYTES = US + HD * 4;
  static_assert(NW % JB == 0 && IW % 8 == 0 && NCH == NW, "shape");
  static_assert(NT * FR == HD * HD, "state fragments cover S");
};

// element (t, i) of the [TS][HD] v tile: 16-byte chunks of a row permuted
// by the row, so that the mma fragment loads hit distinct banks
template <typename T, int HD>
__device__ __forceinline__ int vix(int t, int i) {
  constexpr int EPC = Plan<T, HD>::EPC;
  constexpr int SW = sizeof(T) == 4 ? 2 : 1;
  return t * HD + (((i / EPC) ^ ((t & 3) * SW)) * EPC) + i % EPC;
}
// r and k of channel i in a row of the r|k tile (in T): each 32-channel
// half keeps its r and its k together, so that K~ (fp32) of that half can
// take their place
__device__ __forceinline__ int rpos(int i) { return (i >> 5) * 64 + (i & 31); }
__device__ __forceinline__ int kpos(int i) { return rpos(i) + 32; }
// K~ and R~ of channel i in row t (fp32): 8-float groups of a half
// permuted by the row, for the mma fragment loads
template <int HALF>
__device__ __forceinline__ int fpos(int t, int i) {
  return (i >> 5) * HALF + ((i & 31) ^ ((t & 3) << 3));
}

// --- the sequence kernel ----------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
wkv6_seq_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ld,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ o, float* __restrict__ s_out, int S,
                int H, int nseg, int seg_len, int rounds) {
  using P = Plan<T, HD>;
  constexpr bool EXACT_V = sizeof(T) == 2;  // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  T* rk = reinterpret_cast<T*>(smem + P::RK);
  float* kt = reinterpret_cast<float*>(smem + P::RK);  // K~ after the prep
  T* vs = reinterpret_cast<T*>(smem + P::V);
  float* Ls = reinterpret_cast<float*>(smem + P::L);  // ld, L, then R~
  float* Ab = reinterpret_cast<float*>(smem + P::AB);
  float* ecs = reinterpret_cast<float*>(smem + P::EC);
  float* eas = reinterpret_cast<float*>(smem + P::EA);
  float* xd = reinterpret_cast<float*>(smem + P::XD);
  float* elx = reinterpret_cast<float*>(smem + P::EL);
  float* us = reinterpret_cast<float*>(smem + P::US);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int jb = warp % P::JB, ih = warp / P::JB;
  const int j0 = jb * 16 + g;           // S^T rows j0, j0 + 8
  const int ib = ih * P::IW + 2 * q;    // + nt * 8 (+1): S^T columns
  const int bh = blockIdx.x / nseg, b = bh / H, h = bh % H;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD;

  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];
  for (int e = tid; e < NCH * C * P::RA; e += NT) Ab[e] = 0.0f;
  // this thread's fragment offsets, the same in every chunk: R~ at row g
  // (+ 8 tn) and column ib + 8 kk; K~ at row q (+ 8 kk, + 4) and column
  // ih IW + 8 nt + g; v at row q (+ 16 c + 8 kk, + 4) and columns j0, j0 + 8
  int ro[P::NI], ko[P::NI];
#pragma unroll
  for (int x = 0; x < P::NI; ++x) {
    const int i = ib + x * 8, ik = ih * P::IW + x * 8 + g;
    ro[x] = g * HD + fpos<32>(g, i);
    ko[x] = q * P::RKF + fpos<P::RKF / P::NH>(q, ik);
  }
  const int v0 = vix<T, HD>(q, j0), v8 = vix<T, HD>(q, j0 + 8);
  // this CTA's slice of the state's elements (in fragment order) for the
  // fold of step 4, two per thread and pass; the fragment slot e belongs
  // to thread e / FR, at row j and columns i, i + 1 of S^T
  constexpr int NE = HD * HD;
  const int per = ((NE + nseg - 1) / nseg + 1) & ~1;
  const int e0 = rank * per + 2 * tid, e_end = min(NE, (rank + 1) * per);
  auto slot = [&](int e, int& j, int& i) {
    const int ot = e / P::FR, f = e % P::FR, ol = ot & 31, ow = ot >> 5;
    j = (ow % P::JB) * 16 + (ol >> 2) + 8 * ((f & 3) >> 1);
    i = (ow / P::JB) * P::IW + (f >> 2) * 8 + 2 * (ol & 3);
  };
  // the carry of the first pair: s0 until the first fold (loaded now, its
  // latency hidden by the copies), then the state past each round
  float cr[2] = {0.0f, 0.0f};
  if (e0 < e_end) {
    int j, i;
    slot(e0, j, i);
    cr[0] = s0[sbase + size_t(i) * HD + j];
    cr[1] = s0[sbase + size_t(i + 1) * HD + j];
  }

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int seg0 = (rnd * nseg + rank) * seg_len;
    const int len = max(0, min(seg_len, S - seg0));
    const int nch = (len + C - 1) / C;
    const bool last_round = rnd == rounds - 1;
    __syncthreads();  // the previous round's tiles and A are consumed

    // 1. warp c copies chunk c and prepares it alone: L, A, R~, K~ (a
    // chunk past the segment is zero-filled and comes out zero)
    const int c = warp;
    {
      constexpr int XR = P::CPR, XL = HD / 4;  // 16-byte chunks per row
      for (int x = lane; x < C * (3 * XR + XL); x += 32) {
        const int row = x / (3 * XR + XL), col = x % (3 * XR + XL);
        const int t = c * C + row;
        const bool ok = t < len;
        const size_t tok =
            (static_cast<size_t>(b) * S + seg0 + (ok ? t : 0)) * H + h;
        if (col < 2 * XR) {
          const int which = col / XR, ch = (col % XR) * P::EPC;
          cp_async16(rk + t * P::RKT + (which ? kpos(ch) : rpos(ch)),
                     (which ? k : r) + tok * HD + ch, ok);
        } else if (col < 3 * XR) {
          const int ch = (col - 2 * XR) * P::EPC;
          cp_async16(vs + vix<T, HD>(t, ch), v + tok * HD + ch, ok);
        } else {
          const int ch = (col - 3 * XR) * 4;
          cp_async16(Ls + t * HD + ch, ld + tok * HD + ch, ok);
        }
      }
      cp_async_wait_all();
      __syncwarp();
      const T* rr = rk + c * C * P::RKT;
      float* Lc_ = Ls + c * C * HD;
      // inclusive cumulative log-decay of each channel over the chunk
#pragma unroll
      for (int hh = 0; hh < P::NH; ++hh) {
        const int i = hh * 32 + lane;
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          acc += Lc_[t * HD + i];
          Lc_[t * HD + i] = acc;
        }
      }
      // A, 32 entries at a time, each summed over the channels by the
      // lanes; every exponent a difference L[x] - L[y] with x <= y
      auto Lx = [&](int t, int i) { return t ? Lc_[(t - 1) * HD + i] : 0.0f; };
      auto rv = [&](int t, int i) { return to_float(rr[t * P::RKT + rpos(i)]); };
      auto kv = [&](int t, int i) { return to_float(rr[t * P::RKT + kpos(i)]); };
      float* Ac = Ab + c * C * P::RA;
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {  // pairs inside sub-block sb, exact
        float a[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) a[e] = 0.0f;
#pragma unroll
        for (int hh = 0; hh < P::NH; ++hh) {
          const int i = hh * 32 + lane;
          float rx[SB], kx[SB], lx[SB], lc[SB];
#pragma unroll
          for (int x = 0; x < SB; ++x) {
            rx[x] = rv(sb * SB + x, i);
            kx[x] = kv(sb * SB + x, i);
            lx[x] = Lx(sb * SB + x, i);
            lc[x] = Lc_[(sb * SB + x) * HD + i];
          }
#pragma unroll
          for (int t = 1; t < SB; ++t)
#pragma unroll
            for (int s = 0; s < t; ++s)  // exp(L[t-1] - L[t-1]) = 1
              a[t * (t - 1) / 2 + s] =
                  fmaf(rx[t] * kx[s], s == t - 1 ? 1.0f : expf(lx[t] - lc[s]),
                       a[t * (t - 1) / 2 + s]);
#pragma unroll
          for (int x = 0; x < 4; ++x)  // the bonus of tokens 0..3 of sb
            a[28 + x] = fmaf(rx[x] * us[i], kx[x], a[28 + x]);
        }
        ReduceScatter<32, 16>::run(a, lane);
        int t, s;
        if (lane < 28) {
          t = 1;
          s = lane;
          while (s >= t) {
            s -= t;
            ++t;
          }
        } else {
          t = s = lane - 28;
        }
        Ac[(sb * SB + t) * P::RA + sb * SB + s] = a[0];
      }
#pragma unroll
      for (int th = 0; th < 2; ++th) {  // t in 8 + 4 th .., s in 0..7
        float a[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) a[e] = 0.0f;
#pragma unroll
        for (int hh = 0; hh < P::NH; ++hh) {
          const int i = hh * 32 + lane;
          const float Lr = Lc_[(SB - 1) * HD + i];  // L_ref
          float kh[SB];
#pragma unroll
          for (int s = 0; s < SB; ++s)
            kh[s] = kv(s, i) * expf(Lr - Lc_[s * HD + i]);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = SB + 4 * th + x;
            const float rh = rv(t, i) * expf(Lx(t, i) - Lr);
#pragma unroll
            for (int s = 0; s < SB; ++s)
              a[x * SB + s] = fmaf(rh, kh[s], a[x * SB + s]);
          }
        }
        ReduceScatter<32, 16>::run(a, lane);
        Ac[(SB + 4 * th + lane / SB) * P::RA + lane % SB] = a[0];
      }
      {  // the bonus of tokens 4..7 and 12..15
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = 0.0f;
#pragma unroll
        for (int hh = 0; hh < P::NH; ++hh) {
          const int i = hh * 32 + lane;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int t = x < 4 ? 4 + x : 8 + x;
            a[x] = fmaf(rv(t, i) * us[i], kv(t, i), a[x]);
          }
        }
        ReduceScatter<8, 16>::run(a, lane);
        if ((lane & 3) == 0) {
          const int x = lane >> 2, t = x < 4 ? 4 + x : 8 + x;
          Ac[t * P::RA + t] = a[0];
        }
      }
      // R~ = r exp(Lx) over L, K~ = k exp(Lc - L) over r|k, in place, one
      // half of the channels at a time
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < P::NH; ++hh) {
        const int i = hh * 32 + lane;
        float rx[C], kx[C];
        const float Lend = Lc_[(C - 1) * HD + i];
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const float Lt = Lc_[t * HD + i];
          rx[t] = rv(t, i) * expf(Lx(t, i));
          kx[t] = kv(t, i) * expf(Lend - Lt);
        }
        ecs[c * HD + i] = expf(Lend);
        __syncwarp();
        float* kc = kt + c * C * P::RKF;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          Lc_[t * HD + fpos<32>(t, i)] = rx[t];
          kc[t * P::RKF + fpos<P::RKF / P::NH>(t, i)] = kx[t];
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 2. the decay after each chunk, Ea[c] = prod_{c' > c} exp(Lc'), and
    // the segment's, E = prod_c exp(Lc)
    for (int i = tid; i < HD; i += NT) {
      float x = 1.0f;
      for (int cc = nch - 1; cc >= 0; --cc) {
        eas[cc * HD + i] = x;
        x *= ecs[cc * HD + i];
      }
      elx[i] = x;
    }
    __syncthreads();

    // 3. the segment's local state from zero, dS^T = sum_c V_c^T (K~_c Ea[c])
    float ds[P::NI][4];
#pragma unroll
    for (int nt = 0; nt < P::NI; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.0f;
    if (!last_round || rank < nseg - 1) {
      for (int cc = 0; cc < nch; ++cc) {
        const float* kc = kt + cc * C * P::RKF;
#pragma unroll
        for (int kk = 0; kk < C / 8; ++kk) {
          const T* vr = vs + (cc * C + kk * 8) * HD;
          AFrag<EXACT_V> va;
          va.set(0, to_float(vr[v0]));
          va.set(1, to_float(vr[v8]));
          va.set(2, to_float(vr[4 * HD + v0]));
          va.set(3, to_float(vr[4 * HD + v8]));
          const float* kr = kc + kk * 8 * P::RKF;
#pragma unroll
          for (int nt = 0; nt < P::NI; ++nt) {
            const float ea = eas[cc * HD + ih * P::IW + nt * 8 + g];
            va.mma3(ds[nt], kr[ko[nt]] * ea, kr[4 * P::RKF + ko[nt]] * ea);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < P::NI; ++nt)
      *reinterpret_cast<float4*>(xd + (tid * P::NI + nt) * 4) =
          make_float4(ds[nt][0], ds[nt][1], ds[nt][2], ds[nt][3]);
    cluster_arrive();
    cluster_wait();

    // 4. the incoming states: this CTA folds its slice of the state's
    // elements over the cluster's segments in rank order,
    // s <- s E_p + dS_p, and writes each CTA's incoming value in place of
    // the dS it read there
    {
      for (int e = e0; e < e_end; e += 2 * NT) {
        int j, i;
        slot(e, j, i);
        float2 d[MAX_SEG], ep[MAX_SEG];
#pragma unroll
        for (int p = 0; p < MAX_SEG; ++p) {
          if (p < nseg) {
            d[p] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(xd, p) + e);
            ep[p] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(elx, p) + i);
          }
        }
        float2 x;
        if (e == e0) {
          x = make_float2(cr[0], cr[1]);
        } else {  // a later pass: one round covers the sequence
          x.x = s0[sbase + size_t(i) * HD + j];
          x.y = s0[sbase + size_t(i + 1) * HD + j];
        }
#pragma unroll
        for (int p = 0; p < MAX_SEG; ++p) {
          if (p < nseg) {
            *reinterpret_cast<float2*>(cluster.map_shared_rank(xd, p) + e) =
                x;
            x.x = fmaf(x.x, ep[p].x, d[p].x);
            x.y = fmaf(x.y, ep[p].y, d[p].y);
          }
        }
        if (e == e0) {
          cr[0] = x.x;
          cr[1] = x.y;
        }
      }
    }
    cluster_arrive();
    cluster_wait();
    float st[P::NI][4];  // S^T fragments
#pragma unroll
    for (int nt = 0; nt < P::NI; ++nt) {
      const float4 x =
          *reinterpret_cast<const float4*>(xd + (tid * P::NI + nt) * 4);
      st[nt][0] = x.x;
      st[nt][1] = x.y;
      st[nt][2] = x.z;
      st[nt][3] = x.w;
    }
    __syncthreads();  // the exchange area now holds partial read-outs

    // 5. outputs from the incoming state, chunk by chunk
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      if (cc >= nch) break;
      const int n = min(C, len - cc * C);
      const float* rc = Ls + cc * C * HD;
      const float* kc = kt + cc * C * P::RKF;
      const float* ec = ecs + cc * HD;
      const float* Ac = Ab + cc * C * P::RA;
      float oa[2][4];  // o^T: (j0, 2q), (j0, 2q+1), (j0+8, 2q), (j0+8, 2q+1)
#pragma unroll
      for (int tn = 0; tn < 2; ++tn)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[tn][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < P::NI; ++kk) {
        AFrag<false> sa;  // k order 2q, 2q + 1 within the 8-wide step
        sa.set(0, st[kk][0]);
        sa.set(1, st[kk][2]);
        sa.set(2, st[kk][1]);
        sa.set(3, st[kk][3]);
#pragma unroll
        for (int tn = 0; tn < 2; ++tn) {
          const float2 rr2 =
              *reinterpret_cast<const float2*>(rc + tn * 8 * HD + ro[kk]);
          sa.mma3(oa[tn], rr2.x, rr2.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < P::NI; ++nt) {
        const float e0 = ec[ib + nt * 8], e1 = ec[ib + nt * 8 + 1];
        st[nt][0] *= e0;
        st[nt][1] *= e1;
        st[nt][2] *= e0;
        st[nt][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < C / 8; ++kk) {
        const int sl = kk * 8 + q;
        const T* vr = vs + (cc * C + kk * 8) * HD;
        AFrag<EXACT_V> va;
        va.set(0, to_float(vr[v0]));
        va.set(1, to_float(vr[v8]));
        va.set(2, to_float(vr[4 * HD + v0]));
        va.set(3, to_float(vr[4 * HD + v8]));
        if (ih == P::IS - 1) {  // the intra-chunk terms, once per row block
#pragma unroll
          for (int tn = 0; tn < 2; ++tn)
            va.mma3(oa[tn], Ac[(tn * 8 + g) * P::RA + sl],
                    Ac[(tn * 8 + g) * P::RA + sl + 4]);
        }
        const float* kr = kc + kk * 8 * P::RKF;
#pragma unroll
        for (int nt = 0; nt < P::NI; ++nt)
          va.mma3(st[nt], kr[ko[nt]], kr[4 * P::RKF + ko[nt]]);
      }
      float* pb = xd + (cc & 1) * (P::PB / 2);
      if (ih > 0) {
#pragma unroll
        for (int tn = 0; tn < 2; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pb[((ih - 1) * C + tn * 8 + 2 * q + (e & 1)) * P::RP + j0 +
               8 * (e >> 1)] = oa[tn][e];
      }
      __syncthreads();
      if (ih == 0) {
#pragma unroll
        for (int tn = 0; tn < 2; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = tn * 8 + 2 * q + (e & 1), j = j0 + 8 * (e >> 1);
            float val = oa[tn][e];
#pragma unroll
            for (int w = 0; w < P::IS - 1; ++w)
              val += pb[(w * C + t) * P::RP + j];
            if (t < n)
              o[((static_cast<size_t>(b) * S + seg0 + cc * C + t) * H + h) *
                    HD +
                j] = val;
          }
      }
    }
    if (last_round && rank == nseg - 1) {
#pragma unroll
      for (int nt = 0; nt < P::NI; ++nt) {
        const int i0 = ib + nt * 8;
        s_out[sbase + size_t(i0) * HD + j0] = st[nt][0];
        s_out[sbase + size_t(i0 + 1) * HD + j0] = st[nt][1];
        s_out[sbase + size_t(i0) * HD + j0 + 8] = st[nt][2];
        s_out[sbase + size_t(i0 + 1) * HD + j0 + 8] = st[nt][3];
      }
    }
  }
}

// --- the decode step (S = 1) ------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ld,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ s_out, int H) {
  constexpr int CPR = HD / 4;      // float4 columns of a state row
  constexpr int RPP = NT / CPR;    // rows per pass
  constexpr int RPT = HD / RPP;    // rows per thread
  constexpr int GPW = 32 / CPR;    // row groups per warp
  __shared__ float rs[HD], ks[HD], ws[HD];
  __shared__ float4 red[NW][CPR];

  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c4 = tid % CPR, r0 = tid / CPR;
  const size_t x0 = static_cast<size_t>(bh) * HD;  // token (b, 0, h)
  const size_t sb = x0 * HD;
  float4 sv[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    sv[m] = *reinterpret_cast<const float4*>(s0 + sb +
                                             size_t(r0 + m * RPP) * HD +
                                             c4 * 4);
  for (int i = tid; i < HD; i += NT) {
    rs[i] = to_float(r[x0 + i]);
    ks[i] = to_float(k[x0 + i]);
    ws[i] = expf(ld[x0 + i]);
  }
  // the bonus sum_i r u k, in every warp
  float bonus = 0.0f;
  for (int i = lane; i < HD; i += 32)
    bonus = fmaf(to_float(r[x0 + i]) * u[h * HD + i], to_float(k[x0 + i]),
                 bonus);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
  const float4 vv = make_float4(
      to_float(v[x0 + c4 * 4]), to_float(v[x0 + c4 * 4 + 1]),
      to_float(v[x0 + c4 * 4 + 2]), to_float(v[x0 + c4 * 4 + 3]));
  __syncthreads();

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = r0 + m * RPP;
    const float ri = rs[i], ki = ks[i], wi = ws[i];
    acc.x = fmaf(ri, sv[m].x, acc.x);
    acc.y = fmaf(ri, sv[m].y, acc.y);
    acc.z = fmaf(ri, sv[m].z, acc.z);
    acc.w = fmaf(ri, sv[m].w, acc.w);
    const float4 sn = make_float4(fmaf(wi, sv[m].x, ki * vv.x),
                                  fmaf(wi, sv[m].y, ki * vv.y),
                                  fmaf(wi, sv[m].z, ki * vv.z),
                                  fmaf(wi, sv[m].w, ki * vv.w));
    *reinterpret_cast<float4*>(s_out + sb + size_t(i) * HD + c4 * 4) = sn;
  }
#pragma unroll
  for (int off = CPR; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  static_assert(GPW >= 1, "a state row fits in a warp");
  if (lane < CPR) red[warp][lane] = acc;
  __syncthreads();
  if (tid < CPR) {
    float4 a = red[0][tid];
    for (int w = 1; w < NW; ++w) {
      a.x += red[w][tid].x;
      a.y += red[w][tid].y;
      a.z += red[w][tid].z;
      a.w += red[w][tid].w;
    }
    a.x = fmaf(bonus, vv.x, a.x);
    a.y = fmaf(bonus, vv.y, a.y);
    a.z = fmaf(bonus, vv.z, a.z);
    a.w = fmaf(bonus, vv.w, a.w);
    *reinterpret_cast<float4*>(o + x0 + tid * 4) = a;
  }
}

template <typename T, int HD>
int launch_shape(const void* r, const void* k, const void* v,
                 const float* ld, const float* u, const float* s0, float* o,
                 float* s_out, int B, int S, int H, int nseg, int seg_len,
                 cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if (S == 1) {
    wkv6_step_kernel<T, HD><<<B * H, NT, 0, stream>>>(rp, kp, vp, ld, u, s0,
                                                      o, s_out, H);
    return static_cast<int>(cudaGetLastError());
  }
  const int rounds = (S + nseg * seg_len - 1) / (nseg * seg_len);
  // past one round, each thread carries one pair of its CTA's slice
  if (rounds > 1 && ((HD * HD + nseg - 1) / nseg + 1) / 2 > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wkv6_seq_kernel<T, HD>;
  const size_t bytes = Plan<T, HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nseg) * B * H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nseg);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, rp, kp, vp, ld, u, s0, o, s_out, S,
                           H, nseg, seg_len, rounds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v,
                 const float* ld, const float* u, const float* s0, float* o,
                 float* s_out, int B, int S, int H, int HD, int nseg,
                 int seg_len, cudaStream_t stream) {
  switch (HD) {
    case 32:
      return launch_shape<T, 32>(r, k, v, ld, u, s0, o, s_out, B, S, H, nseg,
                                 seg_len, stream);
    case 64:
      return launch_shape<T, 64>(r, k, v, ld, u, s0, o, s_out, B, S, H, nseg,
                                 seg_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v (B, S, H, HD) bf16 (is_bf16) or fp32; ld (B, S, H, HD), u (H, HD)
// and s0 (B, H, HD, HD) fp32; all contiguous. Writes o (B, S, H, HD) and
// s_out (B, H, HD, HD) in fp32 (s_out must not alias s0). nseg segments
// of seg_len tokens per round (a multiple of 16, at most 128; nseg at most
// 8), as many rounds as cover S; S = 1 takes the decode step. One launch
// on `stream`; returns the CUDA error, or 0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const float* ld, const float* u, const float* s0,
                    float* o, float* s_out, int B, int S, int H, int HD,
                    int is_bf16, int nseg, int seg_len, void* stream) {
  if (B < 1 || S < 1 || H < 1 || nseg < 1 || nseg > MAX_SEG ||
      seg_len < C || seg_len > TS || seg_len % C != 0 ||
      static_cast<long long>(nseg) * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_typed<__nv_bfloat16>(r, k, v, ld, u, s0, o, s_out,
                                               B, S, H, HD, nseg, seg_len,
                                               st)
                 : launch_typed<float>(r, k, v, ld, u, s0, o, s_out, B, S, H,
                                       HD, nseg, seg_len, st);
}

// dynamic shared memory of wkv6_seq_kernel for a head size and type
extern "C" int wkv6_smem_bytes(int HD, int is_bf16) {
  if (HD == 32)
    return static_cast<int>(is_bf16 ? Plan<__nv_bfloat16, 32>::BYTES
                                    : Plan<float, 32>::BYTES);
  if (HD == 64)
    return static_cast<int>(is_bf16 ? Plan<__nv_bfloat16, 64>::BYTES
                                    : Plan<float, 64>::BYTES);
  return -1;
}
