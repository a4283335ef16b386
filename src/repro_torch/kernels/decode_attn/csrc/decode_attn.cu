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
// a value, still far below the bytes). On olmoe-1b-7b's (B=16, KV=16, G=1,
// hd=128, pos=1087) bf16 cache: 142.6 MB, 42.6 us; on moonshot-v1-16b-a3b's
// int8 one (the same shape): 73.5 MB, 21.9 us; on seamless-m4t-large-v2's
// (hd=64, the same B, KV, G and pos): 71.3 MB, 21.3 us, and over its cross
// caches (S=1024, pos=1023): 67.1 MB, 20.0 us. On jamba-1.5-large-398b's
// (B=16, KV=8, G=8, hd=128, pos=1087) bf16 cache: 71.3 MB, 21.3 us; its
// 16 operations a cache value are still far below the tensor cores' ~295
// a byte. What bounds the int8 body
// in practice is instruction issue: an exact dequantize takes ~3.75
// instructions a value, so moonshot's 71 M values a call are ~8 M warp
// instructions, about a third of the card's issue over the bytes' time.
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
// 2. A pipelined read of the cache as it is stored: a ring of tiles of K
//    and V in shared memory, in the cache's own type, filled by 16-byte
//    cp.async.cg copies. The whole ring is in flight before the first tile
//    is consumed, and each slot is refilled as soon as every warp is done
//    with it: one __syncthreads per tile, the only block-wide wait in the
//    loop.
// 3. Warps that do not wait for each other inside the loop: each warp takes
//    its own positions of every tile and keeps its own online softmax (m,
//    l, accumulator) for all G query rows. The warps merge once, after the
//    split, with the same log-sum-exp weights as the merge across splits.
// 4. A bf16 or fp32 cache (but 6b's and 6c's instantiations): a ring of
//    NSTAGE tiles of about 4 KB of K in static shared memory. The lanes of a
//    warp split each position's channels and q (pre-scaled) lives in
//    registers; bf16 is widened to fp32 in registers where it is used.
//    At hd 32, 64 and 128 a lane reads 16 (or 8) bytes of a row, so the
//    unpadded rows of a tile are read without bank conflicts (at hd 128
//    16 or 32 lanes share a position, and a tile holds 16 or 8
//    positions); at hd 80 (5 x 16 channels) 8 or 16 lanes share a
//    position, 10 or 5 channels a lane, read in 8-, 4- or 2-byte pieces.
//    G is a template parameter (1..8), as hd is (32, 64, 80, 128): the
//    channels of a lane shrink as G grows, so q and the accumulator stay
//    within about 2 x QA_REGS registers.
// 5. The int8 cache (walk_int8): the dequantize is most of the work (89 M
//    values a call on stablelm's path), so it stays off the conversion
//    pipe, which issues 16 results a clock per SM against 64 to 128 for
//    integer and fp32 arithmetic. An int8 value becomes fp32 by a byte
//    permute into the mantissa of 2^23 and one subtraction; the product
//    with the position's scale (__fmul_rn, as torch's fp32 multiply) is
//    rounded to bf16 two values at a time by one cvt.rn.bf16x2.f32 (round
//    to nearest even, as torch's cast), so each value is bit for bit
//    cache_read(c, T). A block takes kvg = 4 (or 2) KV heads of one b
//    where they divide KV: their rows lie together in the cache (320
//    bytes a position at hd 80, where one head's 80 bytes straddle 32-byte
//    sectors), and the grid runs over the row groups first, so that the
//    groups of one b read the same stretch of the cache together. A tile
//    holds Q8_TP = 128 (position, head) rows, a warp taking 32 positions
//    of one head; a ring of Q8_NSTAGE = 2 tiles in dynamic shared memory
//    (43 KB at hd 80: four blocks an SM; 69 KB at hd 128: three) with the
//    scales beside them by 4-byte cp.async.ca copies. q.k takes a lane per
//    position: the lane reads its row as 16-byte chunks and q from shared
//    memory (one address for the whole warp); the row's chunks are
//    permuted where a row holds an even number of them, so the lanes of a
//    quarter-warp hit distinct banks. p.v takes the lane's own row too
//    where its G x HD accumulators fit in registers (G 1 up to hd 80),
//    summed over the warp's lanes once, after the split; else lanes on
//    channels: lane = slot x chunk (32 / chunks slots; at hd 80 6 slots of
//    5 chunks, 2 lanes idle), each slot a position of the warp at a time,
//    its weights shuffled from the lane that scored it. No read of the
//    int8 rows is narrower than 16 bytes. At hd 128 and G > 4 (an fp32 q)
//    the 16 G accumulators of a lane reach the 255-register limit: there
//    the loops over copies, q.k chunks and p.v passes stay rolled (TIGHT).
// 6. The int8 cache with a bf16 q at hd 64 and 128 (MMA_BODY:
//    moonshot-v1-16b-a3b's path, llama-3.2-vision-90b's G 8, smollm's int8
//    shape): walk_int8_mma, the same dequantize straight into mma.sync
//    m16n8k16 fragments, both products on the tensor cores (bf16
//    operands, exact for the dequantized values and for q; P as bf16 hi +
//    lo, two columns of one product, or at G > 4 two rows of P as the A
//    operand; fp32 sums), so no FMA, widening or weight shuffle a value.
//    Its own tiles (MmaPlan): 16 positions of one head a warp, a ring of 4
//    tiles (17 KB each at hd 128, three blocks an SM); at G > 4 8 warps a
//    block, one KV head, a ring of 3 tiles of 34 KB, one block an SM. Its
//    splits spread positions 0..pos evenly over the launch's nsplit, which
//    the wrapper sizes to two blocks an SM (one at G > 4): one wave of long
//    blocks whatever pos is.
// 6b. The bf16 cache with a bf16 q at hd 64 and 128 and G 5..8
//    (BF16_MMA_BODY: jamba-1.5-large-398b's attention layer, G 8 at hd
//    128): walk_bf16_mma, walk_int8_mma's structure at G > 4 without a
//    dequantize. At G 8 the CUDA-core body's lanes split each position's
//    channels (4 a lane at hd 128), so a score took 5 shuffle rounds and
//    the products 40 shuffles a position and warp, more issue than the
//    bytes' time. Here both products run as mma.sync m16n8k16 (bf16
//    operands, fp32 sums): q.k as S (G x 8 positions) += Q (G x 16
//    channels) K^T, Q's fragments in registers (rows G.. zero); p.v as O
//    += P V, P as the A operand as it lies in q.k's accumulators (rows g
//    head g's bf16 hi, rows g + 8 its lo). K and V stay bf16 in shared
//    memory and reach the fragments by ldmatrix (K) and ldmatrix.trans
//    (V as the B operand); each row's 16-byte chunks are swizzled (chunk
//    c of row p at c ^ (p & 7)), so the 8 rows of an 8x8 matrix, and the
//    copies' 8 consecutive chunks, hit 8 distinct bank groups. Its own
//    tiles (Bf16MmaPlan): 16 positions of one KV head a warp, 4 warps a
//    block, a ring of 6 tiles of 32 KB at hd 128 (one block an SM, five
//    tiles in flight); its splits spread 0..pos as walk_int8_mma's, one
//    a row at jamba's shape (tools/decode_attn_splits.py: 4 or 8 warps,
//    rings of 2, 3 or 6 tiles and 1 to 4 splits a row; one split of one
//    block an SM was fastest, 4 warps and 6 tiles by 1-2%).
// 6c. The bf16 cache with a bf16 q at hd 64 and 128 and G 1 (BF16_MMA_BODY
//    too: seamless-m4t-large-v2's self and cross layers at hd 64,
//    olmoe-1b-7b's at hd 128): walk_bf16_mma at G 1, q in row 0 of Q's
//    fragment, so no score moves between lanes (the CUDA-core body took 3
//    or 4 shuffle rounds a score). Its ring is 96 KB (6 tiles at hd 64, 3
//    at hd 128) so that two blocks share an SM, one block's ramp and
//    epilogue beside the other's loads; its splits spread 0..pos as
//    walk_int8_mma's, one a row at those models' B*KV = 256 rows on 264
//    slots, so each block writes its row with no merge across blocks.
// 7. The grid and the scratch depend on (B*KV, S) and the cache's type
//    only, never on pos: the wrapper's split plan is a function of them. A
//    block whose split starts after pos leaves at once, and the merge
//    covers the splits that hold a position <= pos only. Masked positions
//    are never loaded (the last tile's rows past pos are zero-filled by
//    cp.async without a read). A device pos outside 0..S-1 cannot be
//    raised without a synchronise, so the kernel writes NaN to every
//    output of the call instead.
// Numerics: fp32 throughout, no fast math; scores in log2 units (q scaled
// by log2(e) / sqrt(hd), exp2f; the tensor-core bodies scale q.k's fp32
// sums instead); the result differs from the plain version (fp32 einsum
// and softmax over all of S) in rounding and summation order, and in the
// tensor-core bodies by P's hi + lo split (to 2^-17 of a weight), only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int NW = 4;  // warps of a block
constexpr int NT = 32 * NW;
constexpr int NSTAGE = 3;         // tiles of the ring (bf16, fp32 caches)
constexpr int TILE_BYTES = 4096;  // bytes of K in a tile (as many of V)
constexpr int QA_REGS = 32;       // G x a lane's channels, at most
constexpr int MAX_GROUP = 8;
constexpr int MERGE_GROUP = 8;   // splits merged per round of loads
constexpr int MAX_ROWS = 65535;  // B * KV: grid.y, and the tickets
constexpr int MAX_TILE = 64;     // positions: the wrapper's split alignment
constexpr int Q8_TP = 32 * NW;   // int8 cache: positions of a tile
constexpr int Q8_NSTAGE = 2;     // int8 cache: tiles of the ring
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ unsigned int g_tickets[MAX_ROWS];

template <typename E>
constexpr bool IS_INT8 = std::is_same<E, int8_t>::value;

constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// channels of a lane, for cache elements of ES bytes. hd 32, 64, 128: 16
// bytes of a row, halved until G * CL is within QA_REGS; a quarter-warp
// then reads 128 contiguous bytes of a tile (a half-warp with 8-byte
// reads), so unpadded rows do not conflict. hd 80: 10 (8 lanes a
// position), or 5 (16 lanes) where G * 10 would pass QA_REGS
constexpr int lane_channels(int HD, int ES, int G) {
  if (HD % 5 == 0) return G * 10 <= QA_REGS ? 10 : 5;
  int cl = 16 / ES;
  while (G * cl > QA_REGS) cl /= 2;
  return cl;
}

// the bf16 or fp32 cache's tiles; T: q's type, the cache's and the
// compute type's source
template <typename T, int HD, int G>
struct Plan {
  static constexpr int ES = sizeof(T);
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
  static constexpr int STAGE = 2 * TP * RB;  // K, V
  static constexpr int SMEM = NSTAGE * STAGE;
  static_assert(HD % CL == 0 && NS <= 32 && 32 % NS == 0,
                "lanes per position");
  static_assert(RB % 16 == 0, "16-byte row copies");
  static_assert(NW * G * (HD + 2) * 4 <= SMEM, "merge area fits the ring");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

// the int8 cache's tiles (walk_int8)
template <int HD, int G>
struct Q8Plan {
  static constexpr int CPR = HD / 16;   // 16-byte chunks of a row
  static constexpr int ROWS = Q8_TP * HD;  // bytes of K (of V) in a tile
  static constexpr int STAGE = 2 * ROWS + 2 * 4 * Q8_TP;  // K, V, scales
  static constexpr int RING = Q8_NSTAGE * STAGE;
  static constexpr int SMEM = RING + 4 * NW * G * HD;  // then q, kvg rows
  static constexpr int CHAINS = G == 1 ? 4 : G == 2 ? 2 : 1;  // q.k sums
  // the warps' states after the loop, at the ring's start (floats)
  static constexpr int MERGE = NW * G * (HD + 2);
  // p.v: a lane per position, its own G x HD accumulators summed over
  // the warp once, after the loop (through shared memory, rows padded to
  // an odd stride), where they fit; else lanes on 16-byte chunks: lane =
  // slot x chunk, LPV slots each a position at a time
  static constexpr int RED = G * HD + 1;  // a lane's row of the sum
  static constexpr bool ROW_PV =
      G * HD <= 80 && 4 * (MERGE + NW * 32 * RED) <= RING;
  static constexpr int LPV = 32 / CPR;
  static constexpr int NPASS = (32 + LPV - 1) / LPV;  // over 32 positions
  static_assert(HD % 16 == 0 && CPR <= 8 &&
                    (CPR % 2 == 1 || (CPR & (CPR - 1)) == 0),
                "rows of 16-byte chunks, an odd number or a power of two");
  static_assert(Q8_TP == NT, "a position a thread in a tile's copies");
  static_assert(4 * MERGE <= RING, "merge area fits the ring");
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory of a block");
};

// walk_int8_mma at G > 4: the tiles of its ring and the warps of a block
// (macros only so that tools/decode_attn_splits.py can build the variants
// it sweeps)
#ifndef DECODE_ATTN_WIDE_NSTAGE
#define DECODE_ATTN_WIDE_NSTAGE 3
#endif
#ifndef DECODE_ATTN_WIDE_WARPS
#define DECODE_ATTN_WIDE_WARPS 8
#endif

// walk_int8_mma's tiles: WP positions of one head a warp, TP (position,
// head) rows a tile for W warps, a ring of NS tiles in dynamic shared
// memory
template <int HD, int NS = 4, int W = NW>
struct MmaPlan {
  static constexpr int WP = 16;
  static constexpr int BT = 32 * W;  // threads of a block
  static constexpr int TP = W * WP;
  static constexpr int NSTAGE = NS;
  static constexpr int CPR = HD / 16;         // 16-byte chunks of a row
  static constexpr int ROWS = TP * HD;        // bytes of K (of V) a tile
  static constexpr int STAGE = 2 * ROWS + 2 * 4 * TP;  // K, V, scales
  static constexpr int SMEM = NSTAGE * STAGE;
  static constexpr int NCOPY = TP * CPR / BT;  // a thread's chunks of K
  static_assert(WP % 16 == 0 && TP <= BT && (TP * CPR) % BT == 0 &&
                    NSTAGE >= 2,
                "whole k-steps, a scale a thread, whole copies, a ring");
  static_assert(4 * W * MAX_GROUP * (HD + 2) <= SMEM,
                "merge area fits the ring");
};

// The int8 cache's body on the tensor cores (walk_int8_mma): bf16 q at hd
// 64 and 128, any G (moonshot-v1-16b-a3b's hd 128, G 1; smollm's hd 64,
// G 3; llama-3.2-vision-90b's hd 128, G 8). Every other int8
// instantiation keeps walk_int8.
template <typename T, int HD, int G>
constexpr bool MMA_BODY = std::is_same<T, __nv_bfloat16>::value &&
                          (HD == 64 || HD == 128);

// walk_int8_mma's ring: 4 tiles, DECODE_ATTN_WIDE_NSTAGE at G > 4; and
// its warps: NW, DECODE_ATTN_WIDE_WARPS at G > 4
template <int G>
constexpr int MMA_STAGES = G > 4 ? DECODE_ATTN_WIDE_NSTAGE : 4;
template <int G>
constexpr int MMA_WARPS = G > 4 ? DECODE_ATTN_WIDE_WARPS : NW;

// walk_bf16_mma: the tiles of its ring past G 4, and at G 1 at hd 64 and
// 128, and the warps of a block (macros only so that
// tools/decode_attn_splits.py can build the variants it sweeps)
#ifndef DECODE_ATTN_BF16_NSTAGE
#define DECODE_ATTN_BF16_NSTAGE 6
#endif
#ifndef DECODE_ATTN_BF16_G1_NSTAGE_64
#define DECODE_ATTN_BF16_G1_NSTAGE_64 6
#endif
#ifndef DECODE_ATTN_BF16_G1_NSTAGE_128
#define DECODE_ATTN_BF16_G1_NSTAGE_128 3
#endif
#ifndef DECODE_ATTN_BF16_WARPS
#define DECODE_ATTN_BF16_WARPS 4
#endif

// walk_bf16_mma's tiles: WP positions of one KV head a warp, TP a tile for
// W warps, K's rows then V's, 2 HD bytes a row in 16-byte chunks swizzled
// by bf16_chunk_at, a ring of NS tiles in dynamic shared memory
template <int HD, int NS, int W>
struct Bf16MmaPlan {
  static constexpr int WP = 16;
  static constexpr int BT = 32 * W;  // threads of a block
  static constexpr int TP = W * WP;
  static constexpr int NSTAGE = NS;
  static constexpr int CPR = 2 * HD / 16;      // 16-byte chunks of a row
  static constexpr int ROWS = TP * 2 * HD;     // bytes of K (of V) a tile
  static constexpr int STAGE = 2 * ROWS;       // K, V
  static constexpr int SMEM = NSTAGE * STAGE;
  static constexpr int NCOPY = TP * CPR / BT;  // a thread's chunks of K
  // floats between rows (warp, head) of the warps' accumulators after the
  // loop: 8 past HD, so that a warp's stores of 8 heads' rows spread over
  // the banks (2 wavefronts a float2 store, not 8)
  static constexpr int RS = HD + 8;
  static_assert(CPR % 8 == 0 && (TP * CPR) % BT == 0 && NSTAGE >= 2,
                "swizzled 8-chunk groups, whole copies, a ring");
  static_assert(4 * W * MAX_GROUP * (RS + 2) <= SMEM,
                "merge area fits the ring");
};

// walk_bf16_mma's plan at HD and G: at G 1 a ring of 96 KB, two blocks an
// SM; past G 4 DECODE_ATTN_BF16_NSTAGE tiles (192 KB at hd 128, one)
template <int HD, int G>
using Bf16Plan = Bf16MmaPlan<
    HD,
    (G == 1 ? (HD == 64 ? DECODE_ATTN_BF16_G1_NSTAGE_64
                        : DECODE_ATTN_BF16_G1_NSTAGE_128)
            : DECODE_ATTN_BF16_NSTAGE),
    DECODE_ATTN_BF16_WARPS>;

// The bf16 cache's body on the tensor cores (walk_bf16_mma): q and cache
// bf16 at hd 64 and 128, G 1 (seamless-m4t-large-v2's self and cross
// layers at hd 64, olmoe-1b-7b's at hd 128) and G 5..8
// (jamba-1.5-large-398b's hd 128, G 8). Every other bf16 and fp32
// instantiation keeps the CUDA-core body.
template <typename T, typename E, int HD, int G>
constexpr bool BF16_MMA_BODY = std::is_same<T, __nv_bfloat16>::value &&
                               std::is_same<E, T>::value &&
                               (HD == 64 || HD == 128) && (G == 1 || G > 4);

// threads of a block of decode_attn_kernel<T, E, HD, G>
template <typename T, typename E, int HD, int G>
__host__ __device__ constexpr int block_threads() {
  if constexpr (BF16_MMA_BODY<T, E, HD, G>)
    return 32 * DECODE_ATTN_BF16_WARPS;
  else
    return IS_INT8<E> && MMA_BODY<T, HD, G> ? 32 * MMA_WARPS<G> : NT;
}

// dynamic shared memory of an int8 block: the ring, and q after it for
// walk_int8 (walk_int8_mma keeps q in registers)
template <typename T, int HD, int G>
constexpr int q8_smem() {
  if constexpr (MMA_BODY<T, HD, G>)
    return MmaPlan<HD, MMA_STAGES<G>, MMA_WARPS<G>>::SMEM;
  else
    return Q8Plan<HD, G>::SMEM;
}

// dynamic shared memory of a block: the int8 bodies' and walk_bf16_mma's
// rings; 0 for the CUDA-core body, whose ring is static
template <typename T, typename E, int HD, int G>
constexpr int ring_smem() {
  if constexpr (BF16_MMA_BODY<T, E, HD, G>)
    return Bf16Plan<HD, G>::SMEM;
  else if constexpr (IS_INT8<E>)
    return q8_smem<T, HD, G>();
  else
    return 0;
}

// resident blocks per SM, at least (at most 65536 / (block_threads x
// this) registers a thread). bf16, fp32 caches: 4, or 3 where G > 6, whose
// q and accumulators do not fit 128 registers without spills. int8: 4 (44
// KB of shared memory a block at hd 80), or 2 where G > 2 (16 G
// accumulators a lane, and G q.k sums), but for walk_int8_mma, whose
// fragments do not grow with G: 4, or 8 / W at G > 4 (one block of 8
// warps); and never more blocks than the ring and q (q8_smem) let an SM
// hold: 3 at hd 128, G <= 2 (70 KB a block; 67.6 KB for walk_int8_mma).
// walk_bf16_mma: 8 / W, and no more than its ring lets an SM hold (1 at
// hd 128 with 6 tiles of 32 KB past G 4, 2 with G 1's 96 KB)
constexpr int SM_SMEM = 228 * 1024;      // an SM's, at the largest carveout
constexpr int BLOCK_SMEM_RESERVED = 1024;  // the system's, per block
template <typename T, typename E, int HD, int G>
constexpr int min_blocks() {
  if constexpr (BF16_MMA_BODY<T, E, HD, G>)
    return cmin(8 / DECODE_ATTN_BF16_WARPS,
                SM_SMEM / (ring_smem<T, E, HD, G>() + BLOCK_SMEM_RESERVED));
  else if constexpr (IS_INT8<E> && MMA_BODY<T, HD, G> && G > 4)
    return cmin(8 / MMA_WARPS<G>,
                SM_SMEM / (q8_smem<T, HD, G>() + BLOCK_SMEM_RESERVED));
  else if constexpr (IS_INT8<E>)
    return cmin(G > 2 && !MMA_BODY<T, HD, G> ? 2 : 4,
                SM_SMEM / (q8_smem<T, HD, G>() + BLOCK_SMEM_RESERVED));
  else
    return G > 6 ? 3 : 4;
}

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

template <typename E>
__device__ __forceinline__ float value(E e) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return __bfloat162float(e);
  else
    return e;
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

// the 4 int8 values of w as fp32 without a conversion instruction: each
// byte, biased to 0..255 (xor 0x80), becomes the low mantissa byte of
// 2^23 (a byte permute), and one exact subtraction of 2^23 + 128 leaves it
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __fadd_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 | i)),
                     -8388736.0f);
}

// 16 int8 values read as cache_read(c, T) = T(float(x) * s): the product
// rounded to fp32 (__fmul_rn, never fused), then, for bf16, to nearest
// even by one cvt.rn.bf16x2.f32 for two values and widened back
template <typename T>
__device__ __forceinline__ void dequant16(const uint4& w, float s,
                                          float (&x)[16]) {
  int8x4_to_float(w.x, x);
  int8x4_to_float(w.y, x + 4);
  int8x4_to_float(w.z, x + 8);
  int8x4_to_float(w.w, x + 12);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = __fmul_rn(x[i], s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
      uint32_t bits;
      memcpy(&bits, &h, sizeof bits);
      widen(bits, x[i], x[i + 1]);
    }
  }
}

// byte offset of 16-byte chunk c of row p of an int8 tile: rows of CPR
// chunks, permuted within the row where CPR is even, so that a
// quarter-warp's 8 lanes hit distinct banks reading one chunk of 8
// consecutive rows (q.k) and 8 consecutive chunks (p.v)
template <int CPR>
__device__ __forceinline__ int chunk_at(int p, int c) {
  if constexpr (CPR % 2 == 0) c ^= (p / (8 / CPR)) % CPR;
  return 16 * (p * CPR + c);
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

// One p.v pass of walk_int8's lanes on 16-byte chunks: slot takes
// position j = r LPV + slot of the warp's 32 (w: the weights of the lane
// that scored it), chunk c; weight 0 where j is past 32 or the lane idles
// (its row j % 32 is read all the same: finite, zeros past pos). TIGHT
// (hd 128, G > 4, at the register limit): one weight shuffled at a time.
template <typename T, int HD, int G, bool TIGHT>
__device__ __forceinline__ void q8_pv_pass(int r, int slot, int c,
                                           const float (&w)[G],
                                           const unsigned char* vt,
                                           const float* vsc, int wbase,
                                           float (&acc)[G][16]) {
  using P = Q8Plan<HD, G>;
  const int j = r * P::LPV + slot;
  const bool on = slot < P::LPV && j < 32;
  if constexpr (TIGHT) {
    float x[16];
    dequant16<T>(*reinterpret_cast<const uint4*>(
                     vt + chunk_at<P::CPR>(wbase + j % 32, c)),
                 vsc[wbase + j % 32], x);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float wj = __shfl_sync(FULL, w[g], j % 32);
      wj = on ? wj : 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(wj, x[i], acc[g][i]);
    }
  } else {
    float wj[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wj[g] = __shfl_sync(FULL, w[g], j % 32);
      wj[g] = on ? wj[g] : 0.0f;
    }
    float x[16];
    dequant16<T>(*reinterpret_cast<const uint4*>(
                     vt + chunk_at<P::CPR>(wbase + j % 32, c)),
                 vsc[wbase + j % 32], x);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(wj[g], x[i], acc[g][i]);
  }
}

// Positions begin..end-1 of kvg (1, 2 or 4) consecutive KV heads of
// one b at once: q their kvg x G rows; kb, vb the int8 values at position
// 0 of the first head, ks, vs its scales. A tile holds TP / kvg positions
// of each head, whose rows, kvg x HD bytes a position, lie together in
// the cache: the copies read them whole. Warp w takes head w % kvg,
// positions (w / kvg) x 32 .. + 31 of the tile. Ends with each warp's
// state in smem: accumulators (NW, G, HD), then (m, l) (NW, G, 2), before
// a barrier.
template <typename T, int HD, int G>
__device__ __forceinline__ void walk_int8(const T* __restrict__ q,
                                          const int8_t* __restrict__ kb,
                                          const int8_t* __restrict__ vb,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          int KV, int kvg, int begin, int end,
                                          unsigned char* smem) {
  using P = Q8Plan<HD, G>;
  constexpr int CPR = P::CPR, TP = Q8_TP, NA = P::ROW_PV ? HD : 16;
  // hd 128 at G > 4: 16 G accumulators a lane at the 255-register limit,
  // so the copies, q.k and p.v loops stay rolled and hold no more
  constexpr bool TIGHT = CPR == 8 && G > 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lk = kvg == 4 ? 2 : kvg - 1;  // log2(kvg)
  const int tph = TP >> lk;               // positions of a head in a tile
  const int ntile = (end - begin + tph - 1) / tph;
  const int step = KV * HD;  // between positions (KV * HD * TP < 2^31)
  float* qs = reinterpret_cast<float*>(smem + P::RING);  // (kvg, G, HD)

  // tile t into slot t % Q8_NSTAGE as commit group t (empty past the
  // last): K's rows, V's, head by head, then K's scales and V's, a head's
  // position a thread. Copy j of a thread is chunk e of head hh's row at
  // position p, the same in every tile; consecutive threads read
  // consecutive 16 bytes of the cache.
  auto fetch = [&](int t) {
    if (t < ntile) {
      unsigned char* kt = smem + (t % Q8_NSTAGE) * P::STAGE;
      unsigned char* vt = kt + P::ROWS;
      float* sc = reinterpret_cast<float*>(vt + P::ROWS);
      const int t0 = begin + t * tph, n = end - t0;  // rows of the tile
      const size_t base = static_cast<size_t>(t0) * step;
      auto copy = [&](int j) {  // TP * CPR chunks of K and of V
        const int c = tid + j * NT, e = c % CPR;
        const int p = (c / CPR) >> lk, hh = (c / CPR) & (kvg - 1);
        const size_t off = p < n ? base + p * step + hh * HD + 16 * e : 0;
        const int at = hh * tph * HD + chunk_at<CPR>(p, e);
        cp_async16(kt + at, kb + off, p < n ? 16 : 0);
        cp_async16(vt + at, vb + off, p < n ? 16 : 0);
      };
      if constexpr (TIGHT) {  // offsets recomputed, not held across tiles
#pragma unroll 1
        for (int j = 0; j < CPR; ++j) copy(j);
      } else {
#pragma unroll
        for (int j = 0; j < CPR; ++j) copy(j);
      }
      const int p = tid >> lk, hh = tid & (kvg - 1);
      const size_t off =
          p < n ? static_cast<size_t>(t0 + p) * KV + hh : 0;
      cp_async4(sc + hh * tph + p, ks + off, p < n ? 4 : 0);
      cp_async4(sc + TP + hh * tph + p, vs + off, p < n ? 4 : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < Q8_NSTAGE; ++t) fetch(t);  // the whole ring in flight

  const float qscale = LOG2E / sqrtf(static_cast<float>(HD));
  for (int i = tid; i < kvg * G * HD; i += NT)
    qs[i] = value(q[i]) * qscale;
  float m[G], l[G], acc[G][NA];  // l: this lane's positions' weights
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[g][i] = 0.0f;
  }
  const int h = warp & (kvg - 1);      // this warp's head
  const int wbase = (warp >> lk) * 32;  // its first position of a tile
  const int p = wbase + lane;           // this lane's
  const int hrow = h * tph * HD;        // the head's rows in a tile
  const float* qh = qs + h * G * HD;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<Q8_NSTAGE - 2>();  // as for the bf16 and fp32 cache
    __syncthreads();  // tile t (and q) is in; every warp is done with t - 1
    if (t > 0) fetch(t - 1 + Q8_NSTAGE);
    const int t0 = begin + t * tph;
    if (t0 + wbase >= end) continue;  // the warp's positions lie past pos
    const unsigned char* kt = smem + (t % Q8_NSTAGE) * P::STAGE + hrow;
    const unsigned char* vt = kt + P::ROWS;
    const float* sc = reinterpret_cast<const float*>(
                          smem + (t % Q8_NSTAGE) * P::STAGE + 2 * P::ROWS) +
                      h * tph;  // K's scales of the head; V's at + TP

    // q.k, a lane per position: its row in CPR 16-byte reads, q read from
    // shared memory at one address for the whole warp
    float d[G][P::CHAINS];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int h = 0; h < P::CHAINS; ++h) d[g][h] = 0.0f;
    auto qk_chunk = [&](int e) {
      float x[16];  // zeros past pos
      dequant16<T>(*reinterpret_cast<const uint4*>(kt + chunk_at<CPR>(p, e)),
                   sc[p], x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qv =
            reinterpret_cast<const float4*>(qh + g * HD) + 4 * e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 f = qv[i];
          constexpr int H = P::CHAINS;
          d[g][(4 * i) % H] = fmaf(f.x, x[4 * i], d[g][(4 * i) % H]);
          d[g][(4 * i + 1) % H] =
              fmaf(f.y, x[4 * i + 1], d[g][(4 * i + 1) % H]);
          d[g][(4 * i + 2) % H] =
              fmaf(f.z, x[4 * i + 2], d[g][(4 * i + 2) % H]);
          d[g][(4 * i + 3) % H] =
              fmaf(f.w, x[4 * i + 3], d[g][(4 * i + 3) % H]);
        }
      }
    };
    if constexpr (TIGHT) {  // a chunk at a time
#pragma unroll 1
      for (int e = 0; e < CPR; ++e) qk_chunk(e);
    } else {
#pragma unroll
      for (int e = 0; e < CPR; ++e) qk_chunk(e);
    }
    const bool valid = t0 + p < end;
    float w[G];  // this lane's position's weight
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = d[g][0];
#pragma unroll
      for (int h = 1; h < P::CHAINS; ++h) s += d[g][h];
      s = valid ? s : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      // finite: the warp's first position of the tile is valid
      if (mx > m[g]) {  // the same on every lane
        const float corr = exp2f(m[g] - mx);  // 0 while m is -inf
        m[g] = mx;
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[g][i] *= corr;
      }
      w[g] = exp2f(s - m[g]);  // 0 past pos
      l[g] += w[g];
    }

    if constexpr (P::ROW_PV) {  // p.v on the lane's own row
#pragma unroll
      for (int e = 0; e < CPR; ++e) {
        float x[16];  // zeros past pos
        dequant16<T>(
            *reinterpret_cast<const uint4*>(vt + chunk_at<CPR>(p, e)),
            sc[TP + p], x);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            acc[g][16 * e + i] = fmaf(w[g], x[i], acc[g][16 * e + i]);
      }
    } else {  // lanes on chunks: slot takes positions slot, slot + LPV, ..
      const int c = lane % CPR, slot = lane / CPR;  // slot LPV: idle lanes
      const float* vsc = sc + TP;
      if constexpr (G > 4) {  // one pass at a time: no spills
#pragma unroll 1
        for (int r = 0; r < P::NPASS; ++r)
          q8_pv_pass<T, HD, G, TIGHT>(r, slot, c, w, vt, vsc, wbase, acc);
      } else {
#pragma unroll
        for (int r = 0; r < P::NPASS; ++r)
          q8_pv_pass<T, HD, G, TIGHT>(r, slot, c, w, vt, vsc, wbase, acc);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // the warp's totals: l over its lanes; the accumulators over its lanes
  // (a lane per position) or over its slots (in slot order where the
  // slots are not a power of two)
  float* wacc = reinterpret_cast<float*>(smem);  // (NW, G, HD)
  float* wml = wacc + NW * G * HD;               // (NW, G, 2)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      l[g] += __shfl_xor_sync(FULL, l[g], off);
  }
  if constexpr (P::ROW_PV) {
    float* red = wacc + P::MERGE + warp * 32 * P::RED;  // (32, RED)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < HD; ++i) red[lane * P::RED + g * HD + i] = acc[g][i];
    __syncwarp();
    for (int i = lane; i < G * HD; i += 32) {
      float a = 0.0f;
#pragma unroll 8
      for (int from = 0; from < 32; ++from) a += red[from * P::RED + i];
      wacc[warp * G * HD + i] = a;
    }
  } else {
    const int c = lane % CPR, slot = lane / CPR;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float a = acc[g][i];
        if constexpr (CPR * P::LPV == 32) {
#pragma unroll
          for (int off = CPR; off < 32; off <<= 1)
            a += __shfl_xor_sync(FULL, a, off);
        } else {
#pragma unroll
          for (int s = 1; s < P::LPV; ++s)
            a += __shfl_sync(FULL, acc[g][i], s * CPR + c);
        }
        if (slot == 0) wacc[(warp * G + g) * HD + 16 * c + i] = a;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wml[(warp * G + g) * 2] = m[g];
      wml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
}

// two fp32 values rounded to bf16 (to nearest even, cvt.rn.bf16x2.f32) in
// one register, lo in the low half: an mma fragment's pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t bits;
  memcpy(&bits, &h, sizeof bits);
  return bits;
}

// the 4 int8 values of w times s, rounded to fp32 (__fmul_rn): with
// pack_bf16 after it, cache_read(c, bf16) bit for bit
__device__ __forceinline__ void dequant4(uint32_t w, float s, float (&x)[4]) {
  int8x4_to_float(w, x);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(x[i], s);
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, fp32 sums (the
// PTX fragment layouts: a0..a3 rows g, g + 8 by columns 2t.., 2t + 8..;
// b0, b1 rows 2t.., 2t + 8.. of column g; d rows g, g + 8, columns 2t, 2t
// + 1, for lane 4 g + t)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of row p of walk_int8_mma's V tile: the
// chunks permuted by p & (CPR - 2), so that the 8 lanes of a quarter-warp
// reading chunk r of rows 2t (t = 0..3) hit distinct banks at hd 128 (two
// lanes share a bank at hd 64, whose 64-byte rows leave no room for more)
template <int CPR>
__device__ __forceinline__ int vchunk_at(int p, int c) {
  return 16 * (p * CPR + (c ^ (p & (CPR - 2))));
}

// walk_int8 on the tensor cores (MMA_BODY: bf16 q, hd 64 or 128): the same
// copies of kvg heads' rows, but MmaPlan's tiles, each warp WP = 16
// positions of its head a tile in a ring of 4 (a short tile keeps 167
// registers a thread, three blocks an SM, with the ring deep enough to
// hide the reads; at G > 4 W = 8 warps and a ring of 3), both products as
// mma.sync m16n8k16 (bf16 in, fp32 sums).
// q.k: S (G x 8 positions) += Q (G x 16 channels) K^T, Q unscaled bf16 in
// registers (rows G.. zero), K the dequantized tile; the lane (g, t) that
// reads K row 8 nt + g takes its channels 4 (KS t + j) .. + 3 for k-step
// j, one 4-byte word (the sum over channels does not care which channels
// a k-step holds, as long as Q's fragment holds the same); its scores
// come out times log2(e) / sqrt(HD). p.v: O^T (16 channels x 8) += V^T (16
// channels x 16 positions) P^T, the positions of p.v's k-step the columns
// of q.k's two n-tiles (no exchange of scores), V's rows read in bytes
// HD/8 r .. + HD/8 - 1 by lane (r, t), and P split into bf16 hi + lo in
// columns 2 g and 2 g + 1 (fp32 P to 2^-17; V exact in bf16), added after
// the loop. At G > 4 (PA: llama-3.2-vision-90b's G 8) the 2G columns of
// hi and lo no longer fit one n-tile, and p.v turns around: O (16 x 8
// channels) += P (16 x 16 positions) V, P the A operand taken as it lies
// in q.k's accumulators (rows g: head g's hi, rows g + 8: its lo; lane
// (g, t) holds columns 2t, 2t + 1 of both n-tiles of the k-step), so no
// score moves between lanes and each lane rescales with its own head's
// correction; V the B operand, n-tile n's column c channel BPL c + n, so
// that lane (g, t) reads the same BPL bytes of rows 2t, + 1, + 8, + 9 as
// above, and its HD / 8 n-tiles (64 fp32 sums at hd 128, still within
// 167 registers) hold head g's channels BPL 2t + n and BPL (2t + 1) + n,
// hi and lo rows summed after the loop. Per value: a byte permute, one
// FADD, one FMUL and half a cvt; the FMAs, widening, weight shuffles and
// cross-slot sums of walk_int8's chunked p.v are gone. Ends as walk_int8.
template <int HD, int G>
__device__ __forceinline__ void walk_int8_mma(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kb,
    const int8_t* __restrict__ vb, const float* __restrict__ ks,
    const float* __restrict__ vs, int KV, int kvg, int begin, int end,
    unsigned char* smem) {
  constexpr int W = MMA_WARPS<G>;  // warps of the block
  using M = MmaPlan<HD, MMA_STAGES<G>, W>;
  constexpr int CPR = M::CPR, TP = M::TP, WP = M::WP, NSTAGE = M::NSTAGE;
  constexpr int BT = M::BT;
  constexpr int KS = HD / 16;   // q.k k-steps; a lane's words of a K row
  constexpr int BPL = HD / 8;   // bytes of a V row a lane reads
  constexpr bool PA = G > 4;    // p.v as O += P V
  // p.v's tiles of sums: m-tiles of 16 channels (O^T), or n-tiles of 8 (O)
  constexpr int MT = PA ? HD / 8 : HD / 16;
  constexpr int NTL = WP / 8;   // q.k n-tiles of a warp's positions
  static_assert(G <= 8 && KS % 4 == 0 && BPL % 8 == 0, "walk_int8_mma");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int lk = kvg == 4 ? 2 : kvg - 1;   // log2(kvg)
  const int tph = TP >> lk;                // positions of a head in a tile
  const int ntile = (end - begin + tph - 1) / tph;
  const int step = KV * HD;  // between positions (KV * HD * TP < 2^31)

  // tile tt into slot tt % NSTAGE as commit group tt (empty past the
  // last), as walk_int8's fetch, V's chunks at vchunk_at. Copy j of a
  // thread is chunk ce of head hh's row at position p0 + j (BT / CPR /
  // kvg) of the tile, its offsets hoisted out of the tiles; threads
  // below TP copy the scales of (position, head) row tid
  const int ce = tid % CPR, hh = (tid / CPR) & (kvg - 1);
  const int p0 = (tid / CPR) >> lk, pstep = (BT / CPR) >> lk;
  const int head = hh * tph * HD;
  const int8_t* kth = kb + hh * HD + 16 * ce;
  const int8_t* vth = vb + hh * HD + 16 * ce;
  const int sp = tid >> lk, sh = tid & (kvg - 1);
  auto fetch = [&](int tt) {
    if (tt < ntile) {
      unsigned char* kt = smem + (tt % NSTAGE) * M::STAGE;
      unsigned char* vt = kt + M::ROWS;
      float* sc = reinterpret_cast<float*>(vt + M::ROWS);
      const int t0 = begin + tt * tph, n = end - t0;  // rows of the tile
      const size_t base = static_cast<size_t>(t0) * step;
#pragma unroll
      for (int j = 0; j < M::NCOPY; ++j) {
        const int p = p0 + j * pstep;
        const size_t off = p < n ? base + static_cast<size_t>(p) * step : 0;
        cp_async16(kt + head + chunk_at<CPR>(p, ce), kth + off,
                   p < n ? 16 : 0);
        cp_async16(vt + head + vchunk_at<CPR>(p, ce), vth + off,
                   p < n ? 16 : 0);
      }
      if (tid < TP) {
        const size_t off =
            sp < n ? static_cast<size_t>(t0 + sp) * KV + sh : 0;
        cp_async4(sc + sh * tph + sp, ks + off, sp < n ? 4 : 0);
        cp_async4(sc + TP + sh * tph + sp, vs + off, sp < n ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int tt = 0; tt < NSTAGE; ++tt) fetch(tt);  // the whole ring

  const int h = warp & (kvg - 1);       // this warp's head
  const int wbase = (warp >> lk) * WP;  // its first position of a tile
  const int hrow = h * tph * HD;        // the head's rows in a tile
  // Q's fragments: query head gq's channels 4 (KS t + j) .. + 3 for k-step
  // j (a0 and a2; rows 8.. are zero), as stored
  uint32_t qa[KS][2];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint2 w = make_uint2(0u, 0u);
    if (gq < G)
      w = *reinterpret_cast<const uint2*>(q + (h * G + gq) * HD +
                                          4 * (KS * t + j));
    qa[j][0] = w.x;
    qa[j][1] = w.y;
  }
  const float qscale = LOG2E / sqrtf(static_cast<float>(HD));
  float m = -INFINITY, l = 0.0f;  // head gq's, over this lane's positions
  // O^T: rows of channels, columns 2t, 2t+1; PA: O, rows gq (hi) and gq + 8
  // (lo), columns 2t, 2t + 1
  float o[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;

  for (int tt = 0; tt < ntile; ++tt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile tt is in; every warp is done with tt - 1
    if (tt > 0) fetch(tt - 1 + NSTAGE);
    const int t0 = begin + tt * tph;
    if (t0 + wbase >= end) continue;  // the warp's positions lie past pos
    const unsigned char* kt = smem + (tt % NSTAGE) * M::STAGE + hrow;
    const unsigned char* vt = kt + M::ROWS;
    const float* sc = reinterpret_cast<const float*>(
                          smem + (tt % NSTAGE) * M::STAGE + 2 * M::ROWS) +
                      h * tph;  // K's scales of the head; V's at + TP

    // q.k, n-tiles of 8 positions: lane (gq, t) holds the scores of
    // positions 8 nt + 2t, + 1 for query head gq
    float s[NTL][2];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int p = wbase + 8 * nt + gq;  // the K row this lane reads
      uint32_t kw[KS];
#pragma unroll
      for (int c = 0; c < KS / 4; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            kt + chunk_at<CPR>(p, KS / 4 * t + c));
        kw[4 * c] = w.x;
        kw[4 * c + 1] = w.y;
        kw[4 * c + 2] = w.z;
        kw[4 * c + 3] = w.w;
      }
      const float ksc = sc[p];
      float d[2][4] = {};  // even and odd k-steps: two chains of products
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float x[4];  // zeros past pos
        dequant4(kw[j], ksc, x);
        mma_bf16(d[j & 1], qa[j][0], 0u, qa[j][1], 0u, pack_bf16(x[0], x[1]),
                 pack_bf16(x[2], x[3]));
      }
      s[nt][0] = (d[0][0] + d[1][0]) * qscale;
      s[nt][1] = (d[0][1] + d[1][1]) * qscale;
    }

    // online softmax of head gq over the 4 lanes that hold its scores
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = t0 + wbase + 8 * nt + 2 * t + e < end;
        s[nt][e] = valid ? s[nt][e] : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float mn = fmaxf(m, mx);  // finite: the warp's first position
    const float corr = exp2f(m - mn);  // 0 while m is -inf
    m = mn;
    l *= corr;
    uint32_t hi[NTL], lo[NTL];  // P of positions 8 nt + 2t, + 1: hi, lo
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const float p0 = exp2f(s[nt][0] - mn), p1 = exp2f(s[nt][1] - mn);
      l += p0 + p1;
      hi[nt] = pack_bf16(p0, p1);
      lo[nt] = pack_bf16(p0 - __uint_as_float(hi[nt] << 16),
                         p1 - __uint_as_float(hi[nt] & 0xffff0000u));
    }
    uint32_t pb[NTL];  // P^T's column gq (not PA)
    if constexpr (PA) {
      // the accumulators are head gq's: its correction, this lane's own
      if (__any_sync(FULL, corr != 1.0f)) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] *= corr;
      }
    } else {
      // the accumulators' columns 2t, 2t + 1 are head t's: its correction
      // (1 on every lane once the running maxima settle)
      const float ct = __shfl_sync(FULL, corr, 4 * t);
      if (__any_sync(FULL, ct != 1.0f)) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] *= ct;
      }
      // head gq / 2's hi (gq even) or lo, from the lane that scored it;
      // zero past 2G
      const int src = 4 * (gq >> 1) + t;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const uint32_t a = __shfl_sync(FULL, hi[nt], src);
        const uint32_t b = __shfl_sync(FULL, lo[nt], src);
        pb[nt] = gq < 2 * G ? (gq & 1 ? b : a) : 0u;
      }
    }

    // p.v, k-steps of 16 positions: lane (gq, t) reads bytes BPL gq .. of
    // rows 16 kk + 2t, + 1, + 8, + 9
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      uint32_t vw[4][BPL / 4];
      float vsc[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int p = wbase + 16 * kk + 2 * t + (rr & 1) + 8 * (rr >> 1);
        const unsigned char* at =
            vt + vchunk_at<CPR>(p, BPL * gq / 16) + BPL * gq % 16;
        if constexpr (BPL == 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(at);
          vw[rr][0] = w.x;
          vw[rr][1] = w.y;
          vw[rr][2] = w.z;
          vw[rr][3] = w.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(at);
          vw[rr][0] = w.x;
          vw[rr][1] = w.y;
        }
        vsc[rr] = sc[TP + p];
      }
      // word w: channels BPL gq + 4w .. + 3, of m-tiles 2w and 2w + 1 (PA:
      // channel BPL gq + 4w + e is column gq of n-tile 4w + e)
#pragma unroll
      for (int w = 0; w < BPL / 4; ++w) {
        float x[4][4];  // zeros past pos
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) dequant4(vw[rr][w], vsc[rr], x[rr]);
        if constexpr (PA) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma_bf16(o[4 * w + e], hi[2 * kk], lo[2 * kk], hi[2 * kk + 1],
                     lo[2 * kk + 1], pack_bf16(x[0][e], x[1][e]),
                     pack_bf16(x[2][e], x[3][e]));
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            mma_bf16(o[2 * w + hf], pack_bf16(x[0][2 * hf], x[1][2 * hf]),
                     pack_bf16(x[0][2 * hf + 1], x[1][2 * hf + 1]),
                     pack_bf16(x[2][2 * hf], x[3][2 * hf]),
                     pack_bf16(x[2][2 * hf + 1], x[3][2 * hf + 1]),
                     pb[2 * kk], pb[2 * kk + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // the warp's state: l over the 4 lanes of each head; head t's channels
  // BPL gq + 2i, + 1 as its hi and lo columns summed (PA: head gq's
  // channels BPL 2t + i, BPL (2t + 1) + i as its hi and lo rows summed)
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  float* wacc = reinterpret_cast<float*>(smem);  // (W, G, HD)
  float* wml = wacc + W * G * HD;                // (W, G, 2)
  if constexpr (PA) {
    if (gq < G) {
      float4* at = reinterpret_cast<float4*>(wacc + (warp * G + gq) * HD +
                                             2 * BPL * t);
#pragma unroll
      for (int i = 0; i < MT; i += 4) {
        at[i / 4] = make_float4(o[i][0] + o[i][2], o[i + 1][0] + o[i + 1][2],
                                o[i + 2][0] + o[i + 2][2],
                                o[i + 3][0] + o[i + 3][2]);
        at[(BPL + i) / 4] =
            make_float4(o[i][1] + o[i][3], o[i + 1][1] + o[i + 1][3],
                        o[i + 2][1] + o[i + 2][3], o[i + 3][1] + o[i + 3][3]);
      }
    }
  } else if (t < G) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float* at = wacc + (warp * G + t) * HD + BPL * gq + 2 * i;
      at[0] = o[i][0] + o[i][1];
      at[1] = o[i][2] + o[i][3];
    }
  }
  if (t == 0 && gq < G) {
    wml[(warp * G + gq) * 2] = m;
    wml[(warp * G + gq) * 2 + 1] = l;
  }
}

// byte offset of 16-byte chunk c of row p of walk_bf16_mma's tile (rows of
// CPR chunks, a multiple of 8): c ^ (p & 7), so that 8 consecutive rows'
// chunk c (an ldmatrix matrix) and a row's 8 chunks of one aligned group
// (a quarter-warp's copies) each hit 8 distinct bank groups
template <int CPR>
__device__ __forceinline__ int bf16_chunk_at(int p, int c) {
  return 16 * (p * CPR + (c ^ (p & 7)));
}

// four 8x8 matrices of 16-bit values from shared memory: lanes 8i..8i + 7
// give the addresses of matrix i's rows; r[i] of lane 4g + t holds its row
// g, columns 2t, 2t + 1 (.trans: rows 2t, 2t + 1 of its column g)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned at) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  unsigned at) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at));
}

// The bf16 cache's body on the tensor cores (BF16_MMA_BODY: bf16 q and
// cache, hd 64 or 128, G 1 or 5..8): one KV head of one b, positions
// begin..end-1; q its G rows; kb, vb the cache at position 0 of the head.
// Bf16MmaPlan's tiles, warp w taking positions 16 w .. + 15 of each, in a
// ring filled by 16-byte cp.async copies as walk_int8_mma's. q.k: S (G x
// 8 positions) += Q (G x 16 channels) K^T, two n-tiles a warp, Q's
// fragments (head gq's channels 16 j + 2t, + 1 and + 8, + 9 for k-step j;
// rows G.. zero) unscaled in registers; K's fragments by ldmatrix.x4 of
// the warp's 8 rows of an n-tile, 4 chunks (2 k-steps) at a time; the
// scores of positions 8 nt + 2t, + 1 of head gq come out on lane (gq, t),
// times log2(e) / sqrt(HD). p.v as walk_int8_mma's at G > 4: O (16 x 8
// channels) += P (16 x 16 positions) V, P the A operand as it lies in the
// scores (rows g: head g's bf16 hi, rows g + 8: its lo), so no score
// moves between lanes and each lane rescales by its own head's
// correction; V's B fragments (rows 2t, + 1 and 2t + 8, + 9 of column g
// of an n-tile) by ldmatrix.x4.trans, 2 n-tiles a time; HD / 8 n-tiles
// of sums a lane (64 fp32 at hd 128), head gq's channels 8 n + 2t, + 1
// as hi and lo rows summed after the loop. Per 16 positions a warp: 2 HD
// / 16 + HD / 8 mma.sync and HD / 8 ldmatrix.x4, no widening, FMA or
// shuffle a value. Ends as walk_int8, but for the accumulators' row
// stride: each warp's state in smem, accumulators (W, G, M::RS), then (m,
// l) (W, G, 2), before a barrier.
template <int HD, int G>
__device__ __forceinline__ void walk_bf16_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, int KV, int begin, int end,
    unsigned char* smem) {
  constexpr int W = DECODE_ATTN_BF16_WARPS;
  using M = Bf16Plan<HD, G>;
  constexpr int CPR = M::CPR, TP = M::TP, WP = M::WP, NSTAGE = M::NSTAGE;
  constexpr int KS = HD / 16;  // q.k k-steps
  constexpr int NO = HD / 8;   // p.v n-tiles of 8 channels
  static_assert(G <= 8 && WP == 16 && KS % 2 == 0, "walk_bf16_mma");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int ntile = (end - begin + TP - 1) / TP;
  const size_t step = static_cast<size_t>(KV) * HD;  // between positions
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // tile tt into slot tt % NSTAGE as commit group tt (empty past the
  // last): copy j of a thread is chunk ce of the row at position p0 + j
  // (BT / CPR) of the tile, its offsets hoisted out of the tiles;
  // consecutive threads read consecutive 16 bytes of a row
  const int ce = tid % CPR, p0 = tid / CPR;
  constexpr int PSTEP = M::BT / CPR;
  const __nv_bfloat16* kc = kb + 8 * ce;
  const __nv_bfloat16* vc = vb + 8 * ce;
  auto fetch = [&](int tt) {
    if (tt < ntile) {
      unsigned char* kt = smem + (tt % NSTAGE) * M::STAGE;
      unsigned char* vt = kt + M::ROWS;
      const int t0 = begin + tt * TP, n = end - t0;  // rows of the tile
      const size_t base = static_cast<size_t>(t0) * step;
#pragma unroll
      for (int j = 0; j < M::NCOPY; ++j) {
        const int p = p0 + j * PSTEP;
        const size_t off = p < n ? base + p * step : 0;
        const int at = bf16_chunk_at<CPR>(p, ce);
        cp_async16(kt + at, kc + off, p < n ? 16 : 0);
        cp_async16(vt + at, vc + off, p < n ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int tt = 0; tt < NSTAGE; ++tt) fetch(tt);  // the whole ring

  uint32_t qa[KS][2];  // a0 and a2 of k-step j; a1 and a3 (rows 8..) zero
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    qa[j][0] = qa[j][1] = 0u;
    if (gq < G) {
      const uint32_t* qw =
          reinterpret_cast<const uint32_t*>(q + gq * HD + 16 * j + 2 * t);
      qa[j][0] = qw[0];
      qa[j][1] = qw[4];  // channels + 8
    }
  }
  const float qscale = LOG2E / sqrtf(static_cast<float>(HD));
  float m = -INFINITY, l = 0.0f;  // head gq's, over this lane's positions
  float o[NO][4];  // O: rows gq (hi) and gq + 8 (lo), columns 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  const int wbase = warp * WP;  // this warp's first position of a tile
  // the rows whose addresses this lane gives ldmatrix: q.k's matrices are
  // 8 positions of an n-tile by chunks 4 j2 + lane / 8; p.v's are
  // positions 0..7, 8..15 of the warp by chunks 2 n2, 2 n2 + 1
  const int kr = wbase + (lane & 7), kc4 = lane >> 3;
  const int vr = wbase + (lane & 15), vc2 = lane >> 4;

  for (int tt = 0; tt < ntile; ++tt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile tt is in; every warp is done with tt - 1
    if (tt > 0) fetch(tt - 1 + NSTAGE);
    const int t0 = begin + tt * TP;
    if (t0 + wbase >= end) continue;  // the warp's positions lie past pos
    const unsigned kt = ring + (tt % NSTAGE) * M::STAGE;
    const unsigned vt = kt + M::ROWS;

    // q.k: lane (gq, t) holds the scores of positions 8 nt + 2t, + 1
    float s[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float d[2][4] = {};  // even and odd k-steps: two chains of products
#pragma unroll
      for (int j2 = 0; j2 < KS / 2; ++j2) {
        uint32_t b[4];  // k-step 2 j2: b[0], b[1]; 2 j2 + 1: b[2], b[3]
        ldmatrix_x4(b, kt + bf16_chunk_at<CPR>(kr + 8 * nt, 4 * j2 + kc4));
        mma_bf16(d[0], qa[2 * j2][0], 0u, qa[2 * j2][1], 0u, b[0], b[1]);
        mma_bf16(d[1], qa[2 * j2 + 1][0], 0u, qa[2 * j2 + 1][1], 0u, b[2],
                 b[3]);
      }
      s[nt][0] = (d[0][0] + d[1][0]) * qscale;
      s[nt][1] = (d[0][1] + d[1][1]) * qscale;
    }

    // online softmax of head gq over the 4 lanes that hold its scores
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = t0 + wbase + 8 * nt + 2 * t + e < end;
        s[nt][e] = valid ? s[nt][e] : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float mn = fmaxf(m, mx);  // finite: the warp's first position
    const float corr = exp2f(m - mn);  // 0 while m is -inf
    m = mn;
    l *= corr;
    uint32_t hi[2], lo[2];  // P of positions 8 nt + 2t, + 1: hi, lo
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = exp2f(s[nt][0] - mn), p1 = exp2f(s[nt][1] - mn);
      l += p0 + p1;
      hi[nt] = pack_bf16(p0, p1);
      lo[nt] = pack_bf16(p0 - __uint_as_float(hi[nt] << 16),
                         p1 - __uint_as_float(hi[nt] & 0xffff0000u));
    }
    if (__any_sync(FULL, corr != 1.0f)) {  // head gq's, this lane's own
#pragma unroll
      for (int i = 0; i < NO; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= corr;
    }

    // p.v, one k-step of the warp's 16 positions, 2 n-tiles an ldmatrix
#pragma unroll
    for (int n2 = 0; n2 < NO / 2; ++n2) {
      uint32_t b[4];  // n-tile 2 n2: b[0], b[1]; 2 n2 + 1: b[2], b[3]
      ldmatrix_x4_trans(b, vt + bf16_chunk_at<CPR>(vr, 2 * n2 + vc2));
      mma_bf16(o[2 * n2], hi[0], lo[0], hi[1], lo[1], b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], hi[0], lo[0], hi[1], lo[1], b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // the warp's state: l over the 4 lanes of each head; head gq's channels
  // 8 n + 2t, + 1 as its hi and lo rows summed
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  float* wacc = reinterpret_cast<float*>(smem);  // (W, G, M::RS)
  float* wml = wacc + W * G * M::RS;             // (W, G, 2)
  if (gq < G) {
    float2* at = reinterpret_cast<float2*>(wacc + (warp * G + gq) * M::RS +
                                           2 * t);
#pragma unroll
    for (int i = 0; i < NO; ++i)
      at[4 * i] = make_float2(o[i][0] + o[i][2], o[i][1] + o[i][3]);
    if (t == 0) {
      wml[(warp * G + gq) * 2] = m;
      wml[(warp * G + gq) * 2 + 1] = l;
    }
  }
}

// The block's partials from its W warps' states (wacc: accumulators (W,
// G, RS), rows of HD floats RS apart, then (m, l) (W, G, 2)): its kvg
// rows, row0 .. row0 + kvg - 1, warp w holding row w % kvg; each written
// to out where its row has one active split, else to the scratch, where
// the row group's last block merges them. KVG > 0: kvg is KVG, known at
// compile time, so the loops over a row's warps have a constant trip
// count and unroll (walk_bf16_mma's one row: its W warps' loads and
// exponentials in flight together, not one after another).
template <int G, int HD, int W = NW, int KVG = 0, int RS = HD>
__device__ __forceinline__ void merge(const float* wacc, float* out,
                                      float* part_acc, float* part_ml,
                                      int group, int kvg, int split,
                                      int nsplit, int nact) {
  constexpr int BT = 32 * W;  // threads of the block
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const float* wml = wacc + W * G * RS;
  if constexpr (KVG > 0) kvg = KVG;
  // a row's partial: its warps merged in warp order (the first holds the
  // split's first position, so the max is finite)
  for (int i = tid; i < kvg * G * HD; i += BT) {
    const int h = KVG == 1 ? 0 : i / (G * HD), gi = i % (G * HD);
    const int g = gi / HD;
    const size_t row = static_cast<size_t>(group) * kvg + h;
    float M = -INFINITY;
    for (int w = h; w < W; w += kvg) M = fmaxf(M, wml[(w * G + g) * 2]);
    float L = 0.0f, O = 0.0f;
    const int at = RS == HD ? gi : g * RS + gi % HD;  // in warp w's rows
    for (int w = h; w < W; w += kvg) {
      const float c = exp2f(wml[(w * G + g) * 2] - M);  // 0 for m = -inf
      L = fmaf(c, wml[(w * G + g) * 2 + 1], L);
      O = fmaf(c, wacc[w * G * RS + at], O);
    }
    if (nact == 1) {
      out[row * G * HD + gi] = O / fmaxf(L, 1e-30f);
    } else {
      const size_t slot = row * nsplit + split;
      part_acc[slot * G * HD + gi] = O;
      if (gi % HD == 0) {
        part_ml[(slot * G + g) * 2] = M;
        part_ml[(slot * G + g) * 2 + 1] = L;
      }
    }
  }
  if (nact == 1) return;

  __syncthreads();  // the block's partials are written
  if (tid == 0) {
    // release: the partials (all threads', ordered by the barrier) before
    // the ticket; acquire: the other splits' partials, for the last one
    const unsigned ticket = ticket_add(&g_tickets[group]);
    is_last = ticket == static_cast<unsigned>(nact - 1);
    if (is_last) g_tickets[group] = 0;  // every split has its ticket
  }
  __syncthreads();
  if (!is_last) return;

  // the group's last block: merge each row's splits in split order,
  // MERGE_GROUP at a time with their loads in flight together (L2 reads,
  // as other SMs wrote them), rescaling the running sums by each group's
  // max
  for (int i = tid; i < kvg * G * HD; i += BT) {
    const int h = i / (G * HD), gi = i % (G * HD), g = gi / HD;
    const size_t row = static_cast<size_t>(group) * kvg + h;
    const float* ml = part_ml + row * nsplit * G * 2;
    const float* pa = part_acc + row * nsplit * G * HD;
    float M = -INFINITY, L = 0.0f, O = 0.0f;
    for (int s0 = 0; s0 < nact; s0 += MERGE_GROUP) {
      float mv[MERGE_GROUP], lv[MERGE_GROUP], ov[MERGE_GROUP];
#pragma unroll
      for (int j = 0; j < MERGE_GROUP; ++j) {
        const int sp = s0 + j;
        const bool in = sp < nact;
        mv[j] = in ? __ldcg(ml + (sp * G + g) * 2) : -INFINITY;
        lv[j] = in ? __ldcg(ml + (sp * G + g) * 2 + 1) : 0.0f;
        ov[j] = in ? __ldcg(pa + static_cast<size_t>(sp) * G * HD + gi)
                   : 0.0f;
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
    out[row * G * HD + gi] = O / fmaxf(L, 1e-30f);
  }
}

// The bodies whose ring is dynamic shared memory, the int8 cache's and
// walk_bf16_mma: one block per (group of kvg consecutive rows b * KV + kv,
// split), grid (B*KV / kvg, nsplit), kvg 1 for walk_bf16_mma; the rest as
// decode_attn_kernel.
template <typename T, typename E, int HD, int G>
__device__ __forceinline__ void ring_rows(
    const T* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos_dev,
    int pos_host, int S, int KV, int kvg, int split_len,
    float* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml) {
  const int tid = threadIdx.x;
  // the grid runs over the row groups first, so that the groups of one
  // b, reading the same rows of the cache, run together
  const int group = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int row = group * kvg;  // the group's first row
  const int pos = pos_dev ? *pos_dev : pos_host;
  constexpr bool MMA = !IS_INT8<E> || MMA_BODY<T, HD, G>;  // tensor cores
  constexpr int W = block_threads<T, E, HD, G>() / 32;  // warps a block
  if (pos < 0 || pos >= S) {  // only a device pos gets here
    if (split == 0)
      for (int i = tid; i < kvg * G * HD; i += 32 * W)
        out[static_cast<size_t>(row) * G * HD + i] =
            __int_as_float(0x7fc00000);  // quiet NaN
    return;
  }
  // the tensor-core bodies spread positions 0..pos evenly over the
  // launch's nsplit splits (ceil((pos + 1) / nsplit) each, at most
  // split_len), so that every block of the one wave the wrapper sizes
  // holds as many positions, whatever pos is; walk_int8 takes splits of
  // split_len
  const int len = MMA ? (pos + nsplit) / nsplit : split_len;
  const int nact = pos / len + 1;  // splits holding a position <= pos
  if (split >= nact) return;
  const int begin = split * len;
  const int end = min(begin + len, pos + 1);
  const size_t row0 =  // (b, position 0, kv) of the group's first row
      static_cast<size_t>(row / KV) * S * KV + row % KV;
  const T* qr = q + static_cast<size_t>(row) * G * HD;
  extern __shared__ __align__(16) unsigned char dsmem[];
  if constexpr (!IS_INT8<E>)
    walk_bf16_mma<HD, G>(qr, k + row0 * HD, v + row0 * HD, KV, begin, end,
                         dsmem);
  else if constexpr (MMA)
    walk_int8_mma<HD, G>(qr, k + row0 * HD, v + row0 * HD, k_scale + row0,
                         v_scale + row0, KV, kvg, begin, end, dsmem);
  else
    walk_int8<T, HD, G>(qr, k + row0 * HD, v + row0 * HD, k_scale + row0,
                        v_scale + row0, KV, kvg, begin, end, dsmem);
  const float* wacc = reinterpret_cast<const float*>(dsmem);
  __syncthreads();
  if constexpr (IS_INT8<E>)
    merge<G, HD, W>(wacc, out, part_acc, part_ml, group, kvg, split, nsplit,
                    nact);
  else  // one row a block; walk_bf16_mma's padded rows
    merge<G, HD, W, 1,
          Bf16Plan<HD, G>::RS>(
        wacc, out, part_acc, part_ml, group, kvg, split, nsplit, nact);
}

// One block per (split, b * KV + kv), grid (nsplit, B*KV): the bf16 or
// fp32 cache, E = T; or, E = int8_t or BF16_MMA_BODY, ring_rows (kvg rows
// a block). The CUDA-core bf16 and fp32 body shares no code with the
// others: built from shared walk and merge functions it ran 3-18% slower
// on the H100 (PERF.md, PR 25).
// part_acc (B*KV, nsplit, G, HD) and part_ml (B*KV, nsplit, G, 2) hold the
// splits' unnormalised accumulators and (max, denominator), in log2
// units; out (B*KV, G, HD). k_scale and v_scale (B, S, KV) are the int8
// form's scales (unused otherwise).
template <typename T, typename E, int HD, int G>
__global__ void __launch_bounds__(block_threads<T, E, HD, G>(),
                                  min_blocks<T, E, HD, G>())
decode_attn_kernel(const T* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ pos_dev, int pos_host, int S,
                   int KV, int kvg, int split_len, float* __restrict__ out,
                   float* __restrict__ part_acc,
                   float* __restrict__ part_ml) {
  if constexpr (IS_INT8<E> || BF16_MMA_BODY<T, E, HD, G>) {
    ring_rows<T, E, HD, G>(q, k, v, k_scale, v_scale, pos_dev, pos_host, S,
                           KV, kvg, split_len, out, part_acc, part_ml);
    return;
  } else {
    using P = Plan<T, HD, G>;
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
    const T* kb = k + row0 * HD;
    const T* vb = v + row0 * HD;

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

      float s[R][G], mx[G];
  #pragma unroll
      for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
  #pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = wbase + r * LP + pg;
        float kx[CL];
        read_row<T, CL>(reinterpret_cast<const E*>(ks + p * P::RB) + sl * CL,
                        kx);
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
        read_row<T, CL>(reinterpret_cast<const E*>(vs + p * P::RB) + sl * CL,
                        vx);
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
          ov[j] = in ? __ldcg(pa + static_cast<size_t>(sp) * G * HD + i)
                     : 0.0f;
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
}

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int* pos_dev;
  int pos, S, KV, kvg, groups, split_len, nsplit;
  float *out, *part_acc, *part_ml;
  cudaStream_t stream;
  int* blocks_per_sm;  // not null: report the kernel's residency instead
};

template <typename T, typename E, int HD, int G>
int launch(const Args& a) {
  const auto kernel = decode_attn_kernel<T, E, HD, G>;
  constexpr int smem = ring_smem<T, E, HD, G>();
  constexpr bool RING = smem > 0;  // ring_rows: grid (groups, nsplit)
  if constexpr (RING) {
    // the ring is dynamic shared memory, past 48 KB at hd 80: the limit is
    // raised on the launch's device, with the largest carveout, so that
    // min_blocks rings fit an SM
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.blocks_per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kernel, block_threads<T, E, HD, G>(), smem));
  if (RING && a.nsplit > 65535)  // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = RING ? dim3(a.groups, a.nsplit)
                         : dim3(a.nsplit, a.groups);
  kernel<<<grid, block_threads<T, E, HD, G>(), smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const E*>(a.k),
          static_cast<const E*>(a.v), a.k_scale, a.v_scale, a.pos_dev, a.pos,
          a.S, a.KV, a.kvg, a.split_len, a.out, a.part_acc, a.part_ml);
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
    case 128: return by_group<T, E, 128>(G, a);
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
// split_len positions cover 0..S-1: nsplit = ceil(S / split_len)
// (the tensor-core bodies, walk_int8_mma and walk_bf16_mma, split 0..pos
// into nsplit equal parts, of at most split_len, instead); at most 65535
// for the int8 cache and walk_bf16_mma. A block takes kvg consecutive KV heads:
// 1, or for the int8 cache 2 or 4 where they divide KV. Scratch part_acc
// (B*KV*nsplit*G*HD) and part_ml (B*KV*nsplit*G*2) fp32; out (B, KV, G,
// HD) fp32, NaN throughout if a device pos lies outside 0..S-1. One launch
// on `stream`, nothing else; returns its CUDA error, or 0.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int* pos_dev, float* out, float* part_acc,
                           float* part_ml, int B, int S, int KV, int G,
                           int HD, int pos, int split_len, int nsplit,
                           int kvg, int is_bf16, int is_int8, void* stream) {
  const long long rows = static_cast<long long>(B) * KV;
  if (G < 1 || G > MAX_GROUP || S < 1 || rows < 1 || rows > MAX_ROWS ||
      split_len < 1 || nsplit < 1 ||
      static_cast<long long>(nsplit - 1) * split_len >= S ||
      static_cast<long long>(nsplit) * split_len < S ||
      (pos_dev == nullptr && (pos < 0 || pos >= S)) ||
      (is_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      !(kvg == 1 || (is_int8 && (kvg == 2 || kvg == 4) && KV % kvg == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, pos_dev, pos, S, KV, kvg,
               static_cast<int>(rows / kvg), split_len, nsplit, out,
               part_acc, part_ml, static_cast<cudaStream_t>(stream),
               nullptr};
  return is_bf16 ? by_cache<__nv_bfloat16>(is_int8, HD, G, a)
                 : by_cache<float>(is_int8, HD, G, a);
}

// The blocks of decode_attn_kernel<T, E, HD, G> that one SM of the current
// device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// with a ring's dynamic shared memory set as a launch sets it) into
// *blocks; the wrapper sizes the tensor-core bodies' one wave from it.
// Returns the CUDA error, or 0.
extern "C" int decode_attn_blocks_per_sm(int is_bf16, int is_int8, int HD,
                                         int G, int* blocks) {
  if (G < 1 || G > MAX_GROUP || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.blocks_per_sm = blocks;
  return is_bf16 ? by_cache<__nv_bfloat16>(is_int8, HD, G, a)
                 : by_cache<float>(is_int8, HD, G, a);
}
