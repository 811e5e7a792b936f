// Decode attention over the slot KV cache: one query token per slot.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/decode_attention.py
// `_decode_kernel`, both branches (reached through `paged_decode_attention`):
// the bf16 cache (kernel 3) and the int8 cache with f32 per-token, per-kv-head
// scales stored transposed as (S, Hkv, Lalloc) (kernel 3q, quantized=True).
// Semantics kept: q (S, H, D) against slot s's cache prefix lengths[s]; GQA
// inside the kernel (q head h reads kv head h / rep); the block loop clamped
// to [1, Lalloc / kBlock] blocks; a masked key gets p = 0; zero length gives
// exactly 0; q . k in f32 with the D^-0.5 scale; the output is bf16. The int8
// branch folds ks[key] into the logit and vs[key] into p.
//
// What bounds it on the H100: bytes. A layer reads len x Hkv x D x 2 bytes of
// K and V per slot (int8: half, plus 8 bytes of scales a row) and does ~2
// FLOPs a byte per q head, far below the card's ~295 FLOP/byte balance point.
// What the design does about each cost of the split-KV kernel it replaces
// (a main kernel that wrote f32 partials of every split to global memory and
// a second kernel that merged them):
//  1. One launch a call, no partials in global memory. The blocks of one
//     (slot, kv head) are split over the n_split CTAs of one thread-block
//     cluster. Each CTA keeps its softmax state (m, l, acc[rep][D]) in its own
//     shared memory; after a cluster barrier the CTA of rank r merges q heads
//     r, r + n_split, ... by reading every rank's state through distributed
//     shared memory, all ranks at once, and adds them in rank order before it
//     writes the bf16 output. The fixed orders make results bit-reproducible.
//  2. n_split comes from the shape alone (ops/decode_attention.py
//     `split_count`: S, Hkv, the SM count, at most the portable cluster of 8;
//     clusters of 16 measured slower on an H100 SXM, their scheduling costing
//     more than the split saves), and the lengths are read on the device
//     only: each CTA takes ceil(nblocks / n_split) consecutive blocks of its
//     slot.
//  3. Asynchronous loads. One producer thread keeps a CTA's blocks in flight
//     in a ring of kStages stages: per block two TMA boxes of K and of V
//     (64 rows x 128 bytes each, 128-byte swizzle; one of each for int8) from
//     tensor maps over the stacked cache, and for int8 the block's 64 + 64
//     scales by cp.async.bulk on the same mbarrier. Two groups of four
//     consumer warps take alternate blocks, each warp 16 keys of its group's
//     blocks with its own online softmax, so no CTA-wide barrier runs inside
//     the block loop. (Row-by-row cp.async.bulk copies, 128 a block, ran at
//     ~30 ns a copy on an H100 SXM: 3x slower than the boxes.)
//  4. The host path: no scratch, no length read, the shape in one struct and
//     the tensor maps encoded once a plan and buffer; the launch allocates
//     nothing and takes all its arguments by value, so it can be captured in
//     a CUDA graph. It is a programmatic dependent launch: the CTAs' set-up
//     overlaps the previous kernel's tail.
// The products run on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
// accumulation): S = Q K^T with the rep q heads of the group as M (16 rows,
// rows past rep zero) and 8 keys as N, then O += P V with the same 16 rows,
// P from S's accumulators in registers. int8 codes are converted exactly to
// bf16 and the scales applied outside the products. wgmma needs 64 rows,
// which a group of at most 16 heads does not fill; f32 FMAs would read q and k
// from shared memory for every product. The reduction order over D is
// permuted (frag_d) so that one 16-byte shared load gives a thread the B
// fragments of two (bf16) or four (int8) k-steps; Q's A fragments follow.
//
// Every head dim with D % 128 == 0, as the JAX package routes its decode
// kernel; any other D is refused. Instances of 128 and 256 columns: at 256 a
// bf16 stage is 64 KB (4 + 4 boxes), so the ring takes three, which pass
// between the consumer groups (one full barrier a stage and group, `Ring`,
// so that a group never takes a stage's earlier load for its own); the merge
// workspace (the warps' and the CTA's partial states, ~150 KB) still fits
// inside the ring it aliases, which is idle once every warp has left the
// block loop. O is 128 registers a consumer thread there, so Q's fragments
// (8 KB) are kept in shared memory beside the ring, written once by warp 0
// and read per block, instead of 64 more registers. Above 256 (kSliced, the
// 256 instance's layout) the grid's y axis takes (kv head, column slice of
// 256): a block is ceil(D / 256) stages of 256 K columns, the last also
// holding the slice's V columns (and the int8 scales), so S sums every
// column in the same order in every slice; both consumer groups take every
// block, each keeping O for 128 of the slice's columns (64 registers), and
// Q's fragments are read from L1 a k-step at a time. K is read once a
// slice (from L2 after the first), V once; the merge workspace is the 256
// instance's.
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace socio_decode {

using namespace socio90;
namespace cg = cooperative_groups;

constexpr int kBlock = 64;             // cache rows per block
constexpr int kMaxRep = 16;            // q heads per kv head: the mma's 16 rows
constexpr int kGroups = 2;             // consumer groups, taking alternate blocks
constexpr int kWarps = 4 * kGroups;    // consumer warps: 16 keys of a block each
constexpr int kThreads = 32 * (kWarps + 1);   // + one producer warp
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one CTA of head dim kD (bytes). K and V arrive as
// TMA boxes of 64 rows x 128 bytes with the 128-byte swizzle (16-byte chunk c
// of row r stored at chunk c ^ (r % 8)), so the fragment loads below, 8 rows
// or 8 chunks a phase, hit distinct banks: bf16 rows as kD / 64 boxes (d
// 0-63, 64-127, ..), int8 rows as kD / 128. Every box starts on a 1024-byte
// boundary.
template <typename T, int kD>
struct Layout {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int kStages = !kQuant && kD > 128 ? 3 : 4;       // ring depth
  static constexpr int kAccStride = kD + 8;   // f32 partial rows, padded against bank conflicts
  static constexpr bool kQSmem = kD > 128;    // Q's A fragments in shared memory
  static constexpr int kBoxes = kD * (int)sizeof(T) / 128;          // 128-byte boxes a row
  static constexpr int kBox = kBlock * 128;                         // bytes of one box
  static constexpr int kK = 0;
  static constexpr int kV = kBoxes * kBox;
  static constexpr int kScales = 2 * kBoxes * kBox;                 // int8: ks[64], vs[64]
  static constexpr int kStage = kScales + (kQuant ? 1024 : 0);
  static constexpr int kTxBytes = 2 * kBoxes * kBox + (kQuant ? 2 * kBlock * 4 : 0);
  // int8: each consumer warp's 16 V rows converted to bf16 for ldmatrix,
  // rows padded by 16 bytes against bank conflicts
  static constexpr int kConvStride = kD * 2 + 16;
  static constexpr int kConv = kStages * kStage;
  static constexpr int kWork = kConv + (kQuant ? kWarps * 16 * kConvStride : 0);
  // Q's fragments, [kD / 16 k-steps][32 lanes] x 16 bytes, outside the ring
  static constexpr int kQ = kWork;
  static constexpr int kSmem = 1024 + kWork + (kQSmem ? kD / 16 * 32 * 16 : 0);   // + slack
  // after the block loop the ring (and int8 scratch) hold the warps' partial
  // states, then the CTA's, which the other CTAs of the cluster read
  static constexpr int kWarpAcc = 0;                                  // [kWarps][16][kAccStride]
  static constexpr int kWarpM = kWarps * kMaxRep * kAccStride * 4;    // [kWarps][16]
  static constexpr int kWarpL = kWarpM + kWarps * kMaxRep * 4;
  static constexpr int kCtaAcc = kWarpL + kWarps * kMaxRep * 4;       // [16][kAccStride]
  static constexpr int kCtaM = kCtaAcc + kMaxRep * kAccStride * 4;    // [16]
  static constexpr int kCtaL = kCtaM + kMaxRep * 4;
  static_assert(kCtaL + kMaxRep * 4 <= kWork, "partials exceed the ring");
  static_assert(kStage % 1024 == 0, "swizzled boxes start on 1024-byte boundaries");
  static_assert(kSmem <= 232448, "the H100's shared memory a block");
};

// The ring's full barriers. Without kSliced the two consumer groups take
// alternate blocks, so a ring of an odd depth (bf16 at 256: three stages)
// hands each stage from one group to the other: stage 0 holds block 0 for
// group 0, block 3 for group 1, block 6 for group 0. With one full barrier a
// stage, a group could reach block i + 3 while the load of block i into the
// stage was still in flight, and its wait would take the barrier's earlier
// phase, of the same parity, for the one it wants: it would read a stale
// stage and release it early, and the producer would overwrite a block the
// other group was still reading (until a wait ran past mbar_wait's 2^35
// clocks and trapped). So such a ring keeps one full barrier a (stage,
// group): each is met by every sixth block, all of one group, which waits
// for its phases in order. An even ring, or the sliced kernel (both groups
// take every block), keeps one a stage.
template <typename T, int kD, bool kSliced>
struct Ring {
  static constexpr int kStages = Layout<T, kD>::kStages;
  static constexpr int kSets = !kSliced && kStages % kGroups ? kGroups : 1;
  static constexpr int kFull = kStages * kSets;      // full barriers, then kStages empty ones
  // the full barrier of the CTA's i-th stage load, and the parity of the
  // phase that load completes
  __device__ __forceinline__ static uint32_t full(uint32_t full0, int i) {
    return full0 + 8 * (i % kStages + kStages * (i % kSets));
  }
  __device__ __forceinline__ static uint32_t parity(int i) { return (i / kFull) & 1; }
};

// The d column that thread tq of a quad supplies as element e (0-3) of mma
// k-step kk: one 16-byte shared load gives a thread 8 bf16 (two k-steps) or
// 16 int8 codes (four), from the logical chunk 2 tq + p of a 128-byte box
// row, which spreads the 8 rows x 4 threads of a load phase over distinct
// banks. Q's A fragments use the same map, so q . k sums every d once.
template <bool kQuant>
__host__ __device__ constexpr int frag_d(int kk, int tq, int e) {
  return kQuant ? 128 * (kk / 8) + 32 * tq + 4 * (kk % 8) + e
                : 64 * (kk / 4) + 16 * tq + 4 * (kk % 4) + e;
}

struct DecodeArgs {
  CUtensorMap kmap;     // ([layers,] S, Lalloc, Hkv, D) as (D, Hkv, Lalloc, S, layers)
  CUtensorMap vmap;
  const bf16* q;        // (S, H, D)
  const float* ks;      // int8 only: (S, Hkv, Lalloc) view of the call's layer
  const float* vs;
  bf16* o;              // (S, H, D)
  const int* lengths;   // (S,)
  int Hkv, rep, Lalloc, layer;
  int D, slices;        // the head dim; above 256, its column slices of 256 (sliced kernel)
  long long sqs, sqh, skss, sksh, svss, svsh, sos, soh;
  float scale;          // D^-0.5
};

// The call's shape and strides (elements; layer strides 0 for an unstacked
// cache), built once a plan by the wrapper (a ctypes mirror in
// ops/decode_attention.py).
struct DecodeShape {
  int S, H, Hkv, D, Lalloc, n_split, n_layers;
  long long sqs, sqh, skl, sks, skt, skh, svl, svs, svt, svh, skss, sksh, svss, svsh, sos, soh;
  float scale;
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ uint4 lds_u128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts_u128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 codes (one 32-bit word, lowest byte first) as two bf16 pairs,
// exactly: code + 128 as the low bits of the f32 2^23 + u, minus 2^23 + 128.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | e)) - 8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// ------------------------------------------------------------------ kernel

// Address of the 16-byte chunk `c` of row `r` in a swizzled 64 x 128-byte box.
__device__ __forceinline__ uint32_t swz(uint32_t box, int r, int c) {
  return box + r * 128 + ((c ^ (r & 7)) << 4);
}

// The sliced kernel (kSliced: kD = 256, the head dim a.D above it) walks each
// block as nk = ceil(D / 256) stages: stage kc holds K's columns 256 kc ..
// 256 kc + 255, and the last one also the 256 columns of V of the CTA's
// slice `sl` (and, for int8, the block's scales). TMA fills columns past D
// with zeros. Without kSliced a block is one stage of all kD columns.
template <typename T, int kD, bool kSliced>
__device__ __forceinline__ void producer(const DecodeArgs& a, uint32_t base, uint32_t full0,
                                         uint32_t empty0, int s, int g, int sl, int j_lo,
                                         int j_hi) {
  using L = Layout<T, kD>;
  constexpr int kStages = L::kStages;
  const int nk = kSliced ? (a.D + kD - 1) / kD : 1;
  const float* ksb = a.ks + s * a.skss + g * a.sksh;
  const float* vsb = a.vs + s * a.svss + g * a.svsh;
  constexpr int kBoxCols = 128 / (int)sizeof(T);
  for (int j = j_lo; j < j_hi; ++j) {
    for (int kc = 0; kc < nk; ++kc) {
      const int i = (j - j_lo) * nk + kc, st = i % kStages;
      const bool last = kc == nk - 1;
      if (i >= kStages) mbar_wait(empty0 + 8 * st, ((i / kStages) - 1) & 1);
      const uint32_t full = Ring<T, kD, kSliced>::full(full0, i), dst = base + st * L::kStage;
      mbar_expect_tx(full, last ? L::kTxBytes : L::kBoxes * L::kBox);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_load_5d(dst + L::kK + b * L::kBox, &a.kmap, full, kD * kc + b * kBoxCols, g,
                    j * kBlock, s, a.layer);
        if constexpr (!kSliced)
          tma_load_5d(dst + L::kV + b * L::kBox, &a.vmap, full, b * kBoxCols, g, j * kBlock, s,
                      a.layer);
      }
      if constexpr (kSliced) {
        if (!last) continue;
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load_5d(dst + L::kV + b * L::kBox, &a.vmap, full, kD * sl + b * kBoxCols, g,
                      j * kBlock, s, a.layer);
      }
      if constexpr (L::kQuant) {
        bulk_g2s(dst + L::kScales, ksb + (long long)j * kBlock, kBlock * 4, full);
        bulk_g2s(dst + L::kScales + kBlock * 4, vsb + (long long)j * kBlock, kBlock * 4, full);
      }
    }
  }
}

// One consumer warp: 16 keys of every block of its group (blocks j_lo +
// group, + kGroups, ...) with its own online softmax; leaves its partial
// state (log2 domain) in the ring. Sliced: both groups take every block (a
// block spans nk stages, and a stage consumed by one group only could be
// waited for by the other a phase early), S sums the block's nk stages (the
// same order in every slice and group, so both groups hold the same m and
// l), and O holds the group's 128 of the slice's 256 columns; Q's fragments
// are read from global memory (L1) a k-step at a time.
template <typename T, int kD, bool kSliced>
__device__ __forceinline__ void consumer(const DecodeArgs& a, unsigned char* smem, uint32_t base,
                                         uint32_t full0, uint32_t empty0, int s, int g,
                                         int len, int j_lo, int j_hi) {
  using L = Layout<T, kD>;
  constexpr int kStages = L::kStages;
  constexpr bool kQSmem = L::kQSmem && !kSliced;
  const int nk = kSliced ? (a.D + kD - 1) / kD : 1;
  constexpr int kAccStride = L::kAccStride;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = w % 4, group = w / 4;          // key slice, block parity (sliced: column half)
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row group, thread in quad
  const int rep = a.rep;
  constexpr int kOC = kSliced ? kD / 2 : kD;    // O columns a warp holds
  const int oc0 = kSliced ? kOC * group : 0;    // their first, within the slice

  // Q as the A operand: rows gq and gq + 8 are q heads of this kv head (0
  // past rep); k-step kk takes the columns frag_d(kk, tq, 0..3), standing for
  // k = 2 tq, 2 tq + 1 | 2 tq + 8, 2 tq + 9. In registers, or at kQSmem in
  // shared memory (warp 0 writes them; every warp's lane reads the same).
  uint32_t qa[kQSmem || kSliced ? 1 : kD / 16][4];
  const uint32_t qsm = base + L::kQ;
  const bf16* qg = a.q + s * a.sqs + (long long)g * rep * a.sqh;
  int kc = 0;                                   // sliced: the stage's first column / kD
  auto load_q = [&](int kk, uint32_t (&f)[4]) {
    const int d = kD * kc + frag_d<L::kQuant>(kk, tq, 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = gq + 8 * r;
      uint2 v = make_uint2(0u, 0u);
      if (h < rep && (!kSliced || d < a.D)) v = *reinterpret_cast<const uint2*>(qg + h * a.sqh + d);
      f[r] = v.x;
      f[2 + r] = v.y;
    }
  };
  if constexpr (kSliced) {
  } else if constexpr (kQSmem) {
    if (w == 0) {
#pragma unroll 4
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t f[4];
        load_q(kk, f);
        sts_u128(qsm + (kk * 32 + lane) * 16, f[0], f[1], f[2], f[3]);
      }
    }
    named_bar_sync(1, 32 * kWarps);
  } else {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) load_q(kk, qa[kk]);
  }
  // c += Q's k-step kk times the B fragment (b0, b1)
  auto mma_q = [&](float (&c)[4], int kk, uint32_t b0, uint32_t b1) {
    if constexpr (kSliced) {
      uint32_t f[4];
      load_q(kk, f);
      mma16816(c, f, b0, b1);
    } else if constexpr (kQSmem) {
      const uint4 v = lds_u128(qsm + (kk * 32 + lane) * 16);
      const uint32_t f[4] = {v.x, v.y, v.z, v.w};
      mma16816(c, f, b0, b1);
    } else {
      mma16816(c, qa[kk], b0, b1);
    }
  };

  float o[kOC / 8][4];                // O: n-tile n holds d oc0 + 8n + 2tq, +1 of rows gq | gq + 8
#pragma unroll
  for (int n = 0; n < kOC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float qk_scale = a.scale * kLog2e;
  const uint32_t conv = base + L::kConv + w * 16 * L::kConvStride;
  const int vr = 16 * wk + (lane & 7) + ((lane >> 3) & 1) * 8;    // ldmatrix row (key)

  // S += Q K^T over the K columns of `stage`: n-tile nt holds keys 16 wk + 8
  // nt + 2 tq, +1 of rows gq | gq + 8, summed in two chains (even and odd
  // k-steps) for latency
  auto qk = [&](uint32_t stage, float (&sc)[2][2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int kr = 16 * wk + 8 * nt + gq;       // this lane's key row (B column)
#pragma unroll
      for (int c = 0; c < 2 * L::kBoxes; ++c) {   // 16-byte loads: box c / 2, chunk 2 tq + c % 2
        const uint4 kv = lds_u128(swz(stage + L::kK + (c / 2) * L::kBox, kr, 2 * tq + c % 2));
        if constexpr (L::kQuant) {
          uint32_t b[8];
          i8x4_to_bf16(kv.x, b[0], b[1]);
          i8x4_to_bf16(kv.y, b[2], b[3]);
          i8x4_to_bf16(kv.z, b[4], b[5]);
          i8x4_to_bf16(kv.w, b[6], b[7]);
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_q(sc[nt][e & 1], 4 * c + e, b[2 * e], b[2 * e + 1]);
        } else {
          const int kk = 4 * (c / 2) + 2 * (c % 2);
          mma_q(sc[nt][0], kk, kv.x, kv.y);
          mma_q(sc[nt][1], kk + 1, kv.z, kv.w);
        }
      }
    }
  };

  for (int j = j_lo + (kSliced ? 0 : group); j < j_hi; j += kSliced ? 1 : kGroups) {
    const bool active = j * kBlock + 16 * wk < len;   // else every p is 0: the state stays
    float sc[2][2][4] = {};
    int st;
    uint32_t stage;
    if constexpr (kSliced) {             // the block's nk stages, S summed over them
      for (kc = 0; kc < nk; ++kc) {
        const int i = (j - j_lo) * nk + kc;
        st = i % kStages;
        stage = base + st * L::kStage;
        mbar_wait(Ring<T, kD, kSliced>::full(full0, i), Ring<T, kD, kSliced>::parity(i));
        if (active) qk(stage, sc);
        if (kc + 1 < nk) {               // a K stage before the block's last: done with it
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
      }
    } else {
      const int i = j - j_lo;
      st = i % kStages;
      stage = base + st * L::kStage;
      mbar_wait(Ring<T, kD, kSliced>::full(full0, i), Ring<T, kD, kSliced>::parity(i));
    }
    if (active) {
      if constexpr (!kSliced) qk(stage, sc);
      const float* ks_s = reinterpret_cast<const float*>(smem + st * L::kStage + L::kScales);
      const float* vs_s = ks_s + kBlock;
      float x[2][4];                                // logits, log2 domain
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * wk + 8 * nt + 2 * tq + e;     // key within the block
          float f = qk_scale;
          if constexpr (L::kQuant) f *= ks_s[c];
          const bool valid = j * kBlock + c < len;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = 2 * r + e;
            x[nt][k] = valid ? (sc[nt][0][k] + sc[nt][1][k]) * f : kNegInf;
            mx[r] = fmaxf(mx[r], x[nt][k]);
          }
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // p (a masked key gets 0, also where the whole row is still masked);
      // the int8 branch folds vs[key] into the product's p, not into l
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xv = x[nt][2 * r + e];
            p[e] = xv > 0.5f * kNegInf ? ex2(xv - m[r]) : 0.f;
            l[r] += p[e];
            if constexpr (L::kQuant) p[e] *= vs_s[16 * wk + 8 * nt + 2 * tq + e];
          }
          pa[2 * nt + r] = pack_bf16(p[0], p[1]);
        }
#pragma unroll
      for (int n = 0; n < kOC / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V: B fragments by ldmatrix.trans from V rows (keys) x d; the
      // matrix lane / 8 of each: keys 0-7 | 8-15 (bit 0) x d 0-7 | 8-15 (bit
      // 1) of a 16-column step
      if constexpr (L::kQuant) {
        // this warp's 16 int8 rows to bf16: lane -> row lane % 16, d oc0 +
        // kOC / 2 (lane / 16) .., kOC / 32 chunks of 16 codes (chunk x: box x / 8)
        const int r = lane & 15, half = lane >> 4;
        const uint32_t dst = conv + r * L::kConvStride + kOC * half;
#pragma unroll
        for (int it = 0; it < kOC / 32; ++it) {
          const int x = oc0 / 16 + kOC / 32 * half + it;
          const uint4 c = lds_u128(swz(stage + L::kV + (x / 8) * L::kBox, 16 * wk + r, x % 8));
          uint32_t b[8];
          i8x4_to_bf16(c.x, b[0], b[1]);
          i8x4_to_bf16(c.y, b[2], b[3]);
          i8x4_to_bf16(c.z, b[4], b[5]);
          i8x4_to_bf16(c.w, b[6], b[7]);
          sts_u128(dst + 32 * it, b[0], b[1], b[2], b[3]);
          sts_u128(dst + 32 * it + 16, b[4], b[5], b[6], b[7]);
        }
        __syncwarp();
        const uint32_t vaddr = conv + (vr - 16 * wk) * L::kConvStride + (lane >> 4) * 16;
#pragma unroll
        for (int p2 = 0; p2 < kOC / 16; ++p2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(vaddr + 32 * p2, b0, b1, b2, b3);
          mma16816(o[2 * p2], pa, b0, b1);
          mma16816(o[2 * p2 + 1], pa, b2, b3);
        }
      } else {
#pragma unroll
        for (int p2 = 0; p2 < kOC / 16; ++p2) {
          const int c16 = oc0 / 16 + p2;            // the step's 16 columns / 16
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(swz(stage + L::kV + (c16 / 4) * L::kBox, vr, 2 * (c16 % 4) + (lane >> 4)),
                        b0, b1, b2, b3);
          mma16816(o[2 * p2], pa, b0, b1);
          mma16816(o[2 * p2 + 1], pa, b2, b3);
        }
      }
    }
    __syncwarp();                      // every lane is done with the stage (and conv)
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  named_bar_sync(1, 32 * kWarps);      // every consumer warp is done with the ring
  float* wacc = reinterpret_cast<float*>(smem + L::kWarpAcc) + w * kMaxRep * kAccStride;
  float* wm = reinterpret_cast<float*>(smem + L::kWarpM) + w * kMaxRep;
  float* wl = reinterpret_cast<float*>(smem + L::kWarpL) + w * kMaxRep;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = gq + 8 * r;
    if (h < rep) {
#pragma unroll
      for (int n = 0; n < kOC / 8; ++n)
        *reinterpret_cast<float2*>(wacc + h * kAccStride + oc0 + 8 * n + 2 * tq) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (tq == 0) {
        wm[h] = m[r];
        wl[h] = l[r];
      }
    }
  }
  named_bar_sync(1, 32 * kWarps);
  // the CTA's partial state: the warps merged in warp order, the (head, dim)
  // pairs spread over the consumer threads (sliced: the 4 warps of the
  // column's group)
  const float* wacc0 = reinterpret_cast<const float*>(smem + L::kWarpAcc);
  const float* wm0 = reinterpret_cast<const float*>(smem + L::kWarpM);
  const float* wl0 = reinterpret_cast<const float*>(smem + L::kWarpL);
  float* cacc = reinterpret_cast<float*>(smem + L::kCtaAcc);
  float* cm = reinterpret_cast<float*>(smem + L::kCtaM);
  float* cl = reinterpret_cast<float*>(smem + L::kCtaL);
  for (int idx = threadIdx.x; idx < rep * kD; idx += 32 * kWarps) {
    const int h = idx / kD, d = idx % kD;
    constexpr int kMerged = kSliced ? 4 : kWarps;
    const int w0 = kSliced ? 4 * (d / kOC) : 0;
    float mw[kMerged], M = kNegInf;
#pragma unroll
    for (int q = 0; q < kMerged; ++q) {
      mw[q] = wm0[(w0 + q) * kMaxRep + h];
      M = fmaxf(M, mw[q]);
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int q = 0; q < kMerged; ++q) {
      const float wt = ex2(mw[q] - M);
      den += wt * wl0[(w0 + q) * kMaxRep + h];
      num += wt * wacc0[((w0 + q) * kMaxRep + h) * kAccStride + d];
    }
    cacc[h * kAccStride + d] = num;
    if (d == 0) {
      cm[h] = M;
      cl[h] = den;
    }
  }
}

template <typename T, int kD, bool kSliced>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(const __grid_constant__ DecodeArgs a) {
  using L = Layout<T, kD>;
  constexpr int kStages = L::kStages;
  constexpr int kAccStride = L::kAccStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using R = Ring<T, kD, kSliced>;
  __shared__ __align__(8) uint64_t bars[R::kFull + kStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();      // the cluster spans grid x
  const int n_split = (int)cluster.num_blocks();
  // grid y: kv head g, or (sliced) kv head g's column slice sl
  const int g = kSliced ? blockIdx.y / a.slices : blockIdx.y, s = blockIdx.z;
  const int sl = kSliced ? blockIdx.y % a.slices : 0;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * R::kFull;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kFull; ++i) mbar_init(full0 + 8 * i, 1);   // the producer's expect_tx
    // one arrive per warp of the consuming group (sliced: of both groups)
    for (int i = 0; i < kStages; ++i) mbar_init(empty0 + 8 * i, kSliced ? kWarps : 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // launched as a programmatic dependent of the stream's previous kernel:
  // the set-up above overlaps its tail; nothing it wrote is read before this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int len = a.lengths[s];
  // at least one block (a zero-length slot masks every key -> 0), and never
  // past the allocated cache, whatever the length says
  const int nblocks = min(max((len + kBlock - 1) / kBlock, 1), a.Lalloc / kBlock);
  const int chunk = (nblocks + n_split - 1) / n_split;
  const int j_lo = min(nblocks, rank * chunk);
  const int j_hi = min(nblocks, j_lo + chunk);     // may be empty: state (-inf, 0, 0)

  __syncthreads();
  if (threadIdx.x >= 32 * kWarps) {
    if (threadIdx.x == 32 * kWarps)
      producer<T, kD, kSliced>(a, base, full0, empty0, s, g, sl, j_lo, j_hi);
  } else {
    consumer<T, kD, kSliced>(a, smem, base, full0, empty0, s, g, len, j_lo, j_hi);
  }

  cluster.sync();                              // every rank's partial state is written
  if (threadIdx.x < kD && (!kSliced || kD * sl + (int)threadIdx.x < a.D)) {
    const int d = threadIdx.x;
    const float* cacc = reinterpret_cast<const float*>(smem + L::kCtaAcc);
    const float* cm = reinterpret_cast<const float*>(smem + L::kCtaM);
    const float* cl = reinterpret_cast<const float*>(smem + L::kCtaL);
    for (int h = rank; h < a.rep; h += n_split) {
      // every rank's state of head h, loaded at once (one round trip of
      // distributed shared memory), then added in rank order; the padding
      // entries (-inf, 0, 0) add exact zeros
      float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mr[r] = kNegInf;
        lr[r] = ar[r] = 0.f;
        if (r < n_split) {
          mr[r] = *cluster.map_shared_rank(cm + h, r);
          lr[r] = *cluster.map_shared_rank(cl + h, r);
          ar[r] = *cluster.map_shared_rank(cacc + h * kAccStride + d, r);
        }
      }
      float M = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) M = fmaxf(M, mr[r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float wt = ex2(mr[r] - M);
        den += wt * lr[r];
        num += wt * ar[r];
      }
      a.o[s * a.sos + (g * a.rep + h) * a.soh + kD * sl + d] =
          __float2bfloat16(den == 0.f ? 0.f : num / den);
    }
  }
  cluster.sync();                              // no CTA leaves while another reads it
}

// ------------------------------------------------------------------ host

// A tensor map of one stacked cache ([layers,] S, Lalloc, Hkv, D) as the 5-D
// (D, Hkv, Lalloc, S, layers), boxes of 128 bytes x 1 head x 64 rows.
inline int encode_cache(CUtensorMap* map, const void* ptr, bool quant, const DecodeShape& sh,
                        long long sl, long long ss, long long st, long long shd) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrEncode;
  const int esize = quant ? 1 : 2;
  const cuuint64_t dims[5] = {(cuuint64_t)sh.D, (cuuint64_t)sh.Hkv, (cuuint64_t)sh.Lalloc,
                              (cuuint64_t)sh.S, (cuuint64_t)sh.n_layers};
  // an unstacked cache: one layer, its stride that of the whole cache
  const long long layer_stride = sh.n_layers > 1 ? sl : ss * sh.S;
  const cuuint64_t strides[4] = {(cuuint64_t)(shd * esize), (cuuint64_t)(st * esize),
                                 (cuuint64_t)(ss * esize), (cuuint64_t)(layer_stride * esize)};
  const cuuint32_t box[5] = {(cuuint32_t)(128 / esize), 1, (cuuint32_t)kBlock, 1, 1};
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  5, const_cast<void*>(ptr), dims, strides, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <typename T, int kD, bool kSliced = false>
int launch(const DecodeArgs& a, int S, int n_split, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, kD, kSliced>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<T, kD>::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, a.Hkv * (kSliced ? a.slices : 1), S);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Layout<T, kD>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the CTAs may be scheduled while the previous kernel drains; they wait
  // for it (griddepcontrol.wait) before reading anything
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<T, kD, kSliced>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The head dims the kernels take: every multiple of 128, as the JAX package
// routes its decode kernel (ops/decode_attention.py KERNEL_HEAD_DIM_UNIT);
// instances of 128 and 256 columns, and above 256 the sliced one.
inline bool bad_shape(const DecodeShape& sh) {
  const int n = sh.n_split;
  return sh.S <= 0 || sh.D <= 0 || sh.D % 128 != 0 || sh.Hkv <= 0 || sh.H % sh.Hkv != 0 ||
         sh.H / sh.Hkv > kMaxRep || sh.Lalloc <= 0 || sh.Lalloc % kBlock != 0 || n < 1 ||
         n > kMaxCluster || (n & (n - 1)) != 0 || sh.n_layers < 1;
}

}  // namespace socio_decode

// The K and V tensor maps of the stacked caches k and v (bf16, or int8 where
// `quant`) of the DecodeShape at `shape`, written as two CUtensorMaps (256
// bytes) to `maps`: once a buffer, since the engine's caches live across
// decode steps.
extern "C" int socio_paged_decode_encode(int quant, const void* k, const void* v,
                                         const void* shape, void* maps) {
  using namespace socio_decode;
  const DecodeShape& sh = *static_cast<const DecodeShape*>(shape);
  if (bad_shape(sh)) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap m[2];
  int rc = encode_cache(&m[0], k, quant != 0, sh, sh.skl, sh.sks, sh.skt, sh.skh);
  if (rc == 0) rc = encode_cache(&m[1], v, quant != 0, sh, sh.svl, sh.svs, sh.svt, sh.svh);
  if (rc == 0) memcpy(maps, m, sizeof(m));
  return rc;
}

// Kernels 3 (quant = 0: bf16 k/v) and 3q (quant = 1: int8 k/v, f32 scales
// ks/vs of the layer) over layer `layer` of the caches whose tensor maps
// socio_paged_decode_encode wrote to `maps`.
extern "C" int socio_paged_decode(int quant, const void* q, const void* maps, const void* ks,
                                  const void* vs, void* o, const void* lengths, int layer,
                                  const void* shape, void* stream) {
  using namespace socio_decode;
  const DecodeShape& sh = *static_cast<const DecodeShape*>(shape);
  if (bad_shape(sh) || layer < 0 || layer >= sh.n_layers) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  memcpy(&a.kmap, maps, sizeof(CUtensorMap));
  memcpy(&a.vmap, static_cast<const char*>(maps) + sizeof(CUtensorMap), sizeof(CUtensorMap));
  a.q = static_cast<const bf16*>(q);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.o = static_cast<bf16*>(o);
  a.lengths = static_cast<const int*>(lengths);
  a.Hkv = sh.Hkv;
  a.rep = sh.H / sh.Hkv;
  a.Lalloc = sh.Lalloc;
  a.layer = layer;
  a.sqs = sh.sqs;
  a.sqh = sh.sqh;
  a.skss = sh.skss;
  a.sksh = sh.sksh;
  a.svss = sh.svss;
  a.svsh = sh.svsh;
  a.sos = sh.sos;
  a.soh = sh.soh;
  a.scale = sh.scale;
  a.D = sh.D;
  a.slices = socio90::head_dim_slices(sh.D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sh.D > 256)
    return quant ? launch<int8_t, 256, true>(a, sh.S, sh.n_split, st)
                 : launch<bf16, 256, true>(a, sh.S, sh.n_split, st);
  if (sh.D == 256)
    return quant ? launch<int8_t, 256>(a, sh.S, sh.n_split, st)
                 : launch<bf16, 256>(a, sh.S, sh.n_split, st);
  return quant ? launch<int8_t, 128>(a, sh.S, sh.n_split, st)
               : launch<bf16, 128>(a, sh.S, sh.n_split, st);
}
