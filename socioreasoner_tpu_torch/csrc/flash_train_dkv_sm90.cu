// Training backward of flash attention: dk and dv, a Hopper kernel.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention_bwd.py
// `_dkv_kernel` (reached through `_flash_bwd_rule`, the VJP of
// `flash_attention_trainable`). It recomputes the probabilities from the
// forward's per-row log-sum-exp, by the Pallas kernels' formula:
//   p  = exp(q k^T * scale - lse)  where the mask holds, else 0
//   ds = p * (dO v^T - delta) * scale,   delta = rowsum(dO * O) (f32, given)
//   dk = sum ds^T q      dv = sum p^T dO
// summed over the q rows and the rep = H / Hkv q heads of each kv head, with
// bf16 operands and f32 accumulators; p and ds are rounded to bf16 before
// their products, as the Pallas kernel casts them. The mask is key < kv_len,
// key <= t when causal, and t < Lq. Query rows >= kv_len are real rows: they
// attend to the keys < kv_len and feed dk/dv (no kv_len clamp on the q side).
//
// What bounds it on the H100: at the train shape (B = 4, L = 2304, 16 q / 2
// kv heads, D = 128, kv lengths 2304/2080/1000/1) it does four 64 x 128 x 128
// products per (128-key, 64-row, one q head) tile pair -- 1.16e11 FLOP, 0.118
// ms at the bf16 peak -- over ~85 MB of operands (0.025 ms at the memory
// rate): tensor-core bound, and then bound by how evenly that work spreads
// over the 132 SMs.
//
// The design:
//   * A work item owns 128 keys of one (batch row, kv head) as two consumer
//     warpgroups of 64 keys; each keeps its dK and dV (64 x D f32, D / 2 +
//     D / 2 registers a thread) in registers over the item's loop, which
//     streams q tiles of 64 rows for the item's (q head, q tile) pairs.
//   * Instances of 64, 128 and 256 columns (Smem<kD>: tiles, the workspace
//     slot and the kD / 64 column chunks of every product and load); at 64
//     the accumulators halve. A head dim d that is a multiple of 8 up to 256
//     runs on the smallest one that covers it (kernel 5's rule): TMA fills the
//     columns past d with zeros, so dK and dV get 0 there, and neither the
//     workspace slots nor the outputs take those columns. The host pads
//     other head dims to a multiple of 8; above 256 the sliced kernel takes
//     them. The piece order, and so the bits, do not depend on d.
//   * At 256 columns dK and dV of 64 keys are 256 registers a thread, so the
//     item's 128 keys are walked as two 64-key passes, each streaming the
//     item's pairs again, and the two consumer warpgroups split the columns:
//     both compute the pass's S^T and dP^T over all 256 columns (the same
//     64 x 64 tiles), and each keeps dK and dV of the 64 keys for its 128
//     columns (128 registers). A pass loads its 64-key K and V (32 KB each)
//     beside a 2-stage Q/dO ring of 64-row tiles (2 x 64 KB): 193 KB. A
//     split tile's pieces write both passes' partials to their slots and
//     count in once, after the second; the last piece adds each pass's
//     slots in piece order.
//   * Above 256 columns (SliceSmem) the column slices of 256 go to a grid
//     axis: CTA c is the plan's CTA c / slices and slice c % slices, which
//     walks the plan CTA's items as the 256 instance does (two passes, the
//     warpgroups splitting the slice's columns), summing each pair's S^T
//     and dP^T over d / 64 chunk stages of a ring (the 64-column chunks of
//     the pass's K and V and the pair's Q and dO, 32 KB), the same order in
//     every slice, then taking the pair's Q and dO columns of its slice for
//     dV and dK. A plan holds a slot region and counters a slice (the host
//     cuts its share of the SMs for n_sm / slices CTAs); the piece order is
//     kept, so the bits do not depend on the slice count.
//   * S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in shared
//     memory, K-major over D (kernel 2's Q K^T with the roles swapped). P^T
//     and dS^T are rounded to bf16 in registers -- the accumulator layout is
//     the A-operand layout -- and are the A operands of dV += P^T dO and
//     dK += dS^T Q, with dO and Q MN-major from the same shared tiles. Nothing
//     of S, P, dP or dS touches shared memory.
//   * A producer warp loads the item's K and V once (TMA) and keeps the Q, dO,
//     lse and delta tiles of the next q tiles in flight in a 4-stage mbarrier
//     ring: Q and dO by TMA through their (B, L, H, D) strides, one q head a
//     box; lse and delta, (B, H, Lq) f32 rows of any length, by 4-byte
//     cp.async with zero fill past Lq, which arrive on the same barrier.
//   * Balance. The causal loop gives key tile kt (36 - 2 kt) x 8 tile pairs at
//     L = 2304: one item per key tile would leave the heaviest at 288 pairs,
//     2.5x the even share of 15,200 / 132 = 115, and alone ~0.32 ms at an SM's
//     share of the peak. So the host (ops/flash_attention_bwd.py
//     dkv_tile_plan) lays all key tiles' pairs end to end and cuts them into
//     consecutive shares of ceil(15,200 / 132) = 116 pairs, one a persistent
//     CTA: a key tile that a cut crosses becomes pieces on neighbouring CTAs,
//     no piece exceeds the share, and no CTA does more than one pair above
//     the even share (even pieces of each tile, dealt heaviest first to the
//     least-loaded CTA, pack worse: pieces near half a share leave gaps).
//     Key tiles at or past kv_len get an item with no pairs, which writes
//     their zeros.
//   * The pieces of a split key tile add up deterministically: each writes its
//     f32 partials to its own workspace slot, then counts itself on the tile's
//     arrival counter; the last to arrive adds the slots in piece order (its
//     own from registers), rounds to bf16, stores, and resets the counter for
//     the next launch. No f32 atomics into the output, so two runs give the
//     same bits.
//   * The mask is evaluated only on the pairs that need it: the two q tiles on
//     the causal diagonal, the key tile holding kv_len (or Lk), and the q tile
//     holding Lq. Every mbarrier wait traps after ~10 s instead of hanging.
//   * The plan was built on the host from some kv lengths; the call passes
//     its own. Each item's kv_len is held to clamp(kv_lens[b], 0, Lk) on the
//     device, and a difference traps (a launch error), so a plan built for
//     other lengths never gives dk/dv silently, at no host synchronisation.
#include "sm90_common.cuh"

namespace socio90 {
namespace dkv {

constexpr int kBK = 128;          // keys per work item (2 consumer warpgroups x 64)
constexpr int kBQ = 64;           // query rows per step of the loop
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim kD (64, 128 or 256; offsets from a
// 1024-byte-aligned base). Operand tiles are kD / 64 chunks of 64 columns
// with a 128-byte swizzle, each starting on a 1024-byte boundary.
template <int kD>
struct Smem {
  // at 256 columns the consumer warpgroups split the columns and walk the
  // item's keys in two passes of 64
  static constexpr bool kSplitD = kD > 128;
  static constexpr int kPasses = kSplitD ? 2 : 1;
  static constexpr int kKeys = kBK / kPasses;            // keys of K and V a pass
  static constexpr int kCols = kSplitD ? kD / 2 : kD;    // dK/dV columns of a warpgroup
  static constexpr int kStages = kSplitD ? 2 : 4;        // Q / dO / lse / delta ring depth
  static constexpr uint32_t kKVChunk = kKeys * 64 * 2;   // kKeys rows x 64 columns
  static constexpr uint32_t kKVBytes = kKeys * kD * 2;   // a pass's K (or V) tile
  static constexpr uint32_t kQChunk = kBQ * 64 * 2;      // 8 KB
  static constexpr uint32_t kQBytes = kBQ * kD * 2;      // a Q (or dO) tile
  static constexpr uint32_t kOffK = 0;
  static constexpr uint32_t kOffV = kKVBytes;
  static constexpr uint32_t kOffQ = 2 * kKVBytes;
  static constexpr uint32_t kOffDO = kOffQ + kStages * kQBytes;
  static constexpr uint32_t kOffStats = kOffDO + kStages * kQBytes;   // per stage: lse, delta
  static constexpr uint32_t kOffBar = kOffStats + kStages * 2 * kBQ * 4;
  // barriers: K/V full, K/V empty, then full[kStages], empty[kStages]
  static constexpr uint32_t kOffFlag = kOffBar + (2 + 2 * kStages) * 8;   // an int a warpgroup
  static constexpr uint32_t kBytes = kOffFlag + 16 + 1024;               // + alignment slack
  static_assert(kBytes <= 232448, "the H100's shared memory a block");
  // dK (and dV) accumulator registers a consumer thread holds: 64 keys x kCols
  static constexpr int kRegs = kCols / 64 * 32;
  // One workspace slot: a piece's f32 partial dK and dV of 128 keys x kD
  // (passes x two warpgroups x dK and dV x kRegs registers x 128 threads).
  static constexpr int kSlotFloats = kBK * kD * 2;
  static_assert(kSlotFloats == kPasses * 2 * 2 * kRegs * 128, "slot regions");
};

struct Params {
  CUtensorMap q, k, v, dO;   // 64-column boxes: q/dO one head x 64 tokens, k/v one head x a pass
  const float* lse;          // (B, H, Lq)
  const float* delta;        // (B, H, Lq)
  bf16* dk;
  bf16* dv;
  long long sdkb, sdkt, sdkh, sdvb, sdvt, sdvh;
  int d;                     // the tensors' head dim: columns stored (<= kD)
  int slices;                // column slices of 256 (head_dim_slices): above 1, the sliced kernel
  float* ws;                 // (slots, kSlotFloats) partials of split pieces
  int* counters;             // (2 x split tiles,) arrival counts, 0 between launches
  const int4* items;         // (n_items, 3) int4: dkv_tile_plan's 12 fields, in CTA order
  const int* cta_start;      // (grid + 1,) CTA c walks items cta_start[c] .. cta_start[c+1] - 1
  const int* kv_lens;        // (B,) the call's lengths, which the plan's must equal
  int Lq, Lk, H, rep, causal;
  float scale, scale_log2;   // D^-0.5 and D^-0.5 * log2(e)
};

// A work item, as dkv_tile_plan lays it out: pairs p0 .. p0 + np - 1 of key
// tile kt of (b, g), pair p being q head g * rep + p / cnt and q tile
// i_lo + p % cnt; piece j of n (split tiles: arrival counter `split`,
// workspace slots ws0 .. ws0 + n - 1); kv_len of batch row b.
struct Item {
  int b, g, kt, i_lo, cnt, p0, np, j, n, split, ws0, kv_len;
};

__device__ __forceinline__ Item load_item(const Params& p, int idx) {
  const int4 a = p.items[3 * idx], c = p.items[3 * idx + 1], d = p.items[3 * idx + 2];
  return {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int st) { return bars + 8 * (2 + st); }
template <int kStages>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int st) {
  return bars + 8 * (2 + kStages + st);
}

// ------------------------------------------------------------- producer

template <int kD>
__device__ __forceinline__ void producer(const Params& p, uint32_t base, int lane) {
  using L = Smem<kD>;
  constexpr int kStages = L::kStages;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  int st = 0;
  uint32_t ph = 0, kvph = 0;
  for (int idx = p.cta_start[blockIdx.x]; idx < p.cta_start[blockIdx.x + 1]; ++idx) {
    const Item it = load_item(p, idx);
    if (it.np == 0) continue;          // a key tile without pairs loads nothing
    for (int ps = 0; ps < L::kPasses; ++ps) {
      if (lane == 0) {
        mbar_wait(kv_empty, kvph ^ 1);
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        const int key = it.kt * kBK + ps * L::kKeys;
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          const uint32_t off = c * L::kKVChunk;
          tma_load_4d(base + L::kOffK + off, &p.k, kv_full, 64 * c, it.g, key, it.b);
          tma_load_4d(base + L::kOffV + off, &p.v, kv_full, 64 * c, it.g, key, it.b);
        }
      }
      kvph ^= 1;
      for (int q = it.p0; q < it.p0 + it.np; ++q) {
        const int h = it.g * p.rep + q / it.cnt;
        const int t0 = (it.i_lo + q % it.cnt) * kBQ;
        const uint32_t full = full_bar(bars, st);
        mbar_wait(empty_bar<kStages>(bars, st), ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * L::kQBytes);
#pragma unroll
          for (int c = 0; c < kD / 64; ++c) {
            const uint32_t off = st * L::kQBytes + c * L::kQChunk;
            tma_load_4d(base + L::kOffQ + off, &p.q, full, 64 * c, h, t0, it.b);
            tma_load_4d(base + L::kOffDO + off, &p.dO, full, 64 * c, h, t0, it.b);
          }
        }
        // lse and delta of rows t0 .. t0 + 63, two a lane; rows past Lq read
        // nothing and land as zeros
        const long long row = ((long long)it.b * p.H + h) * p.Lq;
        const uint32_t stats = base + L::kOffStats + st * 2 * kBQ * 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e;
          const bool in = t0 + r < p.Lq;
          const long long src = row + (in ? t0 + r : 0);
          cp_async4(stats + 4 * r, p.lse + src, in ? 4u : 0u);
          cp_async4(stats + 4 * (kBQ + r), p.delta + src, in ? 4u : 0u);
        }
        cp_async_arrive_noinc(full);
        if (++st == kStages) { st = 0; ph ^= 1; }
      }
    }
  }
}

// ------------------------------------------------------------- consumer

// Rows key_base and key_base + 8 of acc (kC chunks of 64 columns from column
// col0) as bf16 pairs, straight from registers; rows past Lk and, with kPart,
// columns past d are not written.
template <int kC, bool kPart>
__device__ __forceinline__ void store_rows(bf16* out, long long sb, long long st, long long sh,
                                           const Item& it, int key_base, int col0, int Lk, int d,
                                           int cq, const float (&acc)[kC][32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_base + 8 * i;
    if (key >= Lk) continue;
    bf16* dst = out + it.b * sb + key * st + it.g * sh + col0;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        if (!kPart || col0 + 64 * c + 8 * g < d)
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * g + cq) =
              pack_bf16(acc[c][4 * g + 2 * i], acc[c][4 * g + 2 * i + 1]);
  }
}

// kPart: the tensors' head dim p.d is below kD; the columns past it go to
// neither the workspace slots nor the outputs.
template <int kD, bool kPart>
__device__ __forceinline__ void consumer(const Params& p, uint32_t base, volatile int* flag,
                                         int wg) {
  using L = Smem<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kC = L::kCols / 64;                    // dK/dV column chunks of a warpgroup
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;                       // the thread's column pair in an 8-group
  // its key rows krow, krow + 8 of the pass's K tile: the warpgroup's own 64
  // of the 128 keys, or at 256 columns the pass's 64, which both share
  const int krow = (L::kSplitD ? 0 : wg * 64) + warp * 16 + (lane >> 2);
  const int c0 = L::kSplitD ? wg * kC : 0;             // the warpgroup's first dK/dV chunk
  const uint32_t bars = base + L::kOffBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  const uint32_t kb = base + L::kOffK + (L::kSplitD ? 0 : wg * 8192);
  const uint32_t vb = base + L::kOffV + (L::kSplitD ? 0 : wg * 8192);
  int st = 0;
  uint32_t ph = 0, kvph = 0;

  for (int idx = p.cta_start[blockIdx.x]; idx < p.cta_start[blockIdx.x + 1]; ++idx) {
    const Item it = load_item(p, idx);
    if (it.kv_len != min(max(p.kv_lens[it.b], 0), p.Lk)) __trap();   // a plan for other lengths
    for (int ps = 0; ps < L::kPasses; ++ps) {
      const int kp0 = it.kt * kBK + ps * L::kKeys;     // the pass's first key
      const int key0 = kp0 + krow;
      float dk[kC][32], dv[kC][32];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;

      if (it.np > 0) {
        mbar_wait(kv_full, kvph);
        for (int q = it.p0; q < it.p0 + it.np; ++q) {
          const int t0 = (it.i_lo + q % it.cnt) * kBQ;
          const bool masked = (p.causal && t0 < kp0 + L::kKeys - 1) ||
                              kp0 + L::kKeys > it.kv_len || t0 + kBQ > p.Lq;
          const uint32_t qb = base + L::kOffQ + st * L::kQBytes;
          const uint32_t ob = base + L::kOffDO + st * L::kQBytes;
          const uint32_t stats = base + L::kOffStats + st * 2 * kBQ * 4;
          mbar_wait(full_bar(bars, st), ph);

          // S^T = K Q^T and dP^T = V dO^T over the whole head dim, one group each
          float s[32], dp[32];
          wg_fence();
#pragma unroll
          for (int c = 0; c < kD / 64; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64(s, make_desc(kb + c * L::kKVChunk + kk * 32, 16, 1024, kSw128),
                           make_desc(qb + c * L::kQChunk + kk * 32, 16, 1024, kSw128),
                           (c | kk) != 0);
          wg_commit();
#pragma unroll
          for (int c = 0; c < kD / 64; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64(dp, make_desc(vb + c * L::kKVChunk + kk * 32, 16, 1024, kSw128),
                           make_desc(ob + c * L::kQChunk + kk * 32, 16, 1024, kSw128),
                           (c | kk) != 0);
          wg_commit();

          // p = exp2(s * scale log2 e - lse log2 e), 0 where the mask fails;
          // element 4g + 2i + e is key row krow + 8i, q row t0 + 8g + cq + e
          wg_wait1();
          reg_fence(s);
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const float2 l = lds_f2(stats + 4 * (8 * g + cq));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              s[4 * g + 2 * i] = ex2(fmaf(s[4 * g + 2 * i], p.scale_log2, -l.x * kLog2e));
              s[4 * g + 2 * i + 1] = ex2(fmaf(s[4 * g + 2 * i + 1], p.scale_log2, -l.y * kLog2e));
            }
          }
          if (masked) {
#pragma unroll
            for (int g = 0; g < 8; ++g)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int t = t0 + 8 * g + cq + e;
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  const int key = key0 + 8 * i;
                  if (key >= it.kv_len || t >= p.Lq || (p.causal && key > t))
                    s[4 * g + 2 * i + e] = 0.f;
                }
              }
          }
          // ds = p (dp - delta) scale (0 where p is)
          wg_wait0();
          reg_fence(dp);
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const float2 d = lds_f2(stats + 4 * (kBQ + 8 * g + cq));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              dp[4 * g + 2 * i] = s[4 * g + 2 * i] * (dp[4 * g + 2 * i] - d.x) * p.scale;
              dp[4 * g + 2 * i + 1] =
                  s[4 * g + 2 * i + 1] * (dp[4 * g + 2 * i + 1] - d.y) * p.scale;
            }
          }
          // P^T and dS^T in bf16 as the A fragments of four k16 steps (q rows
          // 16kk .. 16kk + 15)
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
              da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
            }
          // dV += P^T dO, dK += dS^T Q over the warpgroup's columns: one group
          wg_fence();
#pragma unroll
          for (int c = 0; c < kC; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_n64(dv[c], pa[kk],
                           make_desc(ob + (c0 + c) * L::kQChunk + kk * 2048, L::kQChunk, 1024,
                                     kSw128));
#pragma unroll
          for (int c = 0; c < kC; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_n64(dk[c], da[kk],
                           make_desc(qb + (c0 + c) * L::kQChunk + kk * 2048, L::kQChunk, 1024,
                                     kSw128));
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            reg_fence(dk[c]);
            reg_fence(dv[c]);
          }
          reg_keep(pa);
          reg_keep(da);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar<kStages>(bars, st));
          if (++st == kStages) { st = 0; ph ^= 1; }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty);      // the pass's last use of K and V
        kvph ^= 1;
      }

      if (it.n == 1) {
        store_rows<kC, kPart>(p.dk, p.sdkb, p.sdkt, p.sdkh, it, key0, 64 * c0, p.Lk, p.d, cq, dk);
        store_rows<kC, kPart>(p.dv, p.sdvb, p.sdvt, p.sdvh, it, key0, 64 * c0, p.Lk, p.d, cq, dv);
        continue;
      }
      // a piece of a split key tile: the pass's partials to its region of
      // slot ws0 + j (thread-major, so each store is coalesced); after the
      // last pass, count in; the last piece adds slots ws0 .. ws0 + n - 1 in
      // order, pass by pass. Register e of chunk c holds column 64 (c0 + c)
      // + 8 (e / 4) + ..: those past d are 0 and skipped.
      auto region = [&](int pass) {   // this (pass, warpgroup)'s part of a slot
        return (pass * 2 + wg) * 2 * L::kRegs * 128;
      };
      auto skip = [&](int c, int e) { return kPart && 64 * (c0 + c) + 8 * (e >> 2) >= p.d; };
      float* mine = p.ws + (long long)(it.ws0 + it.j) * L::kSlotFloats + region(ps);
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (skip(c, e)) continue;
          __stcg(mine + (32 * c + e) * 128 + tid, dk[c][e]);
          __stcg(mine + (L::kRegs + 32 * c + e) * 128 + tid, dv[c][e]);
        }
      if (ps + 1 < L::kPasses) continue;
      __threadfence();
      named_bar_sync(1 + wg, 128);
      int* counter = p.counters + 2 * it.split + wg;
      if (tid == 0) flag[wg] = atomicAdd(counter, 1);
      named_bar_sync(1 + wg, 128);
      if (flag[wg] != it.n - 1) continue;
      __threadfence();
      // this pass first, its own partials still in registers; earlier passes'
      // all from the slots
      for (int pp = ps; pp >= 0; --pp) {
        const float* first = p.ws + (long long)it.ws0 * L::kSlotFloats + region(pp);
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (skip(c, e)) continue;
            float a = 0.f, b = 0.f;
            for (int piece = 0; piece < it.n; ++piece) {
              const float* slot = first + (long long)piece * L::kSlotFloats;
              const bool own = piece == it.j && pp == ps;
              a += own ? dk[c][e] : __ldcg(slot + (32 * c + e) * 128 + tid);
              b += own ? dv[c][e] : __ldcg(slot + (L::kRegs + 32 * c + e) * 128 + tid);
            }
            dk[c][e] = a;
            dv[c][e] = b;
          }
        const int kb0 = it.kt * kBK + pp * L::kKeys + krow;
        store_rows<kC, kPart>(p.dk, p.sdkb, p.sdkt, p.sdkh, it, kb0, 64 * c0, p.Lk, p.d, cq, dk);
        store_rows<kC, kPart>(p.dv, p.sdvb, p.sdvt, p.sdvh, it, kb0, 64 * c0, p.Lk, p.d, cq, dv);
      }
      if (tid == 0) *counter = 0;               // ready for the next launch
    }
  }
}

// ---------------------------------------------------------------- kernel

template <int kD, bool kPart>
__global__ void __launch_bounds__(kThreads, 1)
    flash_train_dkv_kernel(const __grid_constant__ Params p) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kOffBar;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                     // K/V full: the producer's expect_tx
    mbar_init(bars + 8, 8);                 // K/V empty: one arrive per consumer warp
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full_bar(bars, s), 1 + 32);   // expect_tx + the producer lanes' cp.async
      mbar_init(empty_bar<L::kStages>(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) producer<kD>(p, base, threadIdx.x & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    volatile int* flag = reinterpret_cast<volatile int*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                         L::kOffFlag);
    consumer<kD, kPart>(p, base, flag, wg);
  }
}

// One launch of the kD instance over n_cta persistent CTAs (guarding its
// column stores where p.d < kD).
template <int kD, bool kPart>
int launch(const Params& p, int n_cta, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_train_dkv_kernel<kD, kPart>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<kD>::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  flash_train_dkv_kernel<kD, kPart><<<n_cta, kThreads, Smem<kD>::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// -------------------------------------------- column slices (D > 256)

// Shared-memory layout of the sliced kernel, whose CTA keeps the 256
// instance's split: two 64-key passes a work item, each consumer warpgroup
// holding dK and dV of the pass's 64 keys for its 128 columns of the CTA's
// slice. A ring of chunk stages -- the 64-column chunk of the pass's K and V
// and of a pair's 64-row Q and dO tiles, 32 KB -- feeds S^T = K Q^T and dP^T
// = V dO^T over all d columns; a ring of pair stages holds the pair's Q and
// dO columns of the slice (64 rows x 256 each) and its lse and delta, for
// dV += P^T dO and dK += dS^T Q.
struct SliceSmem {
  static constexpr int kKeys = kBK / 2;            // keys of a pass
  static constexpr int kCols = kSliceCols;         // dK/dV columns of a CTA
  static constexpr int kCS = 3;                    // chunk ring depth
  static constexpr int kPS = 2;                    // pair ring depth
  static constexpr uint32_t kChunk = 64 * 64 * 2;  // 8 KB: 64 rows (or keys) x 64 columns
  static constexpr uint32_t kOffV = kChunk, kOffQ = 2 * kChunk, kOffDO = 3 * kChunk;
  static constexpr uint32_t kStage = 4 * kChunk;   // 32 KB
  static constexpr uint32_t kPair = 2 * kCols / 64 * kChunk;   // 64 KB: Q then dO columns
  static constexpr uint32_t kOffPair = kCS * kStage;
  static constexpr uint32_t kOffStats = kOffPair + kPS * kPair;   // per pair stage: lse, delta
  static constexpr uint32_t kOffBar = kOffStats + kPS * 2 * kBQ * 4;
  // barriers: chunk full[kCS], empty[kCS], pair full[kPS], empty[kPS]
  static constexpr uint32_t kOffFlag = kOffBar + (2 * kCS + 2 * kPS) * 8;
  static constexpr uint32_t kBytes = kOffFlag + 16 + 1024;
  static_assert(kBytes <= 232448, "the H100's shared memory a block");
  static constexpr int kRegs = kCols / 2 / 64 * 32;   // dK (and dV) registers a thread
  // a slice's part of a workspace slot: 2 passes x 2 warpgroups x dK and dV
  static constexpr int kSlotFloats = kBK * kCols * 2;
  static_assert(kSlotFloats == 2 * 2 * 2 * kRegs * 128, "slot regions");
  __device__ static uint32_t c_full(uint32_t bars, int st) { return bars + 8 * st; }
  __device__ static uint32_t c_empty(uint32_t bars, int st) { return bars + 8 * (kCS + st); }
  __device__ static uint32_t p_full(uint32_t bars, int st) { return bars + 8 * (2 * kCS + st); }
  __device__ static uint32_t p_empty(uint32_t bars, int st) {
    return bars + 8 * (2 * kCS + kPS + st);
  }
};

// CTA blockIdx.x is plan CTA blockIdx.x / slices, column slice blockIdx.x %
// slices. For each pass of each item and each of its pairs, lane 0 streams
// the d / 64 chunk stages, then the pair stage (the slice's Q and dO
// columns), beside which every lane gathers the pair's lse and delta.
__device__ __forceinline__ void producer_sliced(const Params& p, uint32_t base, int lane) {
  using L = SliceSmem;
  const uint32_t bars = base + L::kOffBar;
  const int cta = blockIdx.x / p.slices, col0 = L::kCols * (blockIdx.x % p.slices);
  const int nc = (p.d + 63) / 64;
  int cs = 0, ps_ = 0;
  uint32_t cph = 0, pph = 0;
  for (int idx = p.cta_start[cta]; idx < p.cta_start[cta + 1]; ++idx) {
    const Item it = load_item(p, idx);
    for (int ps = 0; ps < 2 && it.np > 0; ++ps) {
      const int key = it.kt * kBK + ps * L::kKeys;
      for (int q = it.p0; q < it.p0 + it.np; ++q) {
        const int h = it.g * p.rep + q / it.cnt;
        const int t0 = (it.i_lo + q % it.cnt) * kBQ;
        if (lane == 0) {
          for (int c = 0; c < nc; ++c) {
            const uint32_t full = L::c_full(bars, cs), dst = base + cs * L::kStage;
            mbar_wait(L::c_empty(bars, cs), cph ^ 1);
            mbar_expect_tx(full, L::kStage);
            tma_load_4d(dst, &p.k, full, 64 * c, it.g, key, it.b);
            tma_load_4d(dst + L::kOffV, &p.v, full, 64 * c, it.g, key, it.b);
            tma_load_4d(dst + L::kOffQ, &p.q, full, 64 * c, h, t0, it.b);
            tma_load_4d(dst + L::kOffDO, &p.dO, full, 64 * c, h, t0, it.b);
            if (++cs == L::kCS) { cs = 0; cph ^= 1; }
          }
        }
        const uint32_t full = L::p_full(bars, ps_);
        const uint32_t dst = base + L::kOffPair + ps_ * L::kPair;
        mbar_wait(L::p_empty(bars, ps_), pph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, L::kPair);
#pragma unroll
          for (int c = 0; c < L::kCols / 64; ++c) {
            tma_load_4d(dst + c * L::kChunk, &p.q, full, col0 + 64 * c, h, t0, it.b);
            tma_load_4d(dst + (L::kCols / 64 + c) * L::kChunk, &p.dO, full, col0 + 64 * c, h,
                        t0, it.b);
          }
        }
        const long long row = ((long long)it.b * p.H + h) * p.Lq;
        const uint32_t stats = base + L::kOffStats + ps_ * 2 * kBQ * 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e;
          const bool in = t0 + r < p.Lq;
          const long long src = row + (in ? t0 + r : 0);
          cp_async4(stats + 4 * r, p.lse + src, in ? 4u : 0u);
          cp_async4(stats + 4 * (kBQ + r), p.delta + src, in ? 4u : 0u);
        }
        cp_async_arrive_noinc(full);
        if (++ps_ == L::kPS) { ps_ = 0; pph ^= 1; }
      }
    }
  }
}

// One consumer warpgroup of the sliced kernel: consumer<256> with S^T and dP^T
// accumulated over the chunk stages (the same order in every slice) and dK,
// dV of the warpgroup's 128 columns of the CTA's slice. Split tiles: each
// slice adds its own part of the pieces' slots and counts in on its own
// counters, in piece order as at 256.
__device__ __forceinline__ void consumer_sliced(const Params& p, uint32_t base,
                                                volatile int* flag, int wg) {
  using L = SliceSmem;
  constexpr int kC = L::kCols / 2 / 64;                // dK/dV column chunks of a warpgroup
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const int krow = warp * 16 + (lane >> 2);
  const int slice = blockIdx.x % p.slices, cta = blockIdx.x / p.slices;
  const int c0 = (L::kCols * slice) / 64 + wg * kC;    // the warpgroup's first dK/dV chunk
  const int nc = (p.d + 63) / 64;
  const uint32_t bars = base + L::kOffBar;
  int cs = 0, ps_ = 0;
  uint32_t cph = 0, pph = 0;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  for (int idx = p.cta_start[cta]; idx < p.cta_start[cta + 1]; ++idx) {
    const Item it = load_item(p, idx);
    if (it.kv_len != min(max(p.kv_lens[it.b], 0), p.Lk)) __trap();   // a plan for other lengths
    for (int ps = 0; ps < 2; ++ps) {
      const int kp0 = it.kt * kBK + ps * L::kKeys;
      const int key0 = kp0 + krow;
      float dk[kC][32], dv[kC][32];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;

      for (int q = it.p0; q < it.p0 + it.np; ++q) {
        const int t0 = (it.i_lo + q % it.cnt) * kBQ;
        const bool masked = (p.causal && t0 < kp0 + L::kKeys - 1) ||
                            kp0 + L::kKeys > it.kv_len || t0 + kBQ > p.Lq;
        float s[32], dp[32];
        int prev = 0;
        for (int c = 0; c < nc; ++c) {
          mbar_wait(L::c_full(bars, cs), cph);
          const uint32_t st = base + cs * L::kStage;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(s, make_desc(st + kk * 32, 16, 1024, kSw128),
                         make_desc(st + L::kOffQ + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dp, make_desc(st + L::kOffV + kk * 32, 16, 1024, kSw128),
                         make_desc(st + L::kOffDO + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
          wg_commit();
          if (c > 0) {
            wg_wait1();
            release(L::c_empty(bars, prev));
          }
          prev = cs;
          if (++cs == L::kCS) { cs = 0; cph ^= 1; }
        }
        wg_wait0();
        reg_fence(s);
        reg_fence(dp);
        release(L::c_empty(bars, prev));

        mbar_wait(L::p_full(bars, ps_), pph);
        const uint32_t qb = base + L::kOffPair + ps_ * L::kPair;
        const uint32_t ob = qb + L::kCols / 64 * L::kChunk;
        const uint32_t stats = base + L::kOffStats + ps_ * 2 * kBQ * 4;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float2 l = lds_f2(stats + 4 * (8 * g + cq));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[4 * g + 2 * i] = ex2(fmaf(s[4 * g + 2 * i], p.scale_log2, -l.x * kLog2e));
            s[4 * g + 2 * i + 1] = ex2(fmaf(s[4 * g + 2 * i + 1], p.scale_log2, -l.y * kLog2e));
          }
        }
        if (masked) {
#pragma unroll
          for (int g = 0; g < 8; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = t0 + 8 * g + cq + e;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int key = key0 + 8 * i;
                if (key >= it.kv_len || t >= p.Lq || (p.causal && key > t))
                  s[4 * g + 2 * i + e] = 0.f;
              }
            }
        }
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float2 d = lds_f2(stats + 4 * (kBQ + 8 * g + cq));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dp[4 * g + 2 * i] = s[4 * g + 2 * i] * (dp[4 * g + 2 * i] - d.x) * p.scale;
            dp[4 * g + 2 * i + 1] = s[4 * g + 2 * i + 1] * (dp[4 * g + 2 * i + 1] - d.y) * p.scale;
          }
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        // dV += P^T dO, dK += dS^T Q over the warpgroup's columns of the slice
        wg_fence();
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(dv[c], pa[kk],
                         make_desc(ob + (wg * kC + c) * L::kChunk + kk * 2048, L::kChunk, 1024,
                                   kSw128));
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(dk[c], da[kk],
                         make_desc(qb + (wg * kC + c) * L::kChunk + kk * 2048, L::kChunk, 1024,
                                   kSw128));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          reg_fence(dk[c]);
          reg_fence(dv[c]);
        }
        reg_keep(pa);
        reg_keep(da);
        release(L::p_empty(bars, ps_));
        if (++ps_ == L::kPS) { ps_ = 0; pph ^= 1; }
      }

      if (it.n == 1) {
        store_rows<kC, true>(p.dk, p.sdkb, p.sdkt, p.sdkh, it, key0, 64 * c0, p.Lk, p.d, cq, dk);
        store_rows<kC, true>(p.dv, p.sdvb, p.sdvt, p.sdvh, it, key0, 64 * c0, p.Lk, p.d, cq, dv);
        continue;
      }
      // a piece of a split key tile: the slice's part of slot ws0 + j (a
      // slot holds every slice's part), then its own counters, as consumer()
      const long long slot = (long long)L::kSlotFloats * p.slices;
      auto region = [&](int pass) { return slice * L::kSlotFloats + (pass * 2 + wg) * 2 * L::kRegs * 128; };
      auto skip = [&](int c, int e) { return 64 * (c0 + c) + 8 * (e >> 2) >= p.d; };
      float* mine = p.ws + (it.ws0 + it.j) * slot + region(ps);
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (skip(c, e)) continue;
          __stcg(mine + (32 * c + e) * 128 + tid, dk[c][e]);
          __stcg(mine + (L::kRegs + 32 * c + e) * 128 + tid, dv[c][e]);
        }
      if (ps == 0) continue;
      __threadfence();
      named_bar_sync(1 + wg, 128);
      int* counter = p.counters + 2 * (it.split * p.slices + slice) + wg;
      if (tid == 0) flag[wg] = atomicAdd(counter, 1);
      named_bar_sync(1 + wg, 128);
      if (flag[wg] != it.n - 1) continue;
      __threadfence();
      for (int pp = ps; pp >= 0; --pp) {
        const float* first = p.ws + it.ws0 * slot + region(pp);
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (skip(c, e)) continue;
            float a = 0.f, b = 0.f;
            for (int piece = 0; piece < it.n; ++piece) {
              const float* sl = first + piece * slot;
              const bool own = piece == it.j && pp == ps;
              a += own ? dk[c][e] : __ldcg(sl + (32 * c + e) * 128 + tid);
              b += own ? dv[c][e] : __ldcg(sl + (L::kRegs + 32 * c + e) * 128 + tid);
            }
            dk[c][e] = a;
            dv[c][e] = b;
          }
        const int kb0 = it.kt * kBK + pp * L::kKeys + krow;
        store_rows<kC, true>(p.dk, p.sdkb, p.sdkt, p.sdkh, it, kb0, 64 * c0, p.Lk, p.d, cq, dk);
        store_rows<kC, true>(p.dv, p.sdvb, p.sdvt, p.sdvh, it, kb0, 64 * c0, p.Lk, p.d, cq, dv);
      }
      if (tid == 0) *counter = 0;               // ready for the next launch
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_train_dkv_sliced_kernel(const __grid_constant__ Params p) {
  using L = SliceSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kOffBar;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kCS; ++s) {
      mbar_init(L::c_full(bars, s), 1);
      mbar_init(L::c_empty(bars, s), 8);
    }
    for (int s = 0; s < L::kPS; ++s) {
      mbar_init(L::p_full(bars, s), 1 + 32);   // expect_tx + the producer lanes' cp.async
      mbar_init(L::p_empty(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) producer_sliced(p, base, threadIdx.x & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    volatile int* flag = reinterpret_cast<volatile int*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                         L::kOffFlag);
    consumer_sliced(p, base, flag, wg);
  }
}

// n_cta plan CTAs x p.slices column slices.
int launch_sliced(const Params& p, int n_cta, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_train_dkv_sliced_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SliceSmem::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  flash_train_dkv_sliced_kernel<<<n_cta * p.slices, kThreads, SliceSmem::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace dkv
}  // namespace socio90

extern "C" int socio_flash_train_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dk, void* dv, const void* items, const void* cta_start,
    void* ws, void* counters, const void* kv_lens, int n_cta,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdob, long long sdot, long long sdoh,
    long long sdkb, long long sdkt, long long sdkh,
    long long sdvb, long long sdvt, long long sdvh,
    int causal, float scale, void* stream) {
  using namespace socio90;
  using namespace socio90::dkv;
  // the instance that serves D: 64, 128 or 256 columns
  const int inst = head_dim_instance(kBwdDims, D);
  if (inst == 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (n_cta <= 0) return 0;
  Params p{};
  p.d = D;
  p.slices = head_dim_slices(D);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sdkb = sdkb;
  p.sdkt = sdkt;
  p.sdkh = sdkh;
  p.sdvb = sdvb;
  p.sdvt = sdvt;
  p.sdvh = sdvh;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.items = static_cast<const int4*>(items);
  p.cta_start = static_cast<const int*>(cta_start);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.rep = H / Hkv;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // (D, heads, tokens, B) views, 64-column boxes of one head (columns past
  // D read as zeros): 64 tokens of q and dO, a pass's keys of k and v (128,
  // or 64 at 256 columns)
  const long long qdims[4] = {D, H, Lq, B}, kdims[4] = {D, Hkv, Lk, B};
  const long long qs[4] = {1, sqh, sqt, sqb}, ks[4] = {1, skh, skt, skb},
                  vs[4] = {1, svh, svt, svb}, os[4] = {1, sdoh, sdot, sdob};
  const int qbox[4] = {64, 1, kBQ, 1}, kbox[4] = {64, 1, inst > 128 ? kBK / 2 : kBK, 1};
  int rc = encode_map(&p.q, q, 4, qdims, qs, qbox, true);
  if (rc == 0) rc = encode_map(&p.dO, dO, 4, qdims, os, qbox, true);
  if (rc == 0) rc = encode_map(&p.k, k, 4, kdims, ks, kbox, true);
  if (rc == 0) rc = encode_map(&p.v, v, 4, kdims, vs, kbox, true);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.slices > 1) return launch_sliced(p, n_cta, s);
  switch (inst) {
    case 64: return D < 64 ? launch<64, true>(p, n_cta, s) : launch<64, false>(p, n_cta, s);
    case 128: return D < 128 ? launch<128, true>(p, n_cta, s) : launch<128, false>(p, n_cta, s);
    case 256: return D < 256 ? launch<256, true>(p, n_cta, s) : launch<256, false>(p, n_cta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
