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
//   * Instances of 64 and 128 columns (Smem<kD>: tiles, the workspace slot
//     and the kD / 64 column chunks of every product and load); at 64 the
//     accumulators halve. A head dim d that is a multiple of 8 up to 128 runs
//     on the smaller one that covers it (kernel 5's rule): TMA fills the
//     columns past d with zeros, so dK and dV get 0 there, and neither the
//     workspace slots nor the outputs take those columns. The host pads
//     other head dims up to 128 to a multiple of 8; any other D is refused.
//     The piece order, and so the bits, do not depend on d.
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
constexpr int kStages = 4;        // Q / dO / lse / delta ring depth
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim kD (64 or 128; offsets from a
// 1024-byte-aligned base). Operand tiles are kD / 64 chunks of 64 columns
// with a 128-byte swizzle, each starting on a 1024-byte boundary.
template <int kD>
struct Smem {
  static constexpr uint32_t kKVChunk = kBK * 64 * 2;     // 16 KB: 128 rows x 64 columns
  static constexpr uint32_t kKVBytes = kBK * kD * 2;     // a K (or V) tile
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
  // dK (and dV) accumulator registers a consumer thread holds: 64 keys x kD
  static constexpr int kRegs = kD / 64 * 32;
  // One workspace slot: a piece's f32 partial dK and dV of 128 keys x kD
  // (two warpgroups x dK and dV x kRegs registers x 128 threads).
  static constexpr int kSlotFloats = kBK * kD * 2;
};

struct Params {
  CUtensorMap q, k, v, dO;   // 64-column boxes: q/dO one head x 64 tokens, k/v one head x 128
  const float* lse;          // (B, H, Lq)
  const float* delta;        // (B, H, Lq)
  bf16* dk;
  bf16* dv;
  long long sdkb, sdkt, sdkh, sdvb, sdvt, sdvh;
  int d;                     // the tensors' head dim: columns stored (<= kD)
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
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int st) {
  return bars + 8 * (2 + kStages + st);
}

// ------------------------------------------------------------- producer

template <int kD>
__device__ __forceinline__ void producer(const Params& p, uint32_t base, int lane) {
  using L = Smem<kD>;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  int st = 0;
  uint32_t ph = 0, kvph = 0;
  for (int idx = p.cta_start[blockIdx.x]; idx < p.cta_start[blockIdx.x + 1]; ++idx) {
    const Item it = load_item(p, idx);
    if (it.np == 0) continue;          // a key tile without pairs loads nothing
    if (lane == 0) {
      mbar_wait(kv_empty, kvph ^ 1);
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) {
        const uint32_t off = c * L::kKVChunk;
        tma_load_4d(base + L::kOffK + off, &p.k, kv_full, 64 * c, it.g, it.kt * kBK, it.b);
        tma_load_4d(base + L::kOffV + off, &p.v, kv_full, 64 * c, it.g, it.kt * kBK, it.b);
      }
    }
    kvph ^= 1;
    for (int q = it.p0; q < it.p0 + it.np; ++q) {
      const int h = it.g * p.rep + q / it.cnt;
      const int t0 = (it.i_lo + q % it.cnt) * kBQ;
      const uint32_t full = full_bar(bars, st);
      mbar_wait(empty_bar(bars, st), ph ^ 1);
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

// ------------------------------------------------------------- consumer

// Rows key_base and key_base + 8 of acc (chunks of 64 columns) as bf16 pairs,
// straight from registers; rows past Lk and, with kPart, columns past d
// are not written.
template <int kD, bool kPart>
__device__ __forceinline__ void store_rows(bf16* out, long long sb, long long st, long long sh,
                                           const Item& it, int key_base, int Lk, int d, int cq,
                                           const float (&acc)[kD / 64][32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_base + 8 * i;
    if (key >= Lk) continue;
    bf16* dst = out + it.b * sb + key * st + it.g * sh;
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        if (!kPart || 64 * c + 8 * g < d)
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
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;                       // the thread's column pair in an 8-group
  const int krow = wg * 64 + warp * 16 + (lane >> 2);  // its key rows krow, krow + 8 of the item
  const uint32_t bars = base + L::kOffBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  const uint32_t kb = base + L::kOffK + wg * 8192, vb = base + L::kOffV + wg * 8192;
  int st = 0;
  uint32_t ph = 0, kvph = 0;

  for (int idx = p.cta_start[blockIdx.x]; idx < p.cta_start[blockIdx.x + 1]; ++idx) {
    const Item it = load_item(p, idx);
    if (it.kv_len != min(max(p.kv_lens[it.b], 0), p.Lk)) __trap();   // a plan for other lengths
    const int k0 = it.kt * kBK;
    const int key0 = k0 + krow;
    float dk[kD / 64][32], dv[kD / 64][32];
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;

    if (it.np > 0) {
      mbar_wait(kv_full, kvph);
      for (int q = it.p0; q < it.p0 + it.np; ++q) {
        const int t0 = (it.i_lo + q % it.cnt) * kBQ;
        const bool masked = (p.causal && t0 < k0 + kBK - 1) || k0 + kBK > it.kv_len ||
                            t0 + kBQ > p.Lq;
        const uint32_t qb = base + L::kOffQ + st * L::kQBytes;
        const uint32_t ob = base + L::kOffDO + st * L::kQBytes;
        const uint32_t stats = base + L::kOffStats + st * 2 * kBQ * 4;
        mbar_wait(full_bar(bars, st), ph);

        // S^T = K Q^T and dP^T = V dO^T over the head dim, one group each
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
            dp[4 * g + 2 * i + 1] = s[4 * g + 2 * i + 1] * (dp[4 * g + 2 * i + 1] - d.y) * p.scale;
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
        // dV += P^T dO, dK += dS^T Q: one group
        wg_fence();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(dv[c], pa[kk],
                         make_desc(ob + c * L::kQChunk + kk * 2048, L::kQChunk, 1024, kSw128));
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(dk[c], da[kk],
                         make_desc(qb + c * L::kQChunk + kk * 2048, L::kQChunk, 1024, kSw128));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          reg_fence(dk[c]);
          reg_fence(dv[c]);
        }
        reg_keep(pa);
        reg_keep(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(bars, st));
        if (++st == kStages) { st = 0; ph ^= 1; }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);      // the item's last use of K and V
      kvph ^= 1;
    }

    if (it.n > 1) {
      // a piece of a split key tile: the partials to slot ws0 + j (thread-
      // major, so each store is coalesced), then count in; the last piece
      // adds slots ws0 .. ws0 + n - 1 in order. Register e of chunk c holds
      // column 64 c + 8 (e / 4) + ..: those past d are 0 and skipped.
      const int half = wg * 2 * L::kRegs * 128;   // this warpgroup's 64 keys of a slot
      float* mine = p.ws + (long long)(it.ws0 + it.j) * L::kSlotFloats + half;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (kPart && 64 * c + 8 * (e >> 2) >= p.d) continue;
          __stcg(mine + (32 * c + e) * 128 + tid, dk[c][e]);
          __stcg(mine + (L::kRegs + 32 * c + e) * 128 + tid, dv[c][e]);
        }
      __threadfence();
      named_bar_sync(1 + wg, 128);
      int* counter = p.counters + 2 * it.split + wg;
      if (tid == 0) flag[wg] = atomicAdd(counter, 1);
      named_bar_sync(1 + wg, 128);
      if (flag[wg] != it.n - 1) continue;
      __threadfence();
      const float* first = p.ws + (long long)it.ws0 * L::kSlotFloats + half;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (kPart && 64 * c + 8 * (e >> 2) >= p.d) continue;
          float a = 0.f, b = 0.f;
          for (int piece = 0; piece < it.n; ++piece) {
            const float* slot = first + (long long)piece * L::kSlotFloats;
            a += piece == it.j ? dk[c][e] : __ldcg(slot + (32 * c + e) * 128 + tid);
            b += piece == it.j ? dv[c][e] : __ldcg(slot + (L::kRegs + 32 * c + e) * 128 + tid);
          }
          dk[c][e] = a;
          dv[c][e] = b;
        }
      if (tid == 0) *counter = 0;               // ready for the next launch
    }
    store_rows<kD, kPart>(p.dk, p.sdkb, p.sdkt, p.sdkh, it, key0, p.Lk, p.d, cq, dk);
    store_rows<kD, kPart>(p.dv, p.sdvb, p.sdvt, p.sdvh, it, key0, p.Lk, p.d, cq, dv);
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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(bars, s), 1 + 32);   // expect_tx + the producer lanes' cp.async
      mbar_init(empty_bar(bars, s), 8);
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
  // the instance that serves D: 64 or 128 columns
  const int inst = head_dim_instance(kBwdDims, D);
  if (inst == 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (n_cta <= 0) return 0;
  Params p{};
  p.d = D;
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
  // D read as zeros): 64 tokens of q and dO, 128 keys of k and v
  const long long qdims[4] = {D, H, Lq, B}, kdims[4] = {D, Hkv, Lk, B};
  const long long qs[4] = {1, sqh, sqt, sqb}, ks[4] = {1, skh, skt, skb},
                  vs[4] = {1, svh, svt, svb}, os[4] = {1, sdoh, sdot, sdob};
  const int qbox[4] = {64, 1, kBQ, 1}, kbox[4] = {64, 1, kBK, 1};
  int rc = encode_map(&p.q, q, 4, qdims, qs, qbox, true);
  if (rc == 0) rc = encode_map(&p.dO, dO, 4, qdims, os, qbox, true);
  if (rc == 0) rc = encode_map(&p.k, k, 4, kdims, ks, kbox, true);
  if (rc == 0) rc = encode_map(&p.v, v, 4, kdims, vs, kbox, true);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 64: return D < 64 ? launch<64, true>(p, n_cta, s) : launch<64, false>(p, n_cta, s);
    case 128: return D < 128 ? launch<128, true>(p, n_cta, s) : launch<128, false>(p, n_cta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
