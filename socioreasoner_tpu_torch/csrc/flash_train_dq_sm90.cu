// Training backward of flash attention: dq, a Hopper kernel.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention_bwd.py
// `_dq_kernel` (reached through `_flash_bwd_rule`, the VJP of
// `flash_attention_trainable`). It recomputes the probabilities from the
// forward's per-row log-sum-exp, by the Pallas kernels' formula:
//   p  = exp(q k^T * scale - lse)  where the mask holds, else 0
//   ds = p * (dO v^T - delta) * scale,   delta = rowsum(dO * O) (f32, given)
//   dq = ds k
// with bf16 operands and f32 accumulators; ds is rounded to bf16 before ds k,
// as the Pallas kernel casts it. The mask is key < kv_len and, when causal,
// key <= query index; a row with no valid key gets dq = 0. The dk/dv half of
// the backward is kernel 6 (flash_train_dkv_sm90.cu).
//
// What bounds it on the H100: at the train shape (B = 4, L = 2304, 16 q / 2
// kv heads, D = 128, kv lengths 2304/2080/1000/1) it does three 64 x 64 x 128
// products per (64 rows, 64 keys) of the causal mask -- 8.7e10 FLOP, 0.088
// ms at the bf16 peak -- over ~85 MB of q, k, v, dO, dq, lse and delta
// (0.025 ms at the memory rate): tensor-core bound.
//
// The design: kernel 4's CTA (attention_sm90.cuh) with the backward's
// products in its consumers.
//   * Work items are kernel 4's (gqa_item, resolve_gqa): floor(128 / rep)
//     tokens x the rep q heads of one (batch row, kv head), so every K/V tile
//     is loaded once for the whole GQA group; the last token tiles (the
//     heaviest under a causal mask) first, so the persistent CTAs' round-robin
//     ends on light items; k tiles up to the item's last token and kv_len
//     (prefill_k_tiles), the mask evaluated only on the tiles that reach past
//     its first token or past kv_len. One CTA owns each dq row: no atomics
//     and no split tiles, so two runs give the same bits.
//   * A producer warp loads the item's Q and dO (one 4-D TMA box each, rep
//     heads x tokens, as kernel 4's Q) and its rows' lse and delta ((B, H, Lq)
//     f32, gathered by 4-byte cp.async with zero fill, as kernel 6 loads
//     them), all arriving on one barrier, then streams the K/V tiles (128
//     keys) through a 2-stage mbarrier ring. At D = 128, 2 x 32 KB of Q and
//     dO and 2 x 64 KB of K/V fill 193 KB of shared memory, so Q and dO have
//     one buffer: the next item's load starts when the current item's last S
//     and dP are done.
//   * Two consumer warpgroups own 64 rows each and keep their dQ (64 x D
//     f32, D / 2 registers a thread) in registers over the item. A 128-key tile
//     is taken as two 64-key halves (the second skipped where the item's
//     last token is in the first): S = Q K^T and dP = dO V^T are wgmma with
//     both operands in shared memory (32 registers each), p = ex2(s * scale
//     log2 e - lse log2 e) with lse given (no online max), ds = p (dP - delta)
//     scale packed to bf16 in registers -- the accumulator layout is the A
//     operand layout -- and dQ += dS K with K as the MN-major B operand, the
//     forward's O += P V with K in V's place. Nothing of S, P, dP or dS
//     touches shared memory. dq is stored as bf16 straight from registers.
//   * Instances of 64, 128 and 256 columns (Smem<kD>, the kD / 64 column
//     chunks of every product and load); 64 serves Qwen2.5-0.5B and -1.5B
//     and Llama-3.2, 256 Falcon3. A head dim d that is a multiple of 8 up to
//     256 runs on the smallest one that covers it (H2O-Danube2's 80,
//     H2O-Danube3's 96 and 120 on 128, 136-248 on 256): the tensor maps keep
//     d as their innermost extent, TMA fills the columns past d with zeros
//     (Q, dO, K and V alike, so they add nothing to S, dP or dQ) and the
//     epilogue stores the first d columns. The host pads other head dims to
//     a multiple of 8; above 256 the sliced kernel below takes them.
//   * At 256 columns Q and dO are 64 KB each and a 128-key K/V tile would be
//     128 KB, so the ring holds one stage of 64-key K and V halves (32 KB
//     each; 193 KB in all): the producer loads each half that the item's
//     rows reach as a stage of its own, and the consumers walk the same
//     halves. dQ is 128 registers a consumer thread beside S and dP (32
//     each) and the bf16 dS fragments (16).
//   * Above 256 columns (SliceSmem) a work item is (GQA item, column slice of
//     256): Q, dO, K and V are 128 KB + 128 KB + 2 x 64 KB at 512 columns, so
//     every 64-key half sums S = Q K^T and dP = dO V^T over d / 64 chunk
//     stages of a ring (the 64-column chunks of all four, 48 KB), the same
//     order in every slice, then takes the half's K columns of its slice
//     (32 KB, a ring of its own) for dQ += dS K, and keeps dQ of its 256
//     columns in the 128 registers of the 256 instance. Each slice
//     recomputes P and dS; no slice needs another's result.
//   * Any GQA ratio up to 128: where rep does not divide 128, rows past
//     rep * floor(128 / rep) are idle (zeroed Q and dO rows, zero-filled lse
//     and delta, so their ds is 0) and never stored. Every mbarrier wait traps
//     after ~10 s instead of hanging.
#include "attention_sm90.cuh"

namespace socio90 {
namespace dq {

constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim kD (64, 128 or 256; offsets from a
// 1024-byte-aligned base): operand tiles as kD / 64 chunks of 64 columns with
// a 128-byte swizzle, Q and dO of 128 rows, a K/V stage of kKeys keys (a
// whole 128-key tile in a ring of two, or at 256 columns one 64-key half in
// a ring of one). At kD = 128 and 256 the tiles fill 193 KB; at 64, half of
// it.
template <int kD>
struct Smem {
  static constexpr int kKeys = stage_keys(kD);                 // keys of a K/V stage
  static constexpr int kSub = kBN / kKeys;                     // stages a 128-key tile takes
  static constexpr int kStages = kSub == 1 ? 2 : 1;            // K/V ring depth
  static constexpr uint32_t kChunk = kBM * 64 * 2;             // 16 KB: a Q or dO chunk
  static constexpr uint32_t kTile = kBM * kD * 2;              // Q or dO
  static constexpr uint32_t kKVChunk = kKeys * 64 * 2;
  static constexpr uint32_t kKVTile = kKeys * kD * 2;          // a K or V stage
  static constexpr uint32_t kOffQ = 0;
  static constexpr uint32_t kOffDO = kTile;
  static constexpr uint32_t kOffK = 2 * kTile;
  static constexpr uint32_t kOffV = kOffK + kStages * kKVTile;
  static constexpr uint32_t kOffStats = kOffV + kStages * kKVTile;   // lse[128], delta[128]
  static constexpr uint32_t kOffBar = kOffStats + 2 * kBM * 4;
  // barriers: Q full, Q empty, then K/V full[kStages], K/V empty[kStages]
  static constexpr uint32_t kBytes = kOffBar + (2 + 2 * kStages) * 8 + 1024;   // + slack
  static_assert(kBytes <= 232448, "the H100's shared memory a block");
};

struct Params {
  CUtensorMap q, dO, k, v;    // 64-column boxes: q/dO rep heads x toks tokens, k/v 1 head x a stage
  const float* lse;           // (B, H, Lq)
  const float* delta;         // (B, H, Lq)
  bf16* dq;
  long long sdqb, sdqt, sdqh;
  int d;                      // the tensors' head dim: dq columns stored (<= kD)
  int slices;                 // column slices of 256 (head_dim_slices): above 1, the sliced kernel
  const int* kv_lens;         // (B,)
  int B, Lq, Lk, H, Hkv, rep, causal, n_ttiles, n_items, q_rows;
  float scale, scale_log2;    // D^-0.5 and D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t kv_full(uint32_t bars, int st) { return bars + 8 * (2 + st); }
template <int kStages>
__device__ __forceinline__ uint32_t kv_empty(uint32_t bars, int st) {
  return bars + 8 * (2 + kStages + st);
}

// The 64-key halves of 128-key tile j that rows below key k_hi reach: 2, or
// 1 where the item's last key lies in the first half.
__device__ __forceinline__ int tile_halves(int j, int k_hi) { return j * kBN + 64 < k_hi ? 2 : 1; }

// The keys below which an item's rows see any key: kv_len, and under a
// causal mask its last token + 1.
template <class P>
__device__ __forceinline__ int item_k_hi(const P& p, const Item& it) {
  int k_hi = it.kv_len;
  if (p.causal) k_hi = min(k_hi, min(it.t0 + kBM / p.rep, p.Lq));
  return k_hi;
}

// ------------------------------------------------------------- producer

template <int kD>
__device__ __forceinline__ void producer(const Params& p, uint32_t base, int lane) {
  using L = Smem<kD>;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const uint32_t stats = base + L::kOffStats;
  constexpr int kStages = L::kStages;
  int ks = 0;
  uint32_t qph = 0, kph = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve_gqa(p, item);
    mbar_wait(q_empty, qph ^ 1);
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * p.q_rows * kD * 2);
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) {
        tma_load_4d(base + L::kOffQ + c * L::kChunk, &p.q, q_full, 64 * c, it.head * p.rep,
                    it.t0, it.b);
        tma_load_4d(base + L::kOffDO + c * L::kChunk, &p.dO, q_full, 64 * c, it.head * p.rep,
                    it.t0, it.b);
      }
    }
    // lse and delta of the tile's rows, four a lane; idle rows and rows past
    // Lq read nothing and land as zeros
#pragma unroll
    for (int e = 0; e < kBM / 32; ++e) {
      const int r = lane + 32 * e;
      const int t = it.t0 + r / p.rep;
      const bool in = r < p.q_rows && t < p.Lq;
      const long long src =
          in ? ((long long)it.b * p.H + it.head * p.rep + r % p.rep) * p.Lq + t : 0;
      cp_async4(stats + 4 * r, p.lse + src, in ? 4u : 0u);
      cp_async4(stats + 4 * (kBM + r), p.delta + src, in ? 4u : 0u);
    }
    cp_async_arrive_noinc(q_full);
    qph ^= 1;
    if (lane != 0) continue;
    const int k_hi = item_k_hi(p, it);
    for (int j = it.lo; j <= it.hi; ++j) {
      // a stage a tile, or at 256 columns a stage a half that the rows reach
      const int n_stages = L::kSub == 1 ? 1 : tile_halves(j, k_hi);
      for (int hf = 0; hf < n_stages; ++hf) {
        const int key = j * kBN + hf * L::kKeys;
        mbar_wait(kv_empty<kStages>(bars, ks), kph ^ 1);
        mbar_expect_tx(kv_full(bars, ks), 2 * L::kKVTile);
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          const uint32_t off = ks * L::kKVTile + c * L::kKVChunk;
          tma_load_4d(base + L::kOffK + off, &p.k, kv_full(bars, ks), 64 * c, it.head, key, it.b);
          tma_load_4d(base + L::kOffV + off, &p.v, kv_full(bars, ks), 64 * c, it.head, key, it.b);
        }
        if (++ks == kStages) { ks = 0; kph ^= 1; }
      }
    }
  }
}

// ------------------------------------------------------------- consumer

// kPart: the tensors' head dim p.d is below kD, and the epilogue stores
// only its columns.
template <int kD, bool kPart>
__device__ __forceinline__ void consumer(const Params& p, uint32_t base, int wg) {
  using L = Smem<kD>;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  // this thread's rows row0 and row0 + 8 of the 128-row tile, and its column
  // pair within each 8-column group of an accumulator (the wgmma layout)
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const uint32_t qb = base + L::kOffQ + wg * 8192, ob = base + L::kOffDO + wg * 8192;
  const uint32_t stats = base + L::kOffStats;
  constexpr int kStages = L::kStages;
  int ks = 0;
  uint32_t qph = 0, kph = 0;

  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve_gqa(p, item);
    // the keys the item's rows may see lie below k_hi
    const int k_hi = item_k_hi(p, it);
    int t[2];
    float lse2[2], dlt[2];
    mbar_wait(q_full, qph);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      t[i] = it.t0 + r / p.rep;
      float x;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(stats + 4 * r));
      lse2[i] = x * kLog2e;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(stats + 4 * (kBM + r)));
      dlt[i] = x;
    }
    auto release_q = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    };
    float acc[kD / 64][32];
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

    if (it.lo > it.hi) release_q();       // no key: release Q, dO and the stats at once
    for (int j = it.lo; j <= it.hi; ++j) {
      const bool masked = j < it.nm_lo || j > it.nm_hi;
      const int halves = tile_halves(j, k_hi);
      if (L::kSub == 1) mbar_wait(kv_full(bars, ks), kph);
      for (int hf = 0; hf < halves; ++hf) {
        if (L::kSub == 2) mbar_wait(kv_full(bars, ks), kph);    // the half is a stage
        const uint32_t kb = base + L::kOffK + ks * L::kKVTile;
        const uint32_t vb = base + L::kOffV + ks * L::kKVTile;
        const int hrow = L::kSub == 1 ? hf : 0;     // the half's first row in the stage / 64
        // S = Q K^T and dP = dO V^T over the head dim for keys
        // j * 128 + 64 hf .. + 63, one group each
        float s[32], dp[32];
        wg_fence();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(s, make_desc(qb + c * L::kChunk + kk * 32, 16, 1024, kSw128),
                         make_desc(kb + c * L::kKVChunk + hrow * 8192 + kk * 32, 16, 1024,
                                   kSw128),
                         (c | kk) != 0);
        wg_commit();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dp, make_desc(ob + c * L::kChunk + kk * 32, 16, 1024, kSw128),
                         make_desc(vb + c * L::kKVChunk + hrow * 8192 + kk * 32, 16, 1024,
                                   kSw128),
                         (c | kk) != 0);
        wg_commit();

        // p = exp2(s * scale log2 e - lse log2 e), 0 where the mask fails;
        // element 4g + 2i + e is row row0 + 8i, key 8g + cq + e of the half
        wg_wait1();
        reg_fence(s);
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[4 * g + 2 * i + e] = ex2(fmaf(s[4 * g + 2 * i + e], p.scale_log2, -lse2[i]));
        if (masked) {
          const int key0 = j * kBN + hf * 64 + cq;
#pragma unroll
          for (int g = 0; g < 8; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = key0 + 8 * g + e;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (key >= it.kv_len || (p.causal && key > t[i])) s[4 * g + 2 * i + e] = 0.f;
            }
        }
        wg_wait0();
        reg_fence(dp);
        if (j == it.hi && hf == halves - 1) release_q();   // the item's last use of Q and dO
        // ds = p (dp - delta) scale in bf16, as the A fragments of four k16
        // steps (keys 16kk .. 16kk + 15 of the half)
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e0 = 8 * kk + 2 * x;       // the pair's row is row0 + 8 (x & 1)
            da[kk][x] = pack_bf16(s[e0] * (dp[e0] - dlt[x & 1]) * p.scale,
                                  s[e0 + 1] * (dp[e0 + 1] - dlt[x & 1]) * p.scale);
          }
        // dQ += dS K, K MN-major (the head dim contiguous): one group
        wg_fence();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(acc[c], da[kk],
                         make_desc(kb + c * L::kKVChunk + (4 * hrow + kk) * 2048, L::kKVChunk,
                                   1024, kSw128));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) reg_fence(acc[c]);
        reg_keep(da);
        if (L::kSub == 2 || hf == halves - 1) {     // the stage's last use
          __syncwarp();
          if (lane == 0) mbar_arrive(kv_empty<kStages>(bars, ks));
          if (++ks == kStages) { ks = 0; kph ^= 1; }
        }
      }
    }
    qph ^= 1;

    // epilogue: dq rows in bf16 pairs straight from registers; idle rows and
    // rows past Lq are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r >= p.q_rows || t[i] >= p.Lq) continue;
      bf16* dst = p.dq + it.b * p.sdqb + t[i] * p.sdqt + (it.head * p.rep + r % p.rep) * p.sdqh;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          if (!kPart || 64 * c + 8 * g < p.d)     // the first d columns (d % 8 == 0)
            *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * g + cq) =
                pack_bf16(acc[c][4 * g + 2 * i], acc[c][4 * g + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- kernel

template <int kD, bool kPart>
__global__ void __launch_bounds__(kThreads, 1)
    flash_train_dq_kernel(const __grid_constant__ Params p) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kOffBar;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1 + 32);       // Q full: the producer's expect_tx + its lanes' cp.async
    mbar_init(bars + 8, 8);        // Q empty: one arrive per consumer warp
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(kv_full(bars, s), 1);
      mbar_init(kv_empty<L::kStages>(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the idle rows of Q and dO: zeros for good (no TMA box reaches them)
  for (int c = 0; c < 2 * (kD / 64); ++c)
    zero_smem(base + L::kOffQ + c * L::kChunk + p.q_rows * 128, (kBM - p.q_rows) * 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // before wgmma reads them
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) producer<kD>(p, base, threadIdx.x & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer<kD, kPart>(p, base, wg);
  }
}

// One launch of the kD instance (guarding its column stores where p.d <
// kD); the grid-constant parameters are complete.
template <int kD, bool kPart>
int launch(const Params& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_train_dq_kernel<kD, kPart>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<kD>::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  flash_train_dq_kernel<kD, kPart><<<grid, kThreads, Smem<kD>::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// -------------------------------------------- column slices (D > 256)

// Shared-memory layout of the sliced kernel: a ring of chunk stages, each the
// 64-column chunk of the item's Q and dO tiles (128 rows) and of a 64-key
// half's K and V, feeding S = Q K^T and dP = dO V^T over all d columns; a
// ring of the halves' K columns of the item's slice (64 keys x 256), for
// dQ += dS K; the item's lse and delta.
struct SliceSmem {
  static constexpr int kKeys = 64;
  static constexpr int kCols = kSliceCols;
  static constexpr int kCS = 3;                                // chunk ring depth
  static constexpr int kKS = 2;                                // K-slice ring depth
  static constexpr uint32_t kQC = kBM * 64 * 2;                // 16 KB: a Q or dO chunk
  static constexpr uint32_t kKC = kKeys * 64 * 2;              // 8 KB: a K or V chunk
  static constexpr uint32_t kOffDO = kQC, kOffK = 2 * kQC, kOffV = 2 * kQC + kKC;
  static constexpr uint32_t kStage = 2 * kQC + 2 * kKC;        // 48 KB
  static constexpr uint32_t kSlice = kCols / 64 * kKC;         // 32 KB
  static constexpr uint32_t kOffSlice = kCS * kStage;
  static constexpr uint32_t kOffStats = kOffSlice + kKS * kSlice;   // lse[128], delta[128]
  static constexpr uint32_t kOffBar = kOffStats + 2 * kBM * 4;
  // barriers: chunk full[kCS], empty[kCS], slice full[kKS], empty[kKS],
  // stats full, stats empty
  static constexpr uint32_t kBytes = kOffBar + (2 * kCS + 2 * kKS + 2) * 8 + 1024;
  static_assert(kStage % 1024 == 0 && kBytes <= 232448, "the H100's shared memory a block");
  __device__ static uint32_t c_full(uint32_t bars, int st) { return bars + 8 * st; }
  __device__ static uint32_t c_empty(uint32_t bars, int st) { return bars + 8 * (kCS + st); }
  __device__ static uint32_t k_full(uint32_t bars, int st) { return bars + 8 * (2 * kCS + st); }
  __device__ static uint32_t k_empty(uint32_t bars, int st) {
    return bars + 8 * (2 * kCS + kKS + st);
  }
  __device__ static uint32_t s_full(uint32_t bars) { return bars + 8 * (2 * kCS + 2 * kKS); }
  __device__ static uint32_t s_empty(uint32_t bars) { return s_full(bars) + 8; }
};

// Work item w is GQA item w / slices, column slice w % slices. The producer
// warp gathers the item's lse and delta (every lane), then lane 0 streams,
// for each 64-key half the item's rows reach, its d / 64 chunk stages and
// the slice's K columns.
__device__ __forceinline__ void producer_sliced(const Params& p, uint32_t base, int lane) {
  using L = SliceSmem;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t stats = base + L::kOffStats;
  const int nc = (p.d + 63) / 64;
  int cs = 0, ks = 0;
  uint32_t cph = 0, kph = 0, sph = 0;
  for (int w = blockIdx.x; w < p.n_items * p.slices; w += gridDim.x) {
    const int col0 = L::kCols * (w % p.slices);
    const Item it = resolve_gqa(p, w / p.slices);
    mbar_wait(L::s_empty(bars), sph ^ 1);
#pragma unroll
    for (int e = 0; e < kBM / 32; ++e) {
      const int r = lane + 32 * e;
      const int t = it.t0 + r / p.rep;
      const bool in = r < p.q_rows && t < p.Lq;
      const long long src =
          in ? ((long long)it.b * p.H + it.head * p.rep + r % p.rep) * p.Lq + t : 0;
      cp_async4(stats + 4 * r, p.lse + src, in ? 4u : 0u);
      cp_async4(stats + 4 * (kBM + r), p.delta + src, in ? 4u : 0u);
    }
    cp_async_arrive_noinc(L::s_full(bars));
    sph ^= 1;
    if (lane != 0) continue;
    const int k_hi = item_k_hi(p, it);
    for (int j = it.lo; j <= it.hi; ++j) {
      for (int hf = 0; hf < tile_halves(j, k_hi); ++hf) {
        const int key = j * kBN + hf * L::kKeys;
        for (int c = 0; c < nc; ++c) {
          const uint32_t full = L::c_full(bars, cs), dst = base + cs * L::kStage;
          mbar_wait(L::c_empty(bars, cs), cph ^ 1);
          mbar_expect_tx(full, 2 * p.q_rows * 128 + 2 * L::kKC);
          tma_load_4d(dst, &p.q, full, 64 * c, it.head * p.rep, it.t0, it.b);
          tma_load_4d(dst + L::kOffDO, &p.dO, full, 64 * c, it.head * p.rep, it.t0, it.b);
          tma_load_4d(dst + L::kOffK, &p.k, full, 64 * c, it.head, key, it.b);
          tma_load_4d(dst + L::kOffV, &p.v, full, 64 * c, it.head, key, it.b);
          if (++cs == L::kCS) { cs = 0; cph ^= 1; }
        }
        const uint32_t full = L::k_full(bars, ks), dst = base + L::kOffSlice + ks * L::kSlice;
        mbar_wait(L::k_empty(bars, ks), kph ^ 1);
        mbar_expect_tx(full, L::kSlice);
#pragma unroll
        for (int c = 0; c < L::kCols / 64; ++c)
          tma_load_4d(dst + c * L::kKC, &p.k, full, col0 + 64 * c, it.head, key, it.b);
        if (++ks == L::kKS) { ks = 0; kph ^= 1; }
      }
    }
  }
}

// One consumer warpgroup of the sliced kernel: consumer<256> with S and dP
// accumulated over the chunk stages (the same order in every slice) and dQ
// of the slice's 256 columns.
__device__ __forceinline__ void consumer_sliced(const Params& p, uint32_t base, int wg) {
  using L = SliceSmem;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t stats = base + L::kOffStats;
  const int nc = (p.d + 63) / 64;
  int cs = 0, ks = 0;
  uint32_t cph = 0, kph = 0, sph = 0;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  for (int w = blockIdx.x; w < p.n_items * p.slices; w += gridDim.x) {
    const int col0 = L::kCols * (w % p.slices);
    const Item it = resolve_gqa(p, w / p.slices);
    const int k_hi = item_k_hi(p, it);
    int t[2];
    float lse2[2], dlt[2];
    mbar_wait(L::s_full(bars), sph);
    sph ^= 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      t[i] = it.t0 + r / p.rep;
      float x;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(stats + 4 * r));
      lse2[i] = x * kLog2e;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(stats + 4 * (kBM + r)));
      dlt[i] = x;
    }
    release(L::s_empty(bars));
    float acc[L::kCols / 64][32];
#pragma unroll
    for (int c = 0; c < L::kCols / 64; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

    for (int j = it.lo; j <= it.hi; ++j) {
      const bool masked = j < it.nm_lo || j > it.nm_hi;
      const int halves = tile_halves(j, k_hi);
      for (int hf = 0; hf < halves; ++hf) {
        // S = Q K^T and dP = dO V^T over all d columns, one group a chunk
        float s[32], dp[32];
        int prev = 0;
        for (int c = 0; c < nc; ++c) {
          mbar_wait(L::c_full(bars, cs), cph);
          const uint32_t st = base + cs * L::kStage;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(s, make_desc(st + wg * 8192 + kk * 32, 16, 1024, kSw128),
                         make_desc(st + L::kOffK + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dp, make_desc(st + L::kOffDO + wg * 8192 + kk * 32, 16, 1024, kSw128),
                         make_desc(st + L::kOffV + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
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
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[4 * g + 2 * i + e] = ex2(fmaf(s[4 * g + 2 * i + e], p.scale_log2, -lse2[i]));
        if (masked) {
          const int key0 = j * kBN + hf * 64 + cq;
#pragma unroll
          for (int g = 0; g < 8; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = key0 + 8 * g + e;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (key >= it.kv_len || (p.causal && key > t[i])) s[4 * g + 2 * i + e] = 0.f;
            }
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e0 = 8 * kk + 2 * x;
            da[kk][x] = pack_bf16(s[e0] * (dp[e0] - dlt[x & 1]) * p.scale,
                                  s[e0 + 1] * (dp[e0 + 1] - dlt[x & 1]) * p.scale);
          }
        // dQ += dS K over the slice's columns, K MN-major
        mbar_wait(L::k_full(bars, ks), kph);
        const uint32_t kb = base + L::kOffSlice + ks * L::kSlice;
        wg_fence();
#pragma unroll
        for (int c = 0; c < L::kCols / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(acc[c], da[kk],
                         make_desc(kb + c * L::kKC + kk * 2048, L::kKC, 1024, kSw128));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < L::kCols / 64; ++c) reg_fence(acc[c]);
        reg_keep(da);
        release(L::k_empty(bars, ks));
        if (++ks == L::kKS) { ks = 0; kph ^= 1; }
      }
    }

    // epilogue: the slice's dq columns below d, bf16 pairs from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r >= p.q_rows || t[i] >= p.Lq) continue;
      bf16* dst = p.dq + it.b * p.sdqb + t[i] * p.sdqt + (it.head * p.rep + r % p.rep) * p.sdqh;
#pragma unroll
      for (int c = 0; c < L::kCols / 64; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          if (col0 + 64 * c + 8 * g < p.d)
            *reinterpret_cast<uint32_t*>(dst + col0 + 64 * c + 8 * g + cq) =
                pack_bf16(acc[c][4 * g + 2 * i], acc[c][4 * g + 2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_train_dq_sliced_kernel(const __grid_constant__ Params p) {
  using L = SliceSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kOffBar;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kCS; ++s) {
      mbar_init(L::c_full(bars, s), 1);
      mbar_init(L::c_empty(bars, s), 8);
    }
    for (int s = 0; s < L::kKS; ++s) {
      mbar_init(L::k_full(bars, s), 1);
      mbar_init(L::k_empty(bars, s), 8);
    }
    mbar_init(L::s_full(bars), 32);    // the producer lanes' cp.async
    mbar_init(L::s_empty(bars), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the idle rows of every stage's Q and dO chunks: zeros for good
  for (int s = 0; s < L::kCS; ++s)
    for (int c = 0; c < 2; ++c)
      zero_smem(base + s * L::kStage + c * L::kQC + p.q_rows * 128, (kBM - p.q_rows) * 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) producer_sliced(p, base, threadIdx.x & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer_sliced(p, base, wg);
  }
}

int launch_sliced(const Params& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_train_dq_sliced_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SliceSmem::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int work = p.n_items * p.slices;
  const int grid = work < num_sms() ? work : num_sms();
  flash_train_dq_sliced_kernel<<<grid, kThreads, SliceSmem::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace dq
}  // namespace socio90

extern "C" int socio_flash_train_dq_bf16(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dq, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdob, long long sdot, long long sdoh,
    long long sdqb, long long sdqt, long long sdqh,
    int causal, float scale, void* stream) {
  using namespace socio90;
  using namespace socio90::dq;
  // the instance that serves D: 64, 128 or 256 columns
  const int inst = head_dim_instance(kBwdDims, D);
  if (inst == 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kBM)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.d = D;
  p.slices = head_dim_slices(D);
  const int rep = H / Hkv;
  const int toks = kBM / rep;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.sdqb = sdqb;
  p.sdqt = sdqt;
  p.sdqh = sdqh;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.Hkv = Hkv;
  p.rep = rep;
  p.causal = causal;
  p.n_ttiles = (Lq + toks - 1) / toks;
  p.n_items = p.n_ttiles * B * Hkv;
  p.q_rows = rep * toks;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  if (p.n_items <= 0) return 0;
  // (D, heads, tokens, B) views, 64-column boxes (columns past D read as
  // zeros): rep heads x toks tokens of q and dO, one head x a stage's keys
  // (128, or 64 at 256 columns) of k and v
  const long long qdims[4] = {D, H, Lq, B}, kdims[4] = {D, Hkv, Lk, B};
  const long long qs[4] = {1, sqh, sqt, sqb}, os[4] = {1, sdoh, sdot, sdob},
                  ks[4] = {1, skh, skt, skb}, vs[4] = {1, svh, svt, svb};
  const int qbox[4] = {64, rep, toks, 1}, kbox[4] = {64, 1, stage_keys(inst), 1};
  int rc = encode_map(&p.q, q, 4, qdims, qs, qbox, true);
  if (rc == 0) rc = encode_map(&p.dO, dO, 4, qdims, os, qbox, true);
  if (rc == 0) rc = encode_map(&p.k, k, 4, kdims, ks, kbox, true);
  if (rc == 0) rc = encode_map(&p.v, v, 4, kdims, vs, kbox, true);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.slices > 1) return launch_sliced(p, s);
  switch (inst) {
    case 64: return D < 64 ? launch<64, true>(p, s) : launch<64, false>(p, s);
    case 128: return D < 128 ? launch<128, true>(p, s) : launch<128, false>(p, s);
    case 256: return D < 256 ? launch<256, true>(p, s) : launch<256, false>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
