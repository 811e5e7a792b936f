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
//   * Instances of 64 and 128 columns (Smem<kD>, the kD / 64 column chunks
//     of every product and load); 64 serves Qwen2.5-0.5B and -1.5B and
//     Llama-3.2. A head dim d that is a multiple of 8 up to 128 runs on the
//     smaller one that covers it (H2O-Danube2's 80, H2O-Danube3's 96 and
//     120 on 128): the tensor maps keep d as their innermost extent, TMA
//     fills the columns past d with zeros (Q, dO, K and V alike, so they add
//     nothing to S, dP or dQ) and the epilogue stores the first d columns.
//     The host pads other head dims up to 128 to a multiple of 8; any other
//     D is refused.
//   * Any GQA ratio up to 128: where rep does not divide 128, rows past
//     rep * floor(128 / rep) are idle (zeroed Q and dO rows, zero-filled lse
//     and delta, so their ds is 0) and never stored. Every mbarrier wait traps
//     after ~10 s instead of hanging.
#include "attention_sm90.cuh"

namespace socio90 {
namespace dq {

constexpr int kStages = 2;           // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim kD (64 or 128; offsets from a
// 1024-byte-aligned base): 128-row operand tiles as kD / 64 chunks of 64
// columns with a 128-byte swizzle. At kD = 128 the tiles fill 193 KB; at 64,
// half of it.
template <int kD>
struct Smem {
  static constexpr uint32_t kChunk = kBM * 64 * 2;             // 16 KB
  static constexpr uint32_t kTile = kBM * kD * 2;              // Q, dO, K or V
  static constexpr uint32_t kOffQ = 0;
  static constexpr uint32_t kOffDO = kTile;
  static constexpr uint32_t kOffK = 2 * kTile;
  static constexpr uint32_t kOffV = kOffK + kStages * kTile;
  static constexpr uint32_t kOffStats = kOffV + kStages * kTile;   // lse[128], delta[128]
  static constexpr uint32_t kOffBar = kOffStats + 2 * kBM * 4;
  // barriers: Q full, Q empty, then K/V full[kStages], K/V empty[kStages]
  static constexpr uint32_t kBytes = kOffBar + (2 + 2 * kStages) * 8 + 1024;   // + slack
};

struct Params {
  CUtensorMap q, dO, k, v;    // 64-column boxes: q/dO rep heads x toks tokens, k/v 1 head x 128
  const float* lse;           // (B, H, Lq)
  const float* delta;         // (B, H, Lq)
  bf16* dq;
  long long sdqb, sdqt, sdqh;
  int d;                      // the tensors' head dim: dq columns stored (<= kD)
  const int* kv_lens;         // (B,)
  int B, Lq, Lk, H, Hkv, rep, causal, n_ttiles, n_items, q_rows;
  float scale, scale_log2;    // D^-0.5 and D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t kv_full(uint32_t bars, int st) { return bars + 8 * (2 + st); }
__device__ __forceinline__ uint32_t kv_empty(uint32_t bars, int st) {
  return bars + 8 * (2 + kStages + st);
}

// ------------------------------------------------------------- producer

template <int kD>
__device__ __forceinline__ void producer(const Params& p, uint32_t base, int lane) {
  using L = Smem<kD>;
  const uint32_t bars = base + L::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const uint32_t stats = base + L::kOffStats;
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
    for (int j = it.lo; j <= it.hi; ++j) {
      mbar_wait(kv_empty(bars, ks), kph ^ 1);
      mbar_expect_tx(kv_full(bars, ks), 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) {
        const uint32_t off = ks * L::kTile + c * L::kChunk;
        tma_load_4d(base + L::kOffK + off, &p.k, kv_full(bars, ks), 64 * c, it.head, j * kBN,
                    it.b);
        tma_load_4d(base + L::kOffV + off, &p.v, kv_full(bars, ks), 64 * c, it.head, j * kBN,
                    it.b);
      }
      if (++ks == kStages) { ks = 0; kph ^= 1; }
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
  const int toks = kBM / p.rep;
  int ks = 0;
  uint32_t qph = 0, kph = 0;

  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve_gqa(p, item);
    // the keys the item's rows may see lie below k_hi
    int k_hi = it.kv_len;
    if (p.causal) k_hi = min(k_hi, min(it.t0 + toks, p.Lq));
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
      const uint32_t kb = base + L::kOffK + ks * L::kTile, vb = base + L::kOffV + ks * L::kTile;
      const bool masked = j < it.nm_lo || j > it.nm_hi;
      const int halves = j * kBN + 64 < k_hi ? 2 : 1;
      mbar_wait(kv_full(bars, ks), kph);
      for (int hf = 0; hf < halves; ++hf) {
        // S = Q K^T and dP = dO V^T over the head dim for keys
        // j * 128 + 64 hf .. + 63, one group each
        float s[32], dp[32];
        wg_fence();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(s, make_desc(qb + c * L::kChunk + kk * 32, 16, 1024, kSw128),
                         make_desc(kb + c * L::kChunk + hf * 8192 + kk * 32, 16, 1024, kSw128),
                         (c | kk) != 0);
        wg_commit();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dp, make_desc(ob + c * L::kChunk + kk * 32, 16, 1024, kSw128),
                         make_desc(vb + c * L::kChunk + hf * 8192 + kk * 32, 16, 1024, kSw128),
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
            wgmma_rs_n64(acc[c], da[kk], make_desc(kb + c * L::kChunk + (4 * hf + kk) * 2048,
                                                   L::kChunk, 1024, kSw128));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) reg_fence(acc[c]);
        reg_keep(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(bars, ks));
      if (++ks == kStages) { ks = 0; kph ^= 1; }
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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full(bars, s), 1);
      mbar_init(kv_empty(bars, s), 8);
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
  // the instance that serves D: 64 or 128 columns
  const int inst = head_dim_instance(kBwdDims, D);
  if (inst == 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kBM)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.d = D;
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
  // zeros): rep heads x toks tokens of q and dO, one head x 128 keys of k and v
  const long long qdims[4] = {D, H, Lq, B}, kdims[4] = {D, Hkv, Lk, B};
  const long long qs[4] = {1, sqh, sqt, sqb}, os[4] = {1, sdoh, sdot, sdob},
                  ks[4] = {1, skh, skt, skb}, vs[4] = {1, svh, svt, svb};
  const int qbox[4] = {64, rep, toks, 1}, kbox[4] = {64, 1, kBN, 1};
  int rc = encode_map(&p.q, q, 4, qdims, qs, qbox, true);
  if (rc == 0) rc = encode_map(&p.dO, dO, 4, qdims, os, qbox, true);
  if (rc == 0) rc = encode_map(&p.k, k, 4, kdims, ks, kbox, true);
  if (rc == 0) rc = encode_map(&p.v, v, 4, kdims, vs, kbox, true);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 64: return D < 64 ? launch<64, true>(p, s) : launch<64, false>(p, s);
    case 128: return D < 128 ? launch<128, true>(p, s) : launch<128, false>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
