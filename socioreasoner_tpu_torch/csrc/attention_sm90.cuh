// One Hopper forward-attention CTA, shared by the prefill kernel
// (flash_prefill.cu), the training forward (flash_train_fwd.cu), which adds
// the per-row log-sum-exp, and the ViT's segment-masked kernel
// (flash_segmented.cu). The training dq kernel (flash_train_dq_sm90.cu)
// walks the same GQA work items (gqa_item, resolve_gqa, prefill_k_tiles).
//
// A CTA is persistent: it walks work items (q tiles of 128 rows) blockIdx.x,
// blockIdx.x + gridDim.x, ... and is warp specialised into three warpgroups:
//
//   warpgroup 2 (producer)  one thread keeps TMA loads (cp.async.bulk.tensor)
//                           in flight: the item's Q tile into a ring of two
//                           Q buffers (one at D = 256), then its K and V
//                           tiles (128 keys; at D = 256 each 128-key tile
//                           as two 64-key halves) into a ring of 2-3
//                           stages, each with full and empty mbarriers. It
//                           runs ahead into the next item while the
//                           consumers finish the current one.
//   warpgroups 0 and 1      each owns 64 of the 128 query rows. S = Q K^T is
//   (consumers)             wgmma m64n128k16 with Q and K from shared memory
//                           and an f32 accumulator in registers; the mask and
//                           the online softmax run on those registers (row
//                           max and sum by quad shuffles, exp2 with the scale
//                           folded into log2(e)); P is rounded to bf16 in
//                           registers and is wgmma's A operand for O += P V,
//                           with V from shared memory (transposed operand).
//                           O stays in f32 registers over the whole key loop;
//                           the epilogue divides by l (0 where l == 0) and
//                           stores bf16 straight from registers; given an
//                           lse pointer (kernel 4) it also writes each row's
//                           m * scale + ln(l), NEG_INF where l == 0.
//
// setmaxnreg moves registers from the producer (24) to the consumers (240).
//
// An instance's D columns are 64-column chunks loaded with a 128-byte
// swizzle plus, for D = 80, one 16-column tail loaded with a 32-byte swizzle
// (an 80-wide row is 160 bytes, more than one 128-byte swizzle span). QK^T
// is then 4 + 1 k-steps over two pairs of descriptors, and PV one n64 and one
// n16 wgmma. A head dim d below the instance's D (any multiple of 8 up to D,
// head_dim_instance) keeps d as the tensor maps' innermost extent: TMA fills
// the box columns d .. D - 1 with zeros, which add nothing to Q K^T and give
// O columns of 0, and the epilogue stores only the first d columns. Nothing
// is padded in device memory.
//
// The 256-column instance (Layout<256>) keeps the host's plan units (128-row
// items, 128-key tiles, the known-unmasked tile ranges) and walks each 128-key
// tile as two 64-key stages: a 128 x 256 Q tile is 64 KB, so one Q buffer and
// two stages of 64-key K and V sub-tiles (32 KB each) fill 192 KB of shared
// memory; a consumer thread holds O (64 x 256 f32: 128 registers) beside a
// 64 x 64 S tile (32) and its bf16 P fragments (16). S = Q K^T is then
// wgmma m64n64k16, PV four n64 products a k16 step.
//
// Above 256 columns (attention_sm90_sliced_kernel, SliceLayout) a work item
// is (q tile, column slice of 256): O of 256 columns would not fit beside the
// whole head dim's Q tile (a 128 x 512 bf16 tile is 128 KB), and a 64 x 512
// f32 O is 256 registers a thread. So each 64-key stage of S = Q K^T is summed
// over d / 64 chunk stages of a ring, each a 64-column chunk of the Q tile
// and of the K stage (the Q tile re-read from L2 once a stage), in the same
// chunk order in every slice, so every slice computes the same bits of m and
// l; then O += P V over the slice's 256 columns of V (its own ring). No
// slice needs another's result: S is computed once a slice, 1.5x the
// products at 512 columns. A slice's columns past d are TMA's zeros, never
// stored, and only slice 0 writes the lse.
//
// GQA (kernels 2 and 4) folds the rep = H / Hkv q heads of a kv head into an
// item: floor(128 / rep) tokens x rep heads, rows r = token * rep + head. For
// a rep that does not divide 128 (5, 7, ...) rows rep * floor(128 / rep) ..
// 127 are idle: no TMA box reaches them, the kernel zeroes them in both Q
// buffers once at its start, and the epilogue never stores them.
//
// Semantics (those of the Pallas kernels): bf16 matmul inputs with f32
// accumulation; the D^-0.5 scale applied to the f32 logits; a masked logit
// gives p = 0, never exp(0); a row with no valid key gives 0. The mask is
// evaluated only on the tiles an item marks as masked: the others are known
// on the host (kernel 1) or from kv_len (kernel 2) to be valid throughout.
#pragma once

#include "sm90_common.cuh"

namespace socio90 {

constexpr int kBM = 128;         // query rows per work item (2 consumer warpgroups x 64)
constexpr int kBN = 128;         // keys per K/V tile of the plan

// Keys per K/V ring stage of the instance of D columns: a whole 128-key tile,
// or, above 128 columns, each half of one (the host's tensor-map boxes).
__host__ __device__ constexpr int stage_keys(int D) { return D > 128 ? 64 : kBN; }

constexpr int kThreads = 384;    // 2 consumer warpgroups + 1 producer warpgroup
constexpr float kNegInf = -1e30f;   // lse of a row with no valid key (the Pallas NEG_INF)
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout for head dim D (offsets from a 1024-byte-aligned base;
// a 128-byte swizzle repeats every 1024 bytes, so every operand tile starts on
// such a boundary).
template <int D>
struct Layout {
  static constexpr int kMain = D / 64;    // 64-column chunks (128-byte swizzle)
  static constexpr int kTail = D % 64;    // 0 or 16 columns (32-byte swizzle)
  static_assert(kTail == 0 || kTail == 16, "an instance is 64k or 64k + 16 columns");
  static constexpr int kKeys = stage_keys(D);  // keys of one K/V stage
  static constexpr int kSub = kBN / kKeys;     // stages a 128-key tile of the plan takes
  static constexpr int kQBufs = D > 128 ? 1 : 2;   // Q ring depth (the next item's Q loads early)
  static constexpr uint32_t q_chunk = kBM * 64 * 2;      // bytes of one Q chunk
  static constexpr uint32_t kv_chunk = kKeys * 64 * 2;
  static constexpr uint32_t q_tail = kMain * q_chunk;    // offset of the Q tail
  static constexpr uint32_t kv_tail = kMain * kv_chunk;
  static constexpr uint32_t q_bytes = kBM * D * 2;       // bytes of a full Q tile
  static constexpr uint32_t kv_bytes = kKeys * D * 2;    // of a K (or V) stage
  static constexpr uint32_t q_buf = (q_bytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kv_buf = (kv_bytes + 1023) / 1024 * 1024;
  static constexpr uint32_t off_k = kQBufs * q_buf;
  // K/V ring depth: three stages where they fit beside the two Q buffers
  static constexpr int kStages = kQBufs * q_buf + 6 * kv_buf <= 200 * 1024 ? 3 : 2;
  static constexpr uint32_t off_v = off_k + kStages * kv_buf;
  static constexpr uint32_t off_bar = off_v + kStages * kv_buf;
  static constexpr uint32_t n_bars = 2 * kQBufs + 3 * kStages;
  static constexpr uint32_t smem = off_bar + n_bars * 8 + 1024;   // + alignment slack
  static_assert(smem <= 232448, "the H100's shared memory a block");
};

// Everything a launch needs, passed by value as a __grid_constant__ so the
// tensor maps live in parameter space, where TMA can read them.
struct FwdParams {
  CUtensorMap q_main, q_tail, k_main, k_tail, v_main, v_tail;
  bf16* o;
  long long sob, sot, soh;   // output strides (elements); sob unused by kernel 1
  int n_items;
  float scale_log2;          // D^-0.5 * log2(e)
  int q_rows;                // rows of a Q tile that TMA fills: 128 (kernel 1), rep * toks
  int d;                     // the tensors' head dim: columns stored (<= the instance's D)
  int slices;                // column slices of 256 (head_dim_slices): above 1, the sliced CTA
  // kernels 2 and 4 (GQA prefill, training forward): q (B, Lq, H, D), k/v
  // (B, Lk, Hkv, D)
  const int* kv_lens;        // (B,)
  float* lse;                // (B, H, Lq) f32 log-sum-exp (kernel 4), or nullptr
  int B, Lq, Lk, Hkv, rep, causal, n_ttiles;
  // kernel 1 (segmented ViT): q/k/v (S, H, D)
  const int* seg;            // (S,) segment ids
  const int* work;           // (n_items,) item -> (head << 16) | q tile
  // (n_tiles, 2) per q tile: {first row, rows, first key, k tiles} and
  // {first, last k tile known unmasked, 0, 0}
  const int4* tiles;
  int S;
};

// ------------------------------------------------------------ work items

// One q tile: what the producer loads and the consumers compute.
struct Item {
  int t0;        // first token of the tile
  int rows;      // kernel 1: the tile's rows (t0 .. t0 + rows - 1)
  int head;      // kernel 1: q/k/v head; kernel 2: kv head g
  int b;         // kernel 2: batch row
  int k0;        // first key of k tile 0
  int lo, hi;    // k tiles lo..hi (empty when lo > hi), keys k0 + j * kBN ..
  int nm_lo, nm_hi;   // k tiles known valid throughout (no mask)
  int kv_len;    // kernel 2
};

// The (batch row, kv head, first token) of GQA work item `item` (kernels 2, 4
// and 5) over token tiles of `toks` tokens: the last token tiles (the most
// keys under a causal mask) come first, so the round-robin over persistent
// CTAs ends on light items; within a token tile the (batch row, kv head)
// order rotates from one token tile to the next, so that a CTA, which takes
// every gridDim.x-th item, does not meet the same batch row (and its kv_len)
// in all its items. Compiled for the host too: socio_gqa_item exports it,
// so that the host's copy (ops/flash_attention.py gqa_work_item) is held to
// it.
__host__ __device__ __forceinline__ int3 gqa_item(int item, int B, int Hkv, int n_ttiles,
                                                  int toks) {
  const int bg_n = B * Hkv;
  const int row = item / bg_n;
  const int bg = (item + row) % bg_n;
  return make_int3(bg / Hkv, bg % Hkv, (n_ttiles - 1 - row) * toks);
}

// Kernel 2's k range for the token tile of `toks` tokens from t0: it visits
// k tiles 0 .. x - 1 and evaluates the mask only on tiles >= y (the tiles
// before reach neither past its first token nor past kv_len). Compiled for
// the host too: socio_prefill_tile_bounds exports it, so that the host's copy
// of the formula (ops/flash_attention.py prefill_tile_bounds) is held to it.
__host__ __device__ __forceinline__ int2 prefill_k_tiles(int t0, int toks, int kv_len, int Lq,
                                                         int Lk, int causal) {
  kv_len = kv_len < 0 ? 0 : (kv_len > Lk ? Lk : kv_len);
  int k_hi = kv_len;
  int k_free = kv_len;   // keys every row of the tile may see
  if (causal) {
    const int t_end = t0 + toks < Lq ? t0 + toks : Lq;
    k_hi = k_hi < t_end ? k_hi : t_end;
    k_free = k_free < t0 + 1 ? k_free : t0 + 1;
  }
  return make_int2((k_hi + kBN - 1) / kBN, k_free / kBN);
}

// A GQA item of the launch `p` (FwdParams here, the dq kernel's own Params
// there: both name kv_lens, B, Lq, Lk, Hkv, rep, causal and n_ttiles).
template <class P>
__device__ __forceinline__ Item resolve_gqa(const P& p, int item) {
  Item it;
  const int toks = kBM / p.rep;
  const int3 w = gqa_item(item, p.B, p.Hkv, p.n_ttiles, toks);
  it.b = w.x;
  it.head = w.y;
  it.t0 = w.z;
  it.rows = kBM;
  it.k0 = 0;
  it.kv_len = min(max(p.kv_lens[it.b], 0), p.Lk);
  const int2 n = prefill_k_tiles(it.t0, toks, it.kv_len, p.Lq, p.Lk, p.causal);
  it.lo = 0;
  it.hi = n.x - 1;
  it.nm_lo = 0;
  it.nm_hi = n.y - 1;
  return it;
}

template <bool kSeg>
__device__ __forceinline__ Item resolve(const FwdParams& p, int item) {
  Item it;
  if constexpr (kSeg) {
    const int w = p.work[item];
    const int i = w & 0xFFFF;
    it.head = w >> 16;
    it.b = 0;
    const int4 t = p.tiles[2 * i], u = p.tiles[2 * i + 1];
    it.t0 = t.x;
    it.rows = t.y;
    it.k0 = t.z;
    it.lo = 0;
    it.hi = t.w - 1;
    it.nm_lo = u.x;
    it.nm_hi = u.y;
    it.kv_len = 0;
  } else {
    it = resolve_gqa(p, item);
  }
  return it;
}

// ------------------------------------------------------------- producer

template <int D, bool kSeg>
__device__ __forceinline__ void producer(const FwdParams& p, uint32_t base) {
  using L = Layout<D>;
  constexpr int kQBufs = L::kQBufs;
  const uint32_t bars = base + L::off_bar;
  int qs = 0, ks = 0;
  uint32_t qph = 0, kph = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve<kSeg>(p, item);
    const uint32_t q_full = bars + 8 * qs, q_empty = bars + 8 * (kQBufs + qs);
    mbar_wait(q_empty, qph ^ 1);
    mbar_expect_tx(q_full, p.q_rows * D * 2);    // the box's rows, idle ones excluded
    const uint32_t qb = base + qs * L::q_buf;
#pragma unroll
    for (int c = 0; c <= L::kMain; ++c) {
      if (c == L::kMain && L::kTail == 0) break;
      const uint32_t dst = qb + (c < L::kMain ? c * L::q_chunk : L::q_tail);
      const CUtensorMap* map = c < L::kMain ? &p.q_main : &p.q_tail;
      if constexpr (kSeg) tma_load_3d(dst, map, q_full, 64 * c, it.head, it.t0);
      else tma_load_4d(dst, map, q_full, 64 * c, it.head * p.rep, it.t0, it.b);
    }
    if (++qs == kQBufs) { qs = 0; qph ^= 1; }
    for (int js = it.lo * L::kSub; js < (it.hi + 1) * L::kSub; ++js) {
      const int key = js * L::kKeys;       // the stage's first key past k0
      const uint32_t k_full = bars + 8 * (2 * kQBufs + ks);
      const uint32_t v_full = bars + 8 * (2 * kQBufs + L::kStages + ks);
      const uint32_t kv_empty = bars + 8 * (2 * kQBufs + 2 * L::kStages + ks);
      mbar_wait(kv_empty, kph ^ 1);
      const uint32_t kb = base + L::off_k + ks * L::kv_buf;
      const uint32_t vb = base + L::off_v + ks * L::kv_buf;
      mbar_expect_tx(k_full, L::kv_bytes);
#pragma unroll
      for (int c = 0; c <= L::kMain; ++c) {
        if (c == L::kMain && L::kTail == 0) break;
        const uint32_t off = c < L::kMain ? c * L::kv_chunk : L::kv_tail;
        const CUtensorMap* map = c < L::kMain ? &p.k_main : &p.k_tail;
        if constexpr (kSeg) tma_load_3d(kb + off, map, k_full, 64 * c, it.head, it.k0 + key);
        else tma_load_4d(kb + off, map, k_full, 64 * c, it.head, key, it.b);
      }
      mbar_expect_tx(v_full, L::kv_bytes);
#pragma unroll
      for (int c = 0; c <= L::kMain; ++c) {
        if (c == L::kMain && L::kTail == 0) break;
        const uint32_t off = c < L::kMain ? c * L::kv_chunk : L::kv_tail;
        const CUtensorMap* map = c < L::kMain ? &p.v_main : &p.v_tail;
        if constexpr (kSeg) tma_load_3d(vb + off, map, v_full, 64 * c, it.head, it.k0 + key);
        else tma_load_4d(vb + off, map, v_full, 64 * c, it.head, key, it.b);
      }
      if (++ks == L::kStages) { ks = 0; kph ^= 1; }
    }
  }
}

// ------------------------------------------------------------- consumer

// One consumer warpgroup's 64 rows; the two consumer warpgroups of a CTA
// overlap each other's products and softmax. kPart: the tensors' head dim
// p.d is below the instance's D, and the epilogue stores only its columns.
template <int D, bool kSeg, bool kPart>
__device__ __forceinline__ void consumer(const FwdParams& p, uint32_t base, int wg) {
  using L = Layout<D>;
  constexpr int kQBufs = L::kQBufs;
  constexpr int kN = L::kKeys;              // keys of a stage (the S tile's columns)
  constexpr int kM = L::kMain;
  constexpr int kT = L::kTail ? 8 : 1;      // registers of the n16 tail accumulator
  const uint32_t bars = base + L::off_bar;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  // this thread's two rows of the 128-row tile, and its column pair within
  // each 8-column group of an accumulator (the wgmma fragment layout)
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  int qs = 0, ks = 0;
  uint32_t qph = 0, kph = 0;

  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve<kSeg>(p, item);
    // per-row mask inputs: segment id (kernel 1) or token (kernel 2)
    int rkey[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if constexpr (kSeg) {
        const int t = it.t0 + r;
        // rows past the tile and keys past S carry the sentinels -1 / -2,
        // which never match
        rkey[i] = r < it.rows ? p.seg[t] : -1;
      } else {
        rkey[i] = it.t0 + r / p.rep;
      }
    }
    float o[kM][32];
    float ot[kT];
#pragma unroll
    for (int c = 0; c < kM; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int e = 0; e < kT; ++e) ot[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[kN / 2];
    uint32_t pa[kN / 16][4];

    const uint32_t q_empty = bars + 8 * (kQBufs + qs);
    const uint32_t qb = base + qs * L::q_buf;
    auto k_full = [&](int st) { return bars + 8 * (2 * kQBufs + st); };
    auto v_full = [&](int st) { return bars + 8 * (2 * kQBufs + L::kStages + st); };
    auto kv_empty = [&](int st) { return bars + 8 * (2 * kQBufs + 2 * L::kStages + st); };

    // S (64 x kN) (+)= A B^T: wgmma n128 on a 128-key stage, n64 on a 64-key one
    auto mma_s = [&](uint64_t da, uint64_t db, int scale_d) {
      if constexpr (kN == 128) wgmma_ss_n128(s, da, db, scale_d);
      else wgmma_ss_n64(s, da, db, scale_d);
    };
    // S = Q K^T over the head dim (4 k-steps per 64-column chunk, then the
    // tail), issued and committed as one group
    auto issue_s = [&](int st) {
      const uint32_t kb = base + L::off_k + st * L::kv_buf;
      wg_fence();
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_s(make_desc(qb + c * L::q_chunk + wg * 8192 + kk * 32, 16, 1024, kSw128),
                make_desc(kb + c * L::kv_chunk + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
      if constexpr (L::kTail != 0)
        mma_s(make_desc(qb + L::q_tail + wg * 2048, 16, 256, kSw32),
              make_desc(kb + L::kv_tail, 16, 256, kSw32), kM > 0);
      wg_commit();
    };
    // O += P V, one group
    auto issue_pv = [&](int st) {
      const uint32_t vb = base + L::off_v + st * L::kv_buf;
      wg_fence();
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs_n64(o[c], pa[kk],
                       make_desc(vb + c * L::kv_chunk + kk * 2048, L::kv_chunk, 1024, kSw128));
      if constexpr (L::kTail != 0) {
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs_n16(ot, pa[kk], make_desc(vb + L::kv_tail + kk * 512, 512, 256, kSw32));
      }
      wg_commit();
    };
    // mask stage js of tile j = js / kSub (only outside the item's
    // known-valid range), then the online-softmax update of m and l; s
    // becomes p, corr the factor that O has to be scaled by
    auto softmax = [&](int js) {
      const int j = js / L::kSub;
      if (j < it.nm_lo || j > it.nm_hi) {
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = it.k0 + js * kN + 8 * g + cq + e;
            if constexpr (kSeg) {
              const int ks_id = key < p.S ? p.seg[key] : -2;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (rkey[i] != ks_id) s[4 * g + 2 * i + e] = -INFINITY;
            } else {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (key >= it.kv_len || (p.causal && key > rkey[i]))
                  s[4 * g + 2 * i + e] = -INFINITY;
            }
          }
        }
      }
      // a row's columns sit in the 4 threads of a quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) mx = fmaxf(mx, fmaxf(s[4 * g + 2 * i], s[4 * g + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // while a row has seen only masked logits, m stays -inf: subtract 0
        // so that p = ex2(-inf) = 0 and corr = 0 (O and l are 0 anyway)
        const float m_sc = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
        corr[i] = ex2(m[i] * p.scale_log2 - m_sc);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(s[4 * g + 2 * i + e] * p.scale_log2 - m_sc);
            s[4 * g + 2 * i + e] = pe;
            sum += pe;
          }
        }
        l[i] = l[i] * corr[i] + sum;        // this thread's partial row sum
      }
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < kM; ++c)
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            o[c][4 * g + 2 * i] *= corr[i];
            o[c][4 * g + 2 * i + 1] *= corr[i];
          }
        if constexpr (L::kTail != 0) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            ot[4 * g + 2 * i] *= corr[i];
            ot[4 * g + 2 * i + 1] *= corr[i];
          }
        }
      }
    };
    // P in bf16 as the A fragments of the k16 steps (keys 16kk..16kk+15):
    // the accumulator layout of S is the A-operand layout of PV
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release_q = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    };

    mbar_wait(bars + 8 * qs, qph);
    if (it.lo > it.hi) {
      release_q();                // no key: release Q at once
    } else {
      for (int js = it.lo * L::kSub; js < (it.hi + 1) * L::kSub; ++js) {
        mbar_wait(k_full(ks), kph);
        issue_s(ks);
        wg_wait0();
        reg_fence(s);
        if (js == (it.hi + 1) * L::kSub - 1) release_q();    // the item's last use of Q
        softmax(js);
        rescale_o();
        pack_p();
        mbar_wait(v_full(ks), kph);
        issue_pv(ks);
        wg_wait0();
#pragma unroll
        for (int c = 0; c < kM; ++c) reg_fence(o[c]);
        reg_fence(ot);
        reg_keep(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty(ks));
        if (++ks == L::kStages) { ks = 0; kph ^= 1; }
      }
    }
    if (++qs == kQBufs) { qs = 0; qph ^= 1; }

    // epilogue: O / l, 0 where l == 0, bf16 pairs straight from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lsum = l[i];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
      const int r = row0 + 8 * i;
      bf16* dst = nullptr;
      if constexpr (kSeg) {
        if (r < it.rows) dst = p.o + (it.t0 + r) * p.sot + it.head * p.soh;
      } else {
        const int t = it.t0 + r / p.rep;
        const int h = it.head * p.rep + r % p.rep;
        if (r < p.q_rows && t < p.Lq) {      // idle rows and rows past Lq: no store
          dst = p.o + it.b * p.sob + t * p.sot + h * p.soh;
          // m is a raw logit (its scale folded into the exp2) and the quad's
          // lsum sums exp2(s * scale_log2 - m * scale_log2): in natural-log
          // units lse = m * scale + ln(lsum); one lane of the quad writes it
          if (p.lse != nullptr && (lane & 3) == 0)
            p.lse[((long long)it.b * p.Hkv * p.rep + h) * p.Lq + t] =
                lsum == 0.f ? kNegInf : m[i] * p.scale_log2 * kLn2 + logf(lsum);
        }
      }
      if (dst == nullptr) continue;
      // the first d columns only (d % 8 == 0: a column group is stored whole
      // or not at all)
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          if (!kPart || 64 * c + 8 * g < p.d)
            *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * g + cq) =
                pack_bf16(o[c][4 * g + 2 * i] * inv, o[c][4 * g + 2 * i + 1] * inv);
      if constexpr (L::kTail != 0) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
          if (!kPart || 64 * kM + 8 * g < p.d)
            *reinterpret_cast<uint32_t*>(dst + 64 * kM + 8 * g + cq) =
                pack_bf16(ot[4 * g + 2 * i] * inv, ot[4 * g + 2 * i + 1] * inv);
      }
    }
  }
}

// -------------------------------------------- column slices (D > 256)

// Shared-memory layout of the sliced CTA (offsets from a 1024-byte-aligned
// base). A ring of Q/K chunk stages -- a 64-column chunk of the 128-row Q
// tile and of a 64-key K stage, 24 KB -- feeds S = Q K^T over all d columns;
// a ring of V stages holds the 64 keys' 256 columns of the work item's slice
// (32 KB), for O += P V. The Q tile is re-read from L2 once a key stage.
struct SliceLayout {
  static constexpr int kKeys = 64;                 // keys of a stage
  static constexpr int kSub = kBN / kKeys;         // stages a 128-key tile of the plan takes
  static constexpr int kCols = kSliceCols;         // O columns of a slice
  static constexpr int kQK = 6;                    // Q/K chunk ring depth
  static constexpr int kV = 2;                     // V ring depth
  static constexpr uint32_t q_chunk = kBM * 64 * 2;           // 16 KB
  static constexpr uint32_t k_chunk = kKeys * 64 * 2;         // 8 KB
  static constexpr uint32_t qk_stage = q_chunk + k_chunk;
  static constexpr uint32_t v_chunk = kKeys * 64 * 2;
  static constexpr uint32_t v_stage = kCols / 64 * v_chunk;   // 32 KB
  static constexpr uint32_t off_v = kQK * qk_stage;
  static constexpr uint32_t off_bar = off_v + kV * v_stage;
  // barriers: Q/K full[kQK], Q/K empty[kQK], V full[kV], V empty[kV]
  static constexpr uint32_t n_bars = 2 * kQK + 2 * kV;
  static constexpr uint32_t smem = off_bar + n_bars * 8 + 1024;   // + alignment slack
  static_assert(qk_stage % 1024 == 0 && smem <= 232448, "the H100's shared memory a block");
  __device__ static uint32_t qk_full(uint32_t bars, int st) { return bars + 8 * st; }
  __device__ static uint32_t qk_empty(uint32_t bars, int st) { return bars + 8 * (kQK + st); }
  __device__ static uint32_t v_full(uint32_t bars, int st) { return bars + 8 * (2 * kQK + st); }
  __device__ static uint32_t v_empty(uint32_t bars, int st) {
    return bars + 8 * (2 * kQK + kV + st);
  }
};

// The producer of the sliced CTA: work item w is q tile w / slices, column
// slice w % slices; for each of its 64-key stages, the d / 64 Q and K chunks
// (each stage a (Q chunk, K chunk) pair), then the slice's V columns.
template <bool kSeg>
__device__ __forceinline__ void producer_sliced(const FwdParams& p, uint32_t base) {
  using L = SliceLayout;
  const uint32_t bars = base + L::off_bar;
  const int nc = (p.d + 63) / 64;
  int qs = 0, vs = 0;
  uint32_t qph = 0, vph = 0;
  for (int w = blockIdx.x; w < p.n_items * p.slices; w += gridDim.x) {
    const int col0 = L::kCols * (w % p.slices);
    const Item it = resolve<kSeg>(p, w / p.slices);
    for (int js = it.lo * L::kSub; js < (it.hi + 1) * L::kSub; ++js) {
      const int key = js * L::kKeys;
      for (int c = 0; c < nc; ++c) {
        const uint32_t full = L::qk_full(bars, qs), dst = base + qs * L::qk_stage;
        mbar_wait(L::qk_empty(bars, qs), qph ^ 1);
        mbar_expect_tx(full, p.q_rows * 128 + L::k_chunk);
        if constexpr (kSeg) {
          tma_load_3d(dst, &p.q_main, full, 64 * c, it.head, it.t0);
          tma_load_3d(dst + L::q_chunk, &p.k_main, full, 64 * c, it.head, it.k0 + key);
        } else {
          tma_load_4d(dst, &p.q_main, full, 64 * c, it.head * p.rep, it.t0, it.b);
          tma_load_4d(dst + L::q_chunk, &p.k_main, full, 64 * c, it.head, key, it.b);
        }
        if (++qs == L::kQK) { qs = 0; qph ^= 1; }
      }
      const uint32_t full = L::v_full(bars, vs), dst = base + L::off_v + vs * L::v_stage;
      mbar_wait(L::v_empty(bars, vs), vph ^ 1);
      mbar_expect_tx(full, L::v_stage);
#pragma unroll
      for (int c = 0; c < L::kCols / 64; ++c) {
        if constexpr (kSeg)
          tma_load_3d(dst + c * L::v_chunk, &p.v_main, full, col0 + 64 * c, it.head, it.k0 + key);
        else
          tma_load_4d(dst + c * L::v_chunk, &p.v_main, full, col0 + 64 * c, it.head, key, it.b);
      }
      if (++vs == L::kV) { vs = 0; vph ^= 1; }
    }
  }
}

// One consumer warpgroup of the sliced CTA: the consumer above with S = Q K^T
// accumulated over the Q/K chunk stages (the same chunk order in every slice,
// so every slice computes the same bits of m and l) and O of its slice's 256
// columns. Columns of the slice past d read zeros (TMA) and are not stored;
// only slice 0 writes the lse.
template <bool kSeg>
__device__ __forceinline__ void consumer_sliced(const FwdParams& p, uint32_t base, int wg) {
  using L = SliceLayout;
  constexpr int kN = L::kKeys;
  constexpr int kM = L::kCols / 64;
  const uint32_t bars = base + L::off_bar;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int nc = (p.d + 63) / 64;
  int qs = 0, vs = 0;
  uint32_t qph = 0, vph = 0;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  for (int w = blockIdx.x; w < p.n_items * p.slices; w += gridDim.x) {
    const int slice = w % p.slices;
    const int col0 = L::kCols * slice;
    const Item it = resolve<kSeg>(p, w / p.slices);
    int rkey[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if constexpr (kSeg) {
        const int t = it.t0 + r;
        rkey[i] = r < it.rows ? p.seg[t] : -1;
      } else {
        rkey[i] = it.t0 + r / p.rep;
      }
    }
    float o[kM][32];
#pragma unroll
    for (int c = 0; c < kM; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[kN / 2];
    uint32_t pa[kN / 16][4];

    for (int js = it.lo * L::kSub; js < (it.hi + 1) * L::kSub; ++js) {
      // S = Q K^T, one group a chunk; a chunk's stage is released once the
      // group after it is issued and it is done (wait_group 1)
      int prev = 0;
      for (int c = 0; c < nc; ++c) {
        mbar_wait(L::qk_full(bars, qs), qph);
        const uint32_t qb = base + qs * L::qk_stage, kb = qb + L::q_chunk;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(s, make_desc(qb + wg * 8192 + kk * 32, 16, 1024, kSw128),
                       make_desc(kb + kk * 32, 16, 1024, kSw128), (c | kk) != 0);
        wg_commit();
        if (c > 0) {
          wg_wait1();
          release(L::qk_empty(bars, prev));
        }
        prev = qs;
        if (++qs == L::kQK) { qs = 0; qph ^= 1; }
      }
      wg_wait0();
      reg_fence(s);
      release(L::qk_empty(bars, prev));
      // the mask (outside the known-valid tiles) and the online softmax, as
      // in consumer()
      const int j = js / L::kSub;
      if (j < it.nm_lo || j > it.nm_hi) {
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = it.k0 + js * kN + 8 * g + cq + e;
            if constexpr (kSeg) {
              const int ks_id = key < p.S ? p.seg[key] : -2;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (rkey[i] != ks_id) s[4 * g + 2 * i + e] = -INFINITY;
            } else {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (key >= it.kv_len || (p.causal && key > rkey[i]))
                  s[4 * g + 2 * i + e] = -INFINITY;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) mx = fmaxf(mx, fmaxf(s[4 * g + 2 * i], s[4 * g + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float m_sc = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
        corr[i] = ex2(m[i] * p.scale_log2 - m_sc);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(s[4 * g + 2 * i + e] * p.scale_log2 - m_sc);
            s[4 * g + 2 * i + e] = pe;
            sum += pe;
          }
        }
        l[i] = l[i] * corr[i] + sum;
#pragma unroll
        for (int c = 0; c < kM; ++c)
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            o[c][4 * g + 2 * i] *= corr[i];
            o[c][4 * g + 2 * i + 1] *= corr[i];
          }
      }
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P V over the slice's columns
      mbar_wait(L::v_full(bars, vs), vph);
      const uint32_t vb = base + L::off_v + vs * L::v_stage;
      wg_fence();
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs_n64(o[c], pa[kk],
                       make_desc(vb + c * L::v_chunk + kk * 2048, L::v_chunk, 1024, kSw128));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int c = 0; c < kM; ++c) reg_fence(o[c]);
      reg_keep(pa);
      release(L::v_empty(bars, vs));
      if (++vs == L::kV) { vs = 0; vph ^= 1; }
    }

    // epilogue: O / l, 0 where l == 0, the slice's columns below d
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lsum = l[i];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
      const int r = row0 + 8 * i;
      bf16* dst = nullptr;
      if constexpr (kSeg) {
        if (r < it.rows) dst = p.o + (it.t0 + r) * p.sot + it.head * p.soh;
      } else {
        const int t = it.t0 + r / p.rep;
        const int h = it.head * p.rep + r % p.rep;
        if (r < p.q_rows && t < p.Lq) {
          dst = p.o + it.b * p.sob + t * p.sot + h * p.soh;
          if (p.lse != nullptr && slice == 0 && (lane & 3) == 0)
            p.lse[((long long)it.b * p.Hkv * p.rep + h) * p.Lq + t] =
                lsum == 0.f ? kNegInf : m[i] * p.scale_log2 * kLn2 + logf(lsum);
        }
      }
      if (dst == nullptr) continue;
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          if (col0 + 64 * c + 8 * g < p.d)
            *reinterpret_cast<uint32_t*>(dst + col0 + 64 * c + 8 * g + cq) =
                pack_bf16(o[c][4 * g + 2 * i] * inv, o[c][4 * g + 2 * i + 1] * inv);
    }
  }
}

template <bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    attention_sm90_sliced_kernel(const __grid_constant__ FwdParams p) {
  using L = SliceLayout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::off_bar;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kQK; ++s) {
      mbar_init(L::qk_full(bars, s), 1);     // the producer's expect_tx
      mbar_init(L::qk_empty(bars, s), 8);    // one arrive per consumer warp
    }
    for (int s = 0; s < L::kV; ++s) {
      mbar_init(L::v_full(bars, s), 1);
      mbar_init(L::v_empty(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the idle rows of every stage's Q chunk: zeros for good
  for (int s = 0; s < L::kQK; ++s)
    zero_smem(base + s * L::qk_stage + p.q_rows * 128, (kBM - p.q_rows) * 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) producer_sliced<kSeg>(p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer_sliced<kSeg>(p, base, wg);
  }
}

// ---------------------------------------------------------------- kernel

template <int D, bool kSeg, bool kPart>
__global__ void __launch_bounds__(kThreads, 1) attention_sm90_kernel(const __grid_constant__ FwdParams p) {
  using L = Layout<D>;
  constexpr int kQBufs = L::kQBufs;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::off_bar;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQBufs; ++s) {
      mbar_init(bars + 8 * s, 1);                  // Q full: the producer's expect_tx
      mbar_init(bars + 8 * (kQBufs + s), 8);       // Q empty: one arrive per consumer warp
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars + 8 * (2 * kQBufs + s), 1);              // K full
      mbar_init(bars + 8 * (2 * kQBufs + L::kStages + s), 1);    // V full
      mbar_init(bars + 8 * (2 * kQBufs + 2 * L::kStages + s), 8);  // K/V empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the idle rows of both Q buffers: zeros for good (no TMA box reaches them)
  for (int s = 0; s < kQBufs; ++s) {
    const uint32_t qb = base + s * L::q_buf;
    for (int c = 0; c < L::kMain; ++c)
      zero_smem(qb + c * L::q_chunk + p.q_rows * 128, (kBM - p.q_rows) * 128);
    if constexpr (L::kTail != 0) zero_smem(qb + L::q_tail + p.q_rows * 32, (kBM - p.q_rows) * 32);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // before wgmma reads them
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) producer<D, kSeg>(p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer<D, kSeg, kPart>(p, base, wg);
  }
}

// ------------------------------------------------------------------ host

// One persistent CTA per SM (at most one per item).
template <int D, bool kSeg, bool kPart>
int launch(const FwdParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(attention_sm90_kernel<D, kSeg, kPart>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Layout<D>::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (p.n_items <= 0) return 0;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  attention_sm90_kernel<D, kSeg, kPart><<<grid, kThreads, Layout<D>::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instance D's kernel for tensors of head dim p.d <= D: the one whose
// epilogue guards its column stores where p.d < D, and the unguarded one at
// p.d == D (the instance's own width pays nothing for narrower head dims).
template <int D, bool kSeg>
int launch_width(const FwdParams& p, cudaStream_t stream) {
  return p.d < D ? launch<D, kSeg, true>(p, stream) : launch<D, kSeg, false>(p, stream);
}

// A head dim above 256: p.slices column slices of each item, one persistent
// CTA per SM (at most one per (item, slice)).
template <bool kSeg>
int launch_sliced(const FwdParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(attention_sm90_sliced_kernel<kSeg>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SliceLayout::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int work = p.n_items * p.slices;
  if (work <= 0) return 0;
  const int grid = work < num_sms() ? work : num_sms();
  attention_sm90_sliced_kernel<kSeg><<<grid, kThreads, SliceLayout::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Kernels 2 and 4: GQA attention of q (B, Lq, H, D) over k/v (B, Lk, Hkv, D)
// (strides in elements; D a multiple of 8 up to 256, run on the instance
// head_dim_instance(kGqaDims, D)), writing o and, where lse is given, the per-row
// log-sum-exp (B, H, Lq). GQA is folded as in the Pallas grid: a 128-row item
// is floor(128 / rep) tokens x the rep q heads of one kv head, one 4-D TMA
// box (64 columns x rep heads x floor(128 / rep) tokens), since the rep heads
// are contiguous in (B, L, H, D); any rep up to 128. Defined in
// flash_prefill.cu, the one file that instantiates the kernel for it.
int launch_gqa(const void* q, const void* k, const void* v, void* o, float* lse,
               const void* kv_lens, int B, int Lq, int Lk, int H, int Hkv, int D,
               long long sqb, long long sqt, long long sqh, long long skb, long long skt,
               long long skh, long long svb, long long svt, long long svh,
               long long sob, long long sot, long long soh, int causal, float scale,
               cudaStream_t stream);

}  // namespace socio90
