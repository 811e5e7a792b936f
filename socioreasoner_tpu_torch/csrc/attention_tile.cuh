// The tiled attention CTA of the training forward (flash_train_fwd.cu):
// one CTA of 4 warps owns a 64-row query tile, walks
// 64-key tiles of K/V through shared memory, computes S = Q K^T and O += P V
// on the tensor cores with bf16 WMMA (f32 accumulation), and keeps the online
// softmax state (row max m, row sum l, unnormalised O) in shared memory.
//
// Each warp owns 16 of the 64 query rows for the whole kernel: it computes
// their scores, their softmax and their slice of O, so within a key tile the
// warps only meet at the K/V loads (__syncthreads) and otherwise synchronise
// with __syncwarp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace socio {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // query rows per CTA
constexpr int kCols = 64;              // keys per K/V tile
constexpr int kWarps = 4;              // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;      // masked logit (the Pallas kernels' NEG_INF)

// Padded shared-memory row strides (elements). A 16x16 WMMA load reads 16
// rows at one column; with unpadded 128- or 256-byte rows those rows share
// banks, so every row gets 16 extra bytes. WMMA wants bf16 strides in
// multiples of 8 and f32 strides in multiples of 4.
template <int D> struct Ld {
  static constexpr int qkv = D + 8;        // bf16 Q, K, V rows
  static constexpr int o = D + 4;          // f32 O rows
  static constexpr int s = kCols + 4;      // f32 score rows
  static constexpr int p = kCols + 8;      // bf16 probability rows
};

// Dynamic shared memory layout for head dim D. Every offset, and every
// 16-row step inside a region, is a multiple of 32 bytes, as WMMA fragment
// pointers require.
template <int D>
struct TileSmem {
  static constexpr size_t q = 0;                                     // bf16 [kRows][Ld::qkv]
  static constexpr size_t k = q + size_t(kRows) * Ld<D>::qkv * 2;    // bf16 [kCols][Ld::qkv]
  static constexpr size_t v = k + size_t(kCols) * Ld<D>::qkv * 2;    // bf16 [kCols][Ld::qkv]
  static constexpr size_t s = v + size_t(kCols) * Ld<D>::qkv * 2;    // f32  [kRows][Ld::s]
  static constexpr size_t p = s + size_t(kRows) * Ld<D>::s * 4;      // bf16 [kRows][Ld::p]
  static constexpr size_t o = p + size_t(kRows) * Ld<D>::p * 2;      // f32  [kRows][Ld::o]
  static constexpr size_t m = o + size_t(kRows) * Ld<D>::o * 4;      // f32  [kRows]
  static constexpr size_t l = m + kRows * 4;                         // f32  [kRows]
  static constexpr size_t segq = l + kRows * 4;                      // i32  [kRows]
  static constexpr size_t segk = segq + kRows * 4;                   // i32  [kCols]
  static constexpr size_t bytes = segk + kCols * 4;
};

// Copy 64 rows of D bf16 values into shared memory (row stride Ld::qkv) with
// 16-byte vector loads. row_ptr(r) gives the global row or nullptr, which
// stores zeros: rows past the valid range never feed garbage (NaN * 0) into
// the tensor-core products.
template <int D, typename RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, RowPtr row_ptr) {
  constexpr int kVec = D / 8;
  static_assert(kRows * kVec % kThreads == 0, "whole vectors per thread");
  // unrolled: every thread issues all its loads before the first store
#pragma unroll
  for (int it = 0; it < kRows * kVec / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kVec, c = i % kVec;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = reinterpret_cast<const uint4*>(src)[c];
    reinterpret_cast<uint4*>(dst + r * Ld<D>::qkv)[c] = val;
  }
}

template <int D>
__device__ __forceinline__ void init_state(float* O, float* m, float* l) {
  for (int i = threadIdx.x; i < kRows * Ld<D>::o; i += kThreads) O[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
}

// S[warp rows][0:kCols] = Q[warp rows] @ K^T (raw logits, f32).
template <int D>
__device__ __forceinline__ void scores_tile(const bf16* Qs, const bf16* Ks, float* Ss, int warp) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCols / 16];
#pragma unroll
  for (int n = 0; n < kCols / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Qs + warp * 16 * Ld<D>::qkv + kk * 16, Ld<D>::qkv);
#pragma unroll
    for (int n = 0; n < kCols / 16; ++n) {
      // K^T as a column-major (D x kCols) matrix is K row-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Ks + n * 16 * Ld<D>::qkv + kk * 16, Ld<D>::qkv);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kCols / 16; ++n)
    wmma::store_matrix_sync(Ss + warp * 16 * Ld<D>::s + n * 16, acc[n], Ld<D>::s,
                            wmma::mem_row_major);
}

// Online-softmax update of the warp's 16 rows, one row at a time: lane l
// takes columns l and l + 32 (consecutive lanes on consecutive words, so no
// bank conflicts) and the row max and sum are warp shuffles. Masked logits
// give p = 0 (never exp(0)), so a row with no valid key anywhere ends with
// l == 0 and its output is 0, as in the Pallas kernels.
// valid(r, c) says whether query row r may see key column c of this tile.
template <int D, typename Valid>
__device__ __forceinline__ void softmax_tile(const float* Ss, bf16* Ps, float* Os, float* m_s,
                                             float* l_s, int warp, float scale, Valid valid) {
  static_assert(kCols == 64, "two columns per lane");
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const float* srow = Ss + r * Ld<D>::s;
    const float s0 = valid(r, lane) ? srow[lane] * scale : kNegInf;
    const float s1 = valid(r, lane + 32) ? srow[lane + 32] * scale : kNegInf;
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const float p0 = s0 > 0.5f * kNegInf ? __expf(s0 - m_new) : 0.f;
    const float p1 = s1 > 0.5f * kNegInf ? __expf(s1 - m_new) : 0.f;
    Ps[r * Ld<D>::p + lane] = __float2bfloat16(p0);
    Ps[r * Ld<D>::p + lane + 32] = __float2bfloat16(p1);
    float sum = p0 + p1;
    // every lane has read m_old before any lane leaves this reduction
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float corr = __expf(m_old - m_new);
    float* orow = Os + r * Ld<D>::o;
    for (int d = lane; d < D; d += 32) orow[d] *= corr;
    if (lane == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
    }
  }
}

// O[warp rows] += P[warp rows] @ V, accumulating on the tensor cores straight
// into the f32 O tile in shared memory.
template <int D>
__device__ __forceinline__ void pv_tile(const bf16* Ps, const bf16* Vs, float* Os, int warp) {
  using namespace nvcuda;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, Os + warp * 16 * Ld<D>::o + n * 16, Ld<D>::o,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + warp * 16 * Ld<D>::p + kk * 16, Ld<D>::p);
      wmma::load_matrix_sync(b, Vs + kk * 16 * Ld<D>::qkv + n * 16, Ld<D>::qkv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Os + warp * 16 * Ld<D>::o + n * 16, acc, Ld<D>::o,
                            wmma::mem_row_major);
  }
}

// out row r = O[r] / l[r] (0 where l == 0), written as bf16 to row_ptr(r)
// unless that is nullptr.
template <int D, typename RowPtr>
__device__ __forceinline__ void write_rows(const float* Os, const float* l_s, RowPtr row_ptr) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    bf16* dst = row_ptr(r);
    if (dst == nullptr) continue;
    const float l = l_s[r];
    dst[d] = __float2bfloat16(Os[r * Ld<D>::o + d] / (l == 0.f ? 1.f : l));
  }
}

// Causal (or full) attention of q (B, Lq, H, D) over k/v (B, Lk, Hkv, D) with
// one valid KV length per batch row, read through the tensors' strides. One
// CTA serves all rep = H / Hkv q heads of one kv head (GQA folded as in the
// Pallas grid): its 64 query rows are 64 / rep tokens x rep heads, so each K/V
// tile feeds rep heads at once; it also writes the per-row log-sum-exp.
struct GqaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;          // (B, H, Lq) f32 log-sum-exp of the scaled logits, or nullptr
  const int* kv_lens;  // (B,)
  int Lq, Lk, Hkv, rep, causal;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  float scale;
};

// The CTA for (blockIdx.x = token tile, blockIdx.y = b * Hkv + g).
template <int D>
__device__ __forceinline__ void gqa_attention_cta(const GqaArgs& a, unsigned char* smem) {
  using L = TileSmem<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / a.Hkv;
  const int g = blockIdx.y % a.Hkv;
  const int rep = a.rep;
  const int toks = kRows / rep;           // query tokens in this CTA
  const int t0 = blockIdx.x * toks;
  const int kv_len = min(max(a.kv_lens[b], 0), a.Lk);

  // query row r = token t0 + r / rep, q head g * rep + r % rep (HF GQA order)
  load_rows<D>(Qs, [&](int r) -> const bf16* {
    const int t = t0 + r / rep;
    if (t >= a.Lq) return nullptr;
    return a.q + b * a.sqb + t * a.sqt + (g * rep + r % rep) * a.sqh;
  });
  init_state<D>(Os, m_s, l_s);

  int k_hi = kv_len;
  if (a.causal) k_hi = min(k_hi, min(t0 + toks, a.Lq));   // early exit at the diagonal
  const int n_tiles = (k_hi + kCols - 1) / kCols;
  __syncthreads();

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kCols;
    load_rows<D>(Ks, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < k_hi ? a.k + b * a.skb + key * a.skt + g * a.skh : nullptr;
    });
    load_rows<D>(Vs, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < k_hi ? a.v + b * a.svb + key * a.svt + g * a.svh : nullptr;
    });
    __syncthreads();
    scores_tile<D>(Qs, Ks, Ss, warp);
    __syncwarp();
    softmax_tile<D>(Ss, Ps, Os, m_s, l_s, warp, a.scale, [&](int r, int c) {
      const int t = t0 + r / rep;
      const int key = key0 + c;
      return t < a.Lq && key < kv_len && (!a.causal || key <= t);
    });
    __syncwarp();
    pv_tile<D>(Ps, Vs, Os, warp);
    __syncthreads();
  }
  __syncthreads();
  write_rows<D>(Os, l_s, [&](int r) -> bf16* {
    const int t = t0 + r / rep;
    if (t >= a.Lq) return nullptr;
    return a.o + b * a.sob + t * a.sot + (g * rep + r % rep) * a.soh;
  });
  if (a.lse != nullptr) {
    // lse = m + log(l); a row that saw no key keeps m = kNegInf and l = 0,
    // and gets kNegInf, as the Pallas kernel's m + log(lsafe) does
    const long long H = (long long)a.Hkv * rep;
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const int t = t0 + r / rep;
      if (t >= a.Lq) continue;
      const float l = l_s[r];
      a.lse[(b * H + g * rep + r % rep) * a.Lq + t] = l == 0.f ? kNegInf : m_s[r] + logf(l);
    }
  }
}

}  // namespace socio
