// One Hopper forward-attention CTA, shared by the prefill kernel
// (flash_prefill.cu) and the ViT's segment-masked kernel (flash_segmented.cu).
//
// A CTA is persistent: it walks work items (q tiles of 128 rows) blockIdx.x,
// blockIdx.x + gridDim.x, ... and is warp specialised into three warpgroups:
//
//   warpgroup 2 (producer)  one thread keeps TMA loads (cp.async.bulk.tensor)
//                           in flight: the item's Q tile into a ring of two
//                           Q buffers, then its K and V tiles (128 keys) into
//                           a ring of 2-3 stages, each with full and
//                           empty mbarriers. It runs ahead into the next
//                           item while the consumers finish the current one.
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
//                           stores bf16 straight from registers.
//
// setmaxnreg moves registers from the producer (24) to the consumers (240).
//
// Head dims are 64-column chunks loaded with a 128-byte swizzle plus, for
// D = 80, one 16-column tail loaded with a 32-byte swizzle (an 80-wide row
// is 160 bytes, more than one 128-byte swizzle span). QK^T is then 4 + 1
// k-steps over two pairs of descriptors, and PV one n64 and one n16 wgmma.
// Nothing is padded in device memory.
//
// Semantics (those of the Pallas kernels): bf16 matmul inputs with f32
// accumulation; the D^-0.5 scale applied to the f32 logits; a masked logit
// gives p = 0, never exp(0); a row with no valid key gives 0. The mask is
// evaluated only on the tiles an item marks as masked: the others are known
// on the host (kernel 1) or from kv_len (kernel 2) to be valid throughout.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace socio90 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // query rows per work item (2 consumer warpgroups x 64)
constexpr int kBN = 128;         // keys per K/V tile

constexpr int kQBufs = 2;        // Q ring depth (the next item's Q loads early)
constexpr int kThreads = 384;    // 2 consumer warpgroups + 1 producer warpgroup

// Shared-memory layout for head dim D (offsets from a 1024-byte-aligned base;
// a 128-byte swizzle repeats every 1024 bytes, so every operand tile starts on
// such a boundary).
template <int D>
struct Layout {
  static constexpr int kMain = D / 64;    // 64-column chunks (128-byte swizzle)
  static constexpr int kTail = D % 64;    // 0 or 16 columns (32-byte swizzle)
  static_assert(kTail == 0 || kTail == 16, "head dim must be 64k or 64k + 16");
  static constexpr uint32_t q_chunk = kBM * 64 * 2;      // bytes of one Q chunk
  static constexpr uint32_t kv_chunk = kBN * 64 * 2;
  static constexpr uint32_t q_tail = kMain * q_chunk;    // offset of the Q tail
  static constexpr uint32_t kv_tail = kMain * kv_chunk;
  static constexpr uint32_t q_bytes = kBM * D * 2;       // TMA bytes of a Q tile
  static constexpr uint32_t kv_bytes = kBN * D * 2;      // of a K (or V) tile
  static constexpr uint32_t q_buf = (q_bytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kv_buf = (kv_bytes + 1023) / 1024 * 1024;
  static constexpr uint32_t off_k = kQBufs * q_buf;
  // K/V ring depth: three stages where they fit beside the two Q buffers
  static constexpr int kStages = kQBufs * q_buf + 6 * kv_buf <= 200 * 1024 ? 3 : 2;
  static constexpr uint32_t off_v = off_k + kStages * kv_buf;
  static constexpr uint32_t off_bar = off_v + kStages * kv_buf;
  static constexpr uint32_t n_bars = 2 * kQBufs + 3 * kStages;
  static constexpr uint32_t smem = off_bar + n_bars * 8 + 1024;   // + alignment slack
};

// Everything a launch needs, passed by value as a __grid_constant__ so the
// tensor maps live in parameter space, where TMA can read them.
struct FwdParams {
  CUtensorMap q_main, q_tail, k_main, k_tail, v_main, v_tail;
  bf16* o;
  long long sob, sot, soh;   // output strides (elements); sob unused by kernel 1
  int n_items;
  float scale_log2;          // D^-0.5 * log2(e)
  // kernel 2 (GQA prefill): q (B, Lq, H, D), k/v (B, Lk, Hkv, D)
  const int* kv_lens;        // (B,)
  int B, Lq, Lk, Hkv, rep, causal, n_ttiles;
  // kernel 1 (segmented ViT): q/k/v (S, H, D)
  const int* seg;            // (S,) segment ids
  const int* work;           // (n_items,) item -> (head << 16) | q tile
  // (n_tiles, 2) per q tile: {first row, rows, first key, k tiles} and
  // {first, last k tile known unmasked, 0, 0}
  const int4* tiles;
  int S;
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait of ~10 s (2^35
// clocks; an item takes microseconds) means a broken pipeline: trap (a
// launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 3 = 32 B).
constexpr int kSw128 = 1;
constexpr int kSw32 = 3;

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t((lbo >> 4) & 0x3FFF) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFF) << 32;
  d |= uint64_t(swizzle) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers in program order around the asynchronous wgmma
// (the compiler must not move reads or writes of them across the wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major (the reduction dim contiguous).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A (bf16 pairs) from registers, B from
// shared memory MN-major (transposed: the N dim contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 16 (the 16-column tail of D = 80).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

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
    // the last token tiles (the most keys under a causal mask) come first,
    // so the round-robin over persistent CTAs ends on light items; within a
    // token tile the (batch row, kv head) order rotates from one token tile
    // to the next, so that a CTA, which takes every gridDim.x-th item, does
    // not meet the same batch row (and its kv_len) in all its items
    const int bg_n = p.B * p.Hkv;
    const int row = item / bg_n;
    const int tt = p.n_ttiles - 1 - row;
    const int bg = (item + row) % bg_n;
    const int toks = kBM / p.rep;
    it.b = bg / p.Hkv;
    it.head = bg % p.Hkv;
    it.t0 = tt * toks;
    it.rows = kBM;
    it.k0 = 0;
    it.kv_len = min(max(p.kv_lens[it.b], 0), p.Lk);
    const int2 n = prefill_k_tiles(it.t0, toks, it.kv_len, p.Lq, p.Lk, p.causal);
    it.lo = 0;
    it.hi = n.x - 1;
    it.nm_lo = 0;
    it.nm_hi = n.y - 1;
  }
  return it;
}

// ------------------------------------------------------------- producer

template <int D, bool kSeg>
__device__ __forceinline__ void producer(const FwdParams& p, uint32_t base) {
  using L = Layout<D>;
  const uint32_t bars = base + L::off_bar;
  int qs = 0, ks = 0;
  uint32_t qph = 0, kph = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = resolve<kSeg>(p, item);
    const uint32_t q_full = bars + 8 * qs, q_empty = bars + 8 * (kQBufs + qs);
    mbar_wait(q_empty, qph ^ 1);
    mbar_expect_tx(q_full, L::q_bytes);
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
    for (int j = it.lo; j <= it.hi; ++j) {
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
        if constexpr (kSeg) tma_load_3d(kb + off, map, k_full, 64 * c, it.head, it.k0 + j * kBN);
        else tma_load_4d(kb + off, map, k_full, 64 * c, it.head, j * kBN, it.b);
      }
      mbar_expect_tx(v_full, L::kv_bytes);
#pragma unroll
      for (int c = 0; c <= L::kMain; ++c) {
        if (c == L::kMain && L::kTail == 0) break;
        const uint32_t off = c < L::kMain ? c * L::kv_chunk : L::kv_tail;
        const CUtensorMap* map = c < L::kMain ? &p.v_main : &p.v_tail;
        if constexpr (kSeg) tma_load_3d(vb + off, map, v_full, 64 * c, it.head, it.k0 + j * kBN);
        else tma_load_4d(vb + off, map, v_full, 64 * c, it.head, j * kBN, it.b);
      }
      if (++ks == L::kStages) { ks = 0; kph ^= 1; }
    }
  }
}

// ------------------------------------------------------------- consumer

// Keep registers that an in-flight wgmma reads (its A fragments) alive, and
// in program order, up to this point.
template <int N>
__device__ __forceinline__ void reg_keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// One consumer warpgroup's 64 rows; the two consumer warpgroups of a CTA
// overlap each other's products and softmax.
template <int D, bool kSeg>
__device__ __forceinline__ void consumer(const FwdParams& p, uint32_t base, int wg) {
  using L = Layout<D>;
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
    float s[kBN / 2];
    uint32_t pa[kBN / 16][4];

    const uint32_t q_empty = bars + 8 * (kQBufs + qs);
    const uint32_t qb = base + qs * L::q_buf;
    auto k_full = [&](int st) { return bars + 8 * (2 * kQBufs + st); };
    auto v_full = [&](int st) { return bars + 8 * (2 * kQBufs + L::kStages + st); };
    auto kv_empty = [&](int st) { return bars + 8 * (2 * kQBufs + 2 * L::kStages + st); };

    // S = Q K^T over the head dim (4 k-steps per 64-column chunk, then the
    // tail), issued and committed as one group
    auto issue_s = [&](int st) {
      const uint32_t kb = base + L::off_k + st * L::kv_buf;
      wg_fence();
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(s,
                       make_desc(qb + c * L::q_chunk + wg * 8192 + kk * 32, 16, 1024, kSw128),
                       make_desc(kb + c * L::kv_chunk + kk * 32, 16, 1024, kSw128),
                       (c | kk) != 0);
      if constexpr (L::kTail != 0)
        wgmma_ss_n128(s, make_desc(qb + L::q_tail + wg * 2048, 16, 256, kSw32),
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
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs_n64(o[c], pa[kk],
                       make_desc(vb + c * L::kv_chunk + kk * 2048, L::kv_chunk, 1024, kSw128));
      if constexpr (L::kTail != 0) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs_n16(ot, pa[kk], make_desc(vb + L::kv_tail + kk * 512, 512, 256, kSw32));
      }
      wg_commit();
    };
    // mask tile j (only outside the item's known-valid range), then the
    // online-softmax update of m and l; s becomes p, corr the factor that
    // O has to be scaled by
    auto softmax = [&](int j) {
      if (j < it.nm_lo || j > it.nm_hi) {
#pragma unroll
        for (int g = 0; g < kBN / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = it.k0 + j * kBN + 8 * g + cq + e;
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
      // a row's 64 columns sit in the 4 threads of a quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int g = 0; g < kBN / 8; ++g) mx = fmaxf(mx, fmaxf(s[4 * g + 2 * i], s[4 * g + 2 * i + 1]));
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
        for (int g = 0; g < kBN / 8; ++g) {
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
    // P in bf16 as the A fragments of four k16 steps (keys 16kk..16kk+15):
    // the accumulator layout of S is the A-operand layout of PV
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
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
      for (int j = it.lo; j <= it.hi; ++j) {
        mbar_wait(k_full(ks), kph);
        issue_s(ks);
        wg_wait0();
        reg_fence(s);
        if (j == it.hi) release_q();    // the item's last use of Q
        softmax(j);
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
        if (t < p.Lq)
          dst = p.o + it.b * p.sob + t * p.sot + (it.head * p.rep + r % p.rep) * p.soh;
      }
      if (dst == nullptr) continue;
#pragma unroll
      for (int c = 0; c < kM; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * g + cq) =
              pack_bf16(o[c][4 * g + 2 * i] * inv, o[c][4 * g + 2 * i + 1] * inv);
      if constexpr (L::kTail != 0) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
          *reinterpret_cast<uint32_t*>(dst + 64 * kM + 8 * g + cq) =
              pack_bf16(ot[4 * g + 2 * i] * inv, ot[4 * g + 2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1) attention_sm90_kernel(const __grid_constant__ FwdParams p) {
  using L = Layout<D>;
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
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) producer<D, kSeg>(p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer<D, kSeg>(p, base, wg);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched once through the
// runtime, so the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

constexpr int kErrEncode = 1000;   // + CUresult: a tensor map the driver refused

// A bf16 tensor map of `rank` dims (innermost first; strides in elements for
// dims 1..rank-1) with a box of `box` elements, 128- or 32-byte swizzle.
// Out-of-range elements of a box are filled with zeros.
inline int encode_map(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
                      const long long* strides, const int* box, bool swizzle128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrEncode;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = static_cast<cuuint64_t>(strides[i]) * 2;
  }
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
                  gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// The main-chunk (64 columns) and, for D % 64 == 16, the tail map of one
// tensor; `box` is the box with its innermost extent left to fill.
inline int encode_pair(CUtensorMap* main_map, CUtensorMap* tail_map, const void* ptr, int rank,
                       const long long* dims, const long long* strides, int* box, int D) {
  box[0] = 64;
  int rc = encode_map(main_map, ptr, rank, dims, strides, box, true);
  if (rc == 0 && D % 64 != 0) {
    box[0] = D % 64;
    rc = encode_map(tail_map, ptr, rank, dims, strides, box, false);
  }
  return rc;
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// One persistent CTA per SM (at most one per item).
template <int D, bool kSeg>
int launch(const FwdParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(attention_sm90_kernel<D, kSeg>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Layout<D>::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (p.n_items <= 0) return 0;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  attention_sm90_kernel<D, kSeg><<<grid, kThreads, Layout<D>::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace socio90
