// WMMA tile helpers of the training dq kernel (flash_train_bwd.cu): a CTA of
// 4 warps owns a 64-row query tile and walks 64-key tiles of K/V through
// shared memory; S = Q K^T and the products that follow run on the tensor
// cores with bf16 WMMA (f32 accumulation) from shared memory.
//
// Each warp owns 16 of the 64 query rows for the whole kernel, so within a
// key tile the warps only meet at the K/V loads (__syncthreads) and
// otherwise synchronise with __syncwarp.
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

// O[warp rows] += P[warp rows] @ V, accumulating on the tensor cores straight
// into an f32 tile in shared memory (dq += dS K in the dq kernel).
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

}  // namespace socio
