// PTX helpers and host-side tensor-map encoding shared by the Hopper kernels:
// the forward-attention CTA (attention_sm90.cuh: kernels 1, 2 and 4), the
// training dq kernel (flash_train_dq_sm90.cu: kernel 5) and the training
// dk/dv kernel (flash_train_dkv_sm90.cu: kernel 6).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace socio90 {

using bf16 = __nv_bfloat16;

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

// A 4-byte asynchronous copy global -> shared that reads `src_bytes` (4 or 0)
// and zero-fills the rest; cp_async_arrive_noinc then makes mbarrier `bar`
// count one arrival of this thread once all its earlier cp.async copies have
// landed (the barrier's expected count includes it).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Zero `bytes` (a multiple of 16) of shared memory from `addr`, spread over
// the CTA's threads. A wgmma reading them afterwards needs
// fence.proxy.async.shared::cta and a barrier between.
__device__ __forceinline__ void zero_smem(uint32_t addr, int bytes) {
  for (int o = 16 * threadIdx.x; o < bytes; o += 16 * blockDim.x)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr + o), "r"(0) : "memory");
}

// Barrier `id` (1..15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pin accumulator registers in program order around the asynchronous wgmma
// (the compiler must not move reads or writes of them across the wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Keep registers that an in-flight wgmma reads (its A fragments) alive, and
// in program order, up to this point.
template <int N>
__device__ __forceinline__ void reg_keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
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

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, both
// K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
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

// The main-chunk (64 columns) and, for an instance of 64k + 16 columns, the
// tail map of one tensor; `box` is the box with its innermost extent left
// to fill. dims[0] is the tensor's own head dim d (a multiple of 8, at most
// `inst`): the boxes cover the instance's `inst` columns, and TMA fills the
// columns past d with zeros (and still counts their bytes on the barrier).
inline int encode_pair(CUtensorMap* main_map, CUtensorMap* tail_map, const void* ptr, int rank,
                       const long long* dims, const long long* strides, int* box, int inst) {
  box[0] = 64;
  int rc = encode_map(main_map, ptr, rank, dims, strides, box, true);
  if (rc == 0 && inst % 64 != 0) {
    box[0] = inst % 64;
    rc = encode_map(tail_map, ptr, rank, dims, strides, box, false);
  }
  return rc;
}

// The head-dim instances each kernel is compiled for (the columns of its
// tiles): kernels 2 and 4 (launch_gqa) 64, 80, 128 and 256; kernel 1 80, 128
// and 256; kernels 5 and 6 64, 128 and 256. A head dim d that is a multiple
// of 8 (a row of 16-byte units, which a tensor map's stride needs) and at
// most 256 runs on the smallest instance of at least d columns, its tail
// zero-filled by TMA and never stored; the host pads any other d to the next
// multiple of 8 first (ops/flash_attention.py head_dim_plan, held to this
// formula by socio_head_dim_instance and socio_head_dim_slices). Returns 0
// where d is no such width. Above 256 the f32 accumulators of a 64-row tile
// (a 64 x 512 O is 256 registers a thread) no longer fit a thread, so d runs
// on the 256 instance's accumulators in head_dim_slices(d) = ceil(d / 256)
// column slices: a slice's CTA (or work item) computes S = Q K^T (and dP =
// dO V^T) over all d columns, streamed in 64-column chunks, and keeps only
// its own 256 columns of O, dQ, dK or dV, so no slice needs another's result.
constexpr int kSliceCols = 256;
constexpr int kGqaDims[4] = {64, 80, 128, 256};
constexpr int kSegDims[3] = {80, 128, 256};
constexpr int kBwdDims[3] = {64, 128, 256};
static_assert(kGqaDims[3] == kSliceCols && kSegDims[2] == kSliceCols &&
                  kBwdDims[2] == kSliceCols,
              "the widest instance takes the column slices");

template <int N>
inline int head_dim_instance(const int (&dims)[N], int d) {
  if (d <= 0 || d % 8 != 0) return 0;
  for (int i = 0; i < N; ++i)
    if (d <= dims[i]) return dims[i];
  return dims[N - 1];
}

// The column slices head dim d (a multiple of 8) runs in: 1 up to 256.
inline int head_dim_slices(int d) { return d <= kSliceCols ? 1 : (d + kSliceCols - 1) / kSliceCols; }

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace socio90
