// In-place K/V row write into the stacked decode cache at one layer.
//
// Replaces the Pallas kernel scripts/profile_decode2.py `_writer` (reached
// through `write_rows`): for every slot s, the new row knew[s, 0] (Hkv x D
// bf16) goes to k[layer, s, positions[s]], and vnew[s, 0] to v likewise;
// nothing else of the caches changes. The TPU kernel issues one DMA per slot
// and per cache; a position outside [0, Lalloc) would fault there. Here such
// a slot writes nothing: the kernel never stores outside the cache.
//
// What bounds it on the H100: launch latency. One call moves S x 2 rows of
// Hkv x D x 2 bytes (24 slots x 2 x 512 B = 24 KB at the script's shape),
// microseconds of HBM time. The design is one CTA per (slot, cache) with a
// 16-byte load and store per thread, so one launch covers all slots and
// both caches of a layer; the host passes the layer's view, so the stacked
// cache is never copied.
#include <cuda_runtime.h>
#include <stdint.h>

namespace socio {

constexpr int kRowThreads = 64;

struct RowWriteArgs {
  uint4* dst[2];              // k, v at the layer: (S, Lalloc, row) views
  const uint4* src[2];        // knew, vnew: (S, 1, row)
  const int* positions;       // (S,)
  int Lalloc, row_vecs;       // row length in 16-byte vectors
  long long dst_slot[2], dst_tok[2], src_slot[2];   // strides in 16-byte vectors
};

__global__ void __launch_bounds__(kRowThreads) write_rows_kernel(RowWriteArgs a) {
  const int s = blockIdx.x;
  const int which = blockIdx.y;   // 0: k, 1: v
  const int pos = a.positions[s];
  if (pos < 0 || pos >= a.Lalloc) return;
  uint4* dst = a.dst[which] + s * a.dst_slot[which] + pos * a.dst_tok[which];
  const uint4* src = a.src[which] + s * a.src_slot[which];
  for (int i = threadIdx.x; i < a.row_vecs; i += kRowThreads) dst[i] = src[i];
}

}  // namespace socio

// Strides are in bf16 elements; every one must be a multiple of 8 (16 bytes)
// and the rows (Hkv x D) contiguous, which the wrapper checks.
extern "C" int socio_write_rows_bf16(
    void* k, void* v, const void* knew, const void* vnew, const void* positions,
    int S, int Lalloc, int row_elems,
    long long sks, long long skt, long long svs, long long svt,
    long long sns, long long svns, void* stream) {
  using namespace socio;
  if (S <= 0 || Lalloc <= 0 || row_elems <= 0 || row_elems % 8 ||
      (sks | skt | svs | svt | sns | svns) % 8)
    return (int)cudaErrorInvalidValue;
  RowWriteArgs a{{static_cast<uint4*>(k), static_cast<uint4*>(v)},
                 {static_cast<const uint4*>(knew), static_cast<const uint4*>(vnew)},
                 static_cast<const int*>(positions), Lalloc, row_elems / 8,
                 {sks / 8, svs / 8}, {skt / 8, svt / 8}, {sns / 8, svns / 8}};
  write_rows_kernel<<<dim3(S, 2), kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
