// In-place K/V row write into the stacked decode cache at one layer.
//
// Replaces the Pallas kernel scripts/profile_decode2.py `_writer` (reached
// through `write_rows`): for every slot s, the new row knew[s, 0] (Hkv x D
// bf16) goes to k[layer, s, positions[s]], and vnew[s, 0] to v likewise;
// nothing else of the caches changes. The TPU kernel issues one DMA per slot
// and per cache; a position outside [0, Lalloc) would fault there. Here such
// a slot writes nothing: the kernel never stores outside the cache.
//
// What bounds it on the H100: the fixed cost of a launch. One call moves S x
// 2 rows of Hkv x D x 2 bytes (24 slots x 2 x 512 B = 24 KB at the script's
// shape), ~0.015 us of HBM time against ~1.25 us a graph node of an (S, 2)
// grid of small CTAs. The design attacks that cost:
//   - a grid of 64-thread CTAs, a 16-byte vector a thread (a warp a row of
//     512 bytes), so that a call's 48 KB pass through many SMs (on an H100
//     one CTA a call, a warp a row or a thread a row through bulk copies,
//     took twice as long);
//   - a row's source is read while its slot's position is: one memory round
//     trip before the store;
//   - programmatic dependent launch (PDL): the kernel is launched with
//     cudaLaunchAttributeProgrammaticStreamSerialization, issues
//     griddepcontrol.launch_dependents at its start, so that the next launch
//     and its CTA set-up may overlap this one, and waits (griddepcontrol.wait)
//     for the kernel before it to finish and flush before it reads positions,
//     knew or vnew or stores anything: the previous kernel may produce them.
// The host passes the layer's view, so the stacked cache is never copied.
//
// socio_noop is the floor beside it: one CTA, no work, the same launch.
#include <cuda_runtime.h>

namespace socio {

constexpr int kThreads = 64;   // on an H100 0.92x the time of 32 and 0.96x that of 256

struct RowWriteArgs {
  uint4 *k, *v;                 // the caches at the layer: (S, Lalloc, row) views
  const uint4 *knew, *vnew;     // (S, 1, row)
  const int* positions;         // (S,)
  int S, Lalloc, row_vecs;      // row length in 16-byte vectors
  // strides in 16-byte vectors
  long long k_slot, k_tok, v_slot, v_tok, knew_slot, vnew_slot;
};

__device__ __forceinline__ void pdl_start() {
  // let the stream's next kernel launch now; it waits for this one itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // nothing the previous kernel wrote is read, and nothing stored, before it is done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Thread t of the launch moves vector t of the call's 2S rows laid end to
// end: the k rows of slots 0..S-1, then their v rows.
__global__ void __launch_bounds__(kThreads) write_rows_kernel(RowWriteArgs a) {
  pdl_start();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 2 * a.S * a.row_vecs) return;
  const int r = t / a.row_vecs, i = t - r * a.row_vecs;
  const bool is_v = r >= a.S;
  const int s = is_v ? r - a.S : r;
  // the source's load goes out before the position is known
  const uint4 val = is_v ? a.vnew[s * a.vnew_slot + i] : a.knew[s * a.knew_slot + i];
  const int pos = a.positions[s];
  if (pos < 0 || pos >= a.Lalloc) return;
  if (is_v)
    a.v[s * a.v_slot + pos * a.v_tok + i] = val;
  else
    a.k[s * a.k_slot + pos * a.k_tok + i] = val;
}

__global__ void noop_kernel() { pdl_start(); }

// A launch of `blocks` CTAs with or without PDL; the error of the launch itself.
template <typename... Args>
int launch(void (*kernel)(Args...), int blocks, int threads, bool pdl, cudaStream_t stream,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace socio

// Strides are in bf16 elements; every one must be a multiple of 8 (16 bytes)
// and the rows (Hkv x D) contiguous, which the wrapper checks. Always
// launched with PDL.
extern "C" int socio_write_rows_bf16(
    void* k, void* v, const void* knew, const void* vnew, const void* positions,
    int S, int Lalloc, int row_elems,
    long long sks, long long skt, long long svs, long long svt,
    long long sns, long long svns, void* stream) {
  using namespace socio;
  if (S <= 0 || Lalloc <= 0 || row_elems <= 0 || row_elems % 8 ||
      (sks | skt | svs | svt | sns | svns) % 8)
    return (int)cudaErrorInvalidValue;
  RowWriteArgs a{static_cast<uint4*>(k), static_cast<uint4*>(v),
                 static_cast<const uint4*>(knew), static_cast<const uint4*>(vnew),
                 static_cast<const int*>(positions), S, Lalloc, row_elems / 8,
                 sks / 8, skt / 8, svs / 8, svt / 8, sns / 8, svns / 8};
  const long long vecs = 2LL * S * (row_elems / 8);
  return launch(write_rows_kernel, (int)((vecs + kThreads - 1) / kThreads), kThreads, true,
                static_cast<cudaStream_t>(stream), a);
}

// One CTA of one thread and no work, with (pdl != 0) or without PDL: the
// least a launch of any per-layer kernel costs on this card.
extern "C" int socio_noop(int pdl, void* stream) {
  return socio::launch(socio::noop_kernel, 1, 1, pdl != 0, static_cast<cudaStream_t>(stream));
}
