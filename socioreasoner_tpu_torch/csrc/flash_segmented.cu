// Segment-id attention over a packed ViT sequence.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention.py
// `_seg_kernel` (reached through `flash_attention_segmented`). Semantics kept:
// q, k, v (S, H, D), non-causal; query i sees key j iff seg[i] == seg[j];
// the D^-0.5 scale on the f32 logits; bf16 matmul inputs with f32
// accumulation; rows with no valid key give 0.
//
// What bounds it on the H100: the ViT's four full-attention layers. At two
// 756x756 images (S = 5832, 16 heads, D = 80) each is ~87 GFLOP of
// block-diagonal work, while one head's K/V is under 1 MiB and stays in L2;
// the 28 window layers (64-patch windows) are small. So it is tensor-core
// work that must skip what the mask removes: the CTA visits only the k tiles
// in [kstart[i], kend[i]] that the wrapper derives from the (nondecreasing)
// segment ids -- the same bound the Pallas kernel gets through scalar
// prefetch -- and runs both products on the tensor cores with bf16 WMMA.
// D = 80 is five 16-wide WMMA steps, so it needs no padding. For arbitrary
// ids the wrapper passes the full range and the mask alone decides.
#include "attention_tile.cuh"

namespace socio {

struct SegArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* seg;     // (S,)
  const int* kstart;  // (ceil(S / kRows),) first k tile of each q tile
  const int* kend;    // last k tile (inclusive)
  int S;
  long long sqt, sqh, skt, skh, svt, svh, sot, soh;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_segmented_kernel(SegArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = TileSmem<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);
  int* segq = reinterpret_cast<int*>(smem + L::segq);
  int* segk = reinterpret_cast<int*>(smem + L::segk);

  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int iq = blockIdx.x;
  const int t0 = iq * kRows;

  load_rows<D>(Qs, [&](int r) -> const bf16* {
    const int t = t0 + r;
    return t < a.S ? a.q + t * a.sqt + h * a.sqh : nullptr;
  });
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int t = t0 + r;
    segq[r] = t < a.S ? a.seg[t] : -1;   // padding sentinels -1 / -2 never match
  }
  init_state<D>(Os, m_s, l_s);
  const int j_lo = a.kstart[iq];
  const int j_hi = a.kend[iq];
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int key0 = j * kCols;
    load_rows<D>(Ks, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < a.S ? a.k + key * a.skt + h * a.skh : nullptr;
    });
    load_rows<D>(Vs, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < a.S ? a.v + key * a.svt + h * a.svh : nullptr;
    });
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      const int key = key0 + c;
      segk[c] = key < a.S ? a.seg[key] : -2;
    }
    __syncthreads();
    scores_tile<D>(Qs, Ks, Ss, warp);
    __syncwarp();
    softmax_tile<D>(Ss, Ps, Os, m_s, l_s, warp, a.scale, [&](int r, int c) {
      return t0 + r < a.S && key0 + c < a.S && segq[r] == segk[c];
    });
    __syncwarp();
    pv_tile<D>(Ps, Vs, Os, warp);
    __syncthreads();
  }
  __syncthreads();
  write_rows<D>(Os, l_s, [&](int r) -> bf16* {
    const int t = t0 + r;
    return t < a.S ? a.o + t * a.sot + h * a.soh : nullptr;
  });
}

template <int D>
static int launch_segmented(const SegArgs& a, int H, cudaStream_t stream) {
  const size_t smem = TileSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_segmented_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + kRows - 1) / kRows, H);
  flash_segmented_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace socio

extern "C" int socio_flash_segmented_bf16(
    const void* q, const void* k, const void* v, void* o, const void* seg,
    const void* kstart, const void* kend, int S, int H, int D,
    long long sqt, long long sqh, long long skt, long long skh,
    long long svt, long long svh, long long sot, long long soh,
    float scale, void* stream) {
  using namespace socio;
  SegArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o),
            static_cast<const int*>(seg), static_cast<const int*>(kstart),
            static_cast<const int*>(kend), S,
            sqt, sqh, skt, skh, svt, svh, sot, soh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return launch_segmented<80>(a, H, s);
    case 128: return launch_segmented<128>(a, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
