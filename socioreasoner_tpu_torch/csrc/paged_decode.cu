// Decode attention over the slot KV cache: one query token per slot.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/decode_attention.py
// `_decode_kernel`, both branches (reached through `paged_decode_attention`):
// the bf16 cache (kernel 3) and the int8 cache with f32 per-token, per-kv-head
// scales stored transposed as (S, Hkv, Lalloc) (kernel 3q, quantized=True).
// Semantics kept: q (S, H, D) against slot s's cache prefix lengths[s]; GQA
// inside the kernel; the block loop clamped to [1, Lalloc / kBlock] blocks; a
// masked key gets p = 0; zero length gives 0; q is scaled by D^-0.5 in f32
// and both products run in f32; the output is in q's dtype (bf16).
//
// What bounds it on the H100: bytes. Per layer it reads len x Hkv x D x 2
// bytes of K and V per slot (bf16: 2 bytes an element; int8: 1, plus 8 bytes
// of scales per row) and does ~2 FLOPs per byte per q head, far below the
// card's ~295 FLOP/byte balance point. The design reads only the
// ceil(len / kBlock) blocks a slot needs (never the whole allocated cache),
// reads each K/V row once for the rep q heads that share it, stages K/V
// blocks through shared memory with 16-byte loads, and indexes the stacked
// (layers, S, Lalloc, Hkv, D) cache through a layer view without a copy.
// One (slot, kv head) has too little work for the card (4-8 slots x 2 kv
// heads is 8-16 CTAs on 132 SMs), so the blocks of each slot are split over
// n_split CTAs (flash-decoding): each writes an unnormalised partial (m, l,
// acc) and a second small kernel merges the partials of a (slot, q head).
//
// The int8 branch dequantises inside the kernel and folds the scales into
// the products instead of scaling every element: a logit is (q . k_int) x
// ks[key], and the value row is v_int x vs[key] as it is accumulated into
// p x v. The 64 scales of one (slot, kv head, block) are contiguous in the
// transposed layout and are staged with the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace socio {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;          // cache rows per block
constexpr int kDecThreads = 128;    // == head dim: thread d owns output dim d
constexpr int kMaxRep = 16;         // q heads per kv head
constexpr float kDecNegInf = -1e30f;

struct DecodeArgs {
  const bf16* q;        // (S, H, D)
  const void* k;        // (S, Lalloc, Hkv, D) view of one layer, bf16 or int8
  const void* v;
  const float* ks;      // int8 only: (S, Hkv, Lalloc) view of one layer
  const float* vs;
  float* part_acc;      // (n_split, S, H, D) unnormalised partial outputs
  float* part_ml;       // (n_split, S, H, 2) partial row max and row sum
  const int* lengths;   // (S,)
  int S, Hkv, rep, Lalloc;
  long long sqs, sqh, sks, skt, skh, svs, svt, svh;
  long long skss, sksh, svss, svsh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads) paged_decode_kernel(DecodeArgs a) {
  static_assert(D == kDecThreads, "one thread per head dim");
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // +4 bytes per K row: a warp reading 32 different rows at the same column
  // then hits 32 different banks (bf16: 65 words a row, int8: 33)
  constexpr int kRowBytes = D * (int)sizeof(T) + 4;
  __shared__ __align__(16) unsigned char k_s[kBlock * kRowBytes];
  __shared__ __align__(16) T v_s[kBlock][D];
  __shared__ float ks_s[kBlock], vs_s[kBlock];   // int8 only
  __shared__ float q_s[kMaxRep][D];
  __shared__ float p_s[kMaxRep][kBlock];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], c_s[kMaxRep];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x;          // kv head
  const int s = blockIdx.y;          // slot
  const int split = blockIdx.z;
  const int rep = a.rep;
  const int len = a.lengths[s];
  // at least one block (a zero-length slot masks every column -> 0), and
  // never past the allocated cache, whatever the length says
  const int nblocks = min(max((len + kBlock - 1) / kBlock, 1), a.Lalloc / kBlock);
  const int chunk = (nblocks + gridDim.z - 1) / gridDim.z;
  const int j_lo = split * chunk;
  const int j_hi = min(nblocks, j_lo + chunk);   // may be empty: partial stays (-inf, 0, 0)

  for (int i = tid; i < rep * D; i += kDecThreads) {
    const int h = i / D, d = i % D;
    q_s[h][d] = __bfloat162float(a.q[s * a.sqs + (g * rep + h) * a.sqh + d]) * a.scale;
  }
  if (tid < rep) {
    m_s[tid] = kDecNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int h = 0; h < kMaxRep; ++h) acc[h] = 0.f;
  __syncthreads();

  const T* kbase = static_cast<const T*>(a.k) + s * a.sks + g * a.skh;
  const T* vbase = static_cast<const T*>(a.v) + s * a.svs + g * a.svh;
  for (int j = j_lo; j < j_hi; ++j) {
    const int key0 = j * kBlock;
    constexpr int kVec = D * (int)sizeof(T) / 16;     // 16-byte vectors per row
    // unrolled: every thread issues all its loads before the first store
#pragma unroll
    for (int it = 0; it < kBlock * kVec / kDecThreads; ++it) {
      const int i = tid + it * kDecThreads;
      const int r = i / kVec, c = i % kVec;
      const int key = key0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < len) {
        kv = reinterpret_cast<const uint4*>(kbase + key * a.skt)[c];
        vv = reinterpret_cast<const uint4*>(vbase + key * a.svt)[c];
      }
      // the padded K row is only 4-byte aligned: store it as four words
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + r * kRowBytes + c * 16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      reinterpret_cast<uint4*>(&v_s[r][0])[c] = vv;
    }
    if constexpr (kQuant) {
      if (tid < kBlock) {
        const int key = key0 + tid;
        const bool ok = key < len;
        ks_s[tid] = ok ? a.ks[s * a.skss + g * a.sksh + key] : 0.f;
        vs_s[tid] = ok ? a.vs[s * a.svss + g * a.svsh + key] : 0.f;
      }
    }
    __syncthreads();

    // logits: thread -> key c = tid % 64 and heads hg, hg + 2, ...
    {
      const int c = tid % kBlock;
      const int hg = tid / kBlock;
      float sc[kMaxRep / 2];
#pragma unroll
      for (int hh = 0; hh < kMaxRep / 2; ++hh) sc[hh] = 0.f;
      if constexpr (kQuant) {
        const char4* krow = reinterpret_cast<const char4*>(k_s + c * kRowBytes);
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const char4 kc = krow[d4];
          const float k0 = kc.x, k1 = kc.y, k2 = kc.z, k3 = kc.w;
#pragma unroll
          for (int hh = 0; hh < kMaxRep / 2; ++hh) {
            const int h = hg + 2 * hh;
            if (h < rep) {
              const float* qh = &q_s[h][4 * d4];
              sc[hh] += qh[0] * k0 + qh[1] * k1 + qh[2] * k2 + qh[3] * k3;
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < kMaxRep / 2; ++hh) sc[hh] *= ks_s[c];
      } else {
        const __nv_bfloat162* krow =
            reinterpret_cast<const __nv_bfloat162*>(k_s + c * kRowBytes);
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kf = __bfloat1622float2(krow[d2]);
#pragma unroll
          for (int hh = 0; hh < kMaxRep / 2; ++hh) {
            const int h = hg + 2 * hh;
            if (h < rep) sc[hh] += q_s[h][2 * d2] * kf.x + q_s[h][2 * d2 + 1] * kf.y;
          }
        }
      }
      const bool valid = key0 + c < len;
#pragma unroll
      for (int hh = 0; hh < kMaxRep / 2; ++hh) {
        const int h = hg + 2 * hh;
        if (h < rep) p_s[h][c] = valid ? sc[hh] : kDecNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns heads w, w + 4, ...; lane owns keys lane, lane + 32
    for (int h = warp; h < rep; h += kDecThreads / 32) {
      const float s0 = p_s[h][lane], s1 = p_s[h][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 > 0.5f * kDecNegInf ? __expf(s0 - m_new) : 0.f;
      const float p1 = s1 > 0.5f * kDecNegInf ? __expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[h][lane] = p0;
      p_s[h][lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * corr + sum;
        c_s[h] = corr;
      }
    }
    __syncthreads();

    // acc[h] (dim tid) = acc[h] * corr[h] + sum_c p[h][c] * v[c][tid]
#pragma unroll
    for (int h = 0; h < kMaxRep; ++h)
      if (h < rep) acc[h] *= c_s[h];
    for (int c = 0; c < kBlock; ++c) {
      float vf;
      if constexpr (kQuant) {
        vf = (float)v_s[c][tid] * vs_s[c];
      } else {
        vf = __bfloat162float(v_s[c][tid]);
      }
#pragma unroll
      for (int h = 0; h < kMaxRep; ++h)
        if (h < rep) acc[h] += p_s[h][c] * vf;
    }
    __syncthreads();
  }

  const long long row0 = ((long long)split * a.S + s) * (a.rep * a.Hkv) + g * rep;
#pragma unroll
  for (int h = 0; h < kMaxRep; ++h)
    if (h < rep) a.part_acc[(row0 + h) * D + tid] = acc[h];
  if (tid < rep) {
    a.part_ml[(row0 + tid) * 2] = m_s[tid];
    a.part_ml[(row0 + tid) * 2 + 1] = l_s[tid];
  }
}

// out[s, h] = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i over the
// n_split partials of one (slot, q head); 0 where nothing was valid.
template <int D>
__global__ void __launch_bounds__(D) paged_decode_merge_kernel(
    const float* part_acc, const float* part_ml, bf16* o, int n_split, int S, int H,
    long long sos, long long soh) {
  const int row = blockIdx.x;         // s * H + h
  const int s = row / H, h = row % H;
  const long long stride = (long long)S * H;
  float M = kDecNegInf;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, part_ml[(i * stride + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = __expf(part_ml[(i * stride + row) * 2] - M);
    den += w * part_ml[(i * stride + row) * 2 + 1];
    num += w * part_acc[(i * stride + row) * D + threadIdx.x];
  }
  o[s * sos + h * soh + threadIdx.x] = __float2bfloat16(den == 0.f ? 0.f : num / den);
}

template <typename T>
int launch_paged_decode(const DecodeArgs& a, bf16* o, int H, int n_split,
                        long long sos, long long soh, cudaStream_t st) {
  paged_decode_kernel<T, kDecThreads><<<dim3(a.Hkv, a.S, n_split), kDecThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<kDecThreads><<<a.S * H, kDecThreads, 0, st>>>(
      a.part_acc, a.part_ml, o, n_split, a.S, H, sos, soh);
  return (int)cudaGetLastError();
}

inline bool bad_shape(int H, int Hkv, int D, int Lalloc, int n_split) {
  return D != kDecThreads || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRep ||
         Lalloc % kBlock != 0 || Lalloc <= 0 || n_split < 1;
}

}  // namespace socio

extern "C" int socio_paged_decode_bf16(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    void* part_acc, void* part_ml, int S, int H, int Hkv, int D, int Lalloc, int n_split,
    long long sqs, long long sqh,
    long long sks, long long skt, long long skh,
    long long svs, long long svt, long long svh,
    long long sos, long long soh, float scale, void* stream) {
  using namespace socio;
  if (bad_shape(H, Hkv, D, Lalloc, n_split)) return (int)cudaErrorInvalidValue;
  DecodeArgs a{static_cast<const bf16*>(q), k, v, nullptr, nullptr,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<const int*>(lengths), S, Hkv, H / Hkv, Lalloc,
               sqs, sqh, sks, skt, skh, svs, svt, svh, 0, 0, 0, 0, scale};
  return launch_paged_decode<bf16>(a, static_cast<bf16*>(o), H, n_split, sos, soh,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int socio_paged_decode_int8(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* o, const void* lengths, void* part_acc, void* part_ml,
    int S, int H, int Hkv, int D, int Lalloc, int n_split,
    long long sqs, long long sqh,
    long long sks, long long skt, long long skh,
    long long svs, long long svt, long long svh,
    long long skss, long long sksh, long long svss, long long svsh,
    long long sos, long long soh, float scale, void* stream) {
  using namespace socio;
  if (bad_shape(H, Hkv, D, Lalloc, n_split)) return (int)cudaErrorInvalidValue;
  DecodeArgs a{static_cast<const bf16*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<const int*>(lengths),
               S, Hkv, H / Hkv, Lalloc, sqs, sqh, sks, skt, skh, svs, svt, svh,
               skss, sksh, svss, svsh, scale};
  return launch_paged_decode<int8_t>(a, static_cast<bf16*>(o), H, n_split, sos, soh,
                                     static_cast<cudaStream_t>(stream));
}
