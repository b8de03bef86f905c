// Single-token GQA decode attention for Hopper (sm_90a), over a dense
// per-row KV cache or a paged block pool.  Two entry points, one kernel.
//
// Replaces the TPU kernels
//   src/repro/kernels/decode_attention/kernel.py:67 decode_attention_pallas
//     (pallas_call at :106, body _kernel at :29-64), and
//   src/repro/kernels/decode_attention/kernel.py:125
//     paged_decode_attention_pallas (pallas_call at :173, body _paged_kernel
//     at :115-122, which shares _kernel's online softmax).
// The TPU versions walk a sequential grid axis over KV blocks with the
// online-softmax state in VMEM scratch and skip blocks past kv_len with
// pl.when; the paged one steers each block's BlockSpec through the
// scalar-prefetched block table.  Blocks on this card run in no order, so
// the walk over the cache is a loop inside one thread block instead, and a
// position's row address is computed per position:
//   dense  (b*S + j) * KVH*hd                        k, v (B, S, KVH, hd)
//   paged  (tbl[b][j / BS]*BS + j % BS) * KVH*hd      pools (P, BS, KVH, hd)
// The paged block reads its row's block table into shared memory once;
// everything else (online softmax, lane groups, shuffles, merge) is the
// same code, so with NB*BS == S and identity tables the paged kernel does
// the dense kernel's arithmetic in the same order and its output equals
// the dense kernel's bit for bit.
//
//   q      (B, H, hd)        f32 or bf16
//   kv_len (B,) int32        positions >= kv_len[b] are masked
//   tables (B, NB) int32     paged only; entries >= P are sentinels, clamped
//                            to P-1 and never read (they lie past kv_len)
//   out    (B, H, hd)        q's dtype; scores, softmax and sums in f32
//
// What bounds it: memory.  A call reads 2 * sum(kv_len) * KVH * hd cache
// elements and does about 4 * H * hd flops per cached position, i.e. about
// rep flops per byte read, far below the ~295 flops/byte at which the H100
// turns compute-bound.  For qwen3-4b (KVH 8, hd 128, bf16) with 8 slots
// averaging 400 positions that is ~13 MB a layer, ~4 us at 3.35 TB/s.  The
// paged form adds the row's used table entries (4 bytes per BS positions).
//
// Design: one thread block per (b, kv_head, chunk of at most 8 of the
// group's `rep` query rows): a group of rep <= 8 heads is one block, a
// wider one (granite-34b's 48 heads over 1 KV head, mistral-large-123b's
// 12) splits over ceil(rep / 8) blocks, each keeping its rows in the same
// register arrays, so the cache rows are re-read once per chunk (from L2
// when the chunks run together).  The rows stay in registers; the block
// loops over the cache only up to kv_len[b] (the TPU kernel's block skip
// comes for free).  G lanes share one cache row, each
// reading 16 bytes of it; G is HD / (16 bytes) rounded up to a power of
// two, so that a row maps onto lanes of one warp and the shuffles stay
// inside it (hd 112, zamba2-7b's: 14 of 16 lanes in bf16, 28 of 32 in f32;
// the lanes past HD load nothing, hold zeros and store nothing, and for a
// power-of-two HD no lane idles and the arithmetic is unchanged).  The
// block's kThreads / G lane groups each run an
// online softmax over their own interleaved subset of positions, and the
// groups' (m, l, acc) states are merged once at the end, in group order,
// through shared memory.  No atomics: the reduction order depends only on
// kv_len[b], so a row's result does not depend on the rest of the batch.
// Any block size works for the paged form: every position computes its own
// address, and a page boundary is no boundary for the loop.
//
// Known limit: the grid is B * KVH * ceil(rep / 8) blocks (64 at 8 slots of
// qwen3-4b), which leaves most of the 132 SMs idle; splitting the KV axis
// across blocks, sharing one read of a cache row between the chunks of a
// wide group, and cp.async/TMA page loads, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Most block-table entries one row may have: the table lives in dynamic
// shared memory beside the (<= 34 KB) static merge buffers, under 48 KB.
constexpr int kMaxTableBlocks = 2048;
// Query rows one block holds in registers (the REP of the widest
// instantiation); wider GQA groups split over blocks.
constexpr int kMaxRows = 8;

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Where a row's cache positions live.  Dense: nb = 0, span = S.  Paged:
// tables (B, nb) int32 into a pool of `pages` blocks of `bs` positions.
struct Layout {
  const int* tables;
  int span;   // positions a row can hold: S, or nb * bs
  int nb;
  int bs;
  int pages;
};

template <typename T>
struct Pack;  // elements of T in one 16-byte load
template <>
struct Pack<float> {
  static constexpr int N = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_pack(const float* p, float (&o)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = u.x;
  o[1] = u.y;
  o[2] = u.z;
  o[3] = u.w;
}

__device__ __forceinline__ void load_pack(const __nv_bfloat16* p,
                                          float (&o)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// REP is the block's row count (min(rep, 8)) rounded up to a power of
// two; rows past it are zero queries whose results are never written.
// PAGED picks the row address.
template <typename T, int HD, int REP, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kv_len,
                            T* __restrict__ out, Layout lay, int KVH,
                            int rep) {
  constexpr int P = Pack<T>::N;        // elements per lane per cache row
  constexpr int GL = HD / P;           // lanes holding a slice of the row
  constexpr int G = pow2_at_least(GL); // lanes sharing one cache row
  constexpr int NG = kThreads / G;     // lane groups in the block
  // keys each group takes per step: fewer for wide REP to stay in registers
  constexpr int KPS = (REP * P >= 64) ? 2 : 4;
  constexpr int STEP = NG * KPS;       // positions the block covers per step
  static_assert(HD % P == 0 && G <= 32,
                "a cache row must map onto lanes of one warp");

  __shared__ float sm_m[NG][REP];
  __shared__ float sm_l[NG][REP];
  __shared__ float sm_acc[NG][REP][HD];
  extern __shared__ int sm_tbl[];      // paged: this row's block table

  const int chunks = (rep + kMaxRows - 1) / kMaxRows;  // 1 for rep <= 8
  const int b = blockIdx.x / (KVH * chunks);
  const int g = blockIdx.x / chunks % KVH;
  const int head0 = g * rep + blockIdx.x % chunks * kMaxRows;  // first row
  const int rows = min(kMaxRows, g * rep + rep - head0);       // <= REP
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int d0 = lane * P;
  const bool live = lane < GL;         // false only past HD (hd 112)
  const int H = KVH * rep;
  const int len = max(0, min(kv_len[b], lay.span));
  const float sqrt_hd = sqrtf(static_cast<float>(HD));

  float qr[REP][P];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rows && live) {
      load_pack(q + (static_cast<size_t>(b) * H + head0 + r) * HD + d0,
                qr[r]);
#pragma unroll
      for (int e = 0; e < P; ++e) qr[r][e] /= sqrt_hd;  // as the reference
    } else {
#pragma unroll
      for (int e = 0; e < P; ++e) qr[r][e] = 0.f;
    }
  }

  float m[REP], l[REP], acc[REP][P];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < P; ++e) acc[r][e] = 0.f;
  }

  const size_t row = static_cast<size_t>(KVH) * HD;  // stride of a position
  const T* kp = k + g * HD + d0;
  const T* vp = v + g * HD + d0;
  if constexpr (PAGED) {
    // only the blocks that hold valid positions are read; sentinels clamp
    const int used = (len + lay.bs - 1) / lay.bs;
    const int* tbl = lay.tables + static_cast<size_t>(b) * lay.nb;
    for (int i = threadIdx.x; i < used; i += kThreads) {
      sm_tbl[i] = min(max(tbl[i], 0), lay.pages - 1);
    }
    __syncthreads();
  }
  // cache position j of row b, in units of `row` elements
  auto position = [&](int j) -> size_t {
    if constexpr (PAGED) {
      return static_cast<size_t>(sm_tbl[j / lay.bs]) * lay.bs + j % lay.bs;
    } else {
      return static_cast<size_t>(b) * lay.span + j;
    }
  };

  // `base` is uniform across the block, so every lane reaches the shuffles.
  for (int base = 0; base < len; base += STEP) {
    const int j0 = base + grp * KPS;
    float kf[KPS][P], vf[KPS][P];
#pragma unroll
    for (int u = 0; u < KPS; ++u) {
      const int j = j0 + u;
      if (j < len && live) {
        const size_t at = position(j) * row;
        load_pack(kp + at, kf[u]);
        load_pack(vp + at, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < P; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[KPS][REP];
#pragma unroll
    for (int u = 0; u < KPS; ++u) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < P; ++e) dot = fmaf(qr[r][e], kf[u][e], dot);
        s[u][r] = dot;
      }
    }
    // full dot product: sum the partial dots of the G lanes of the row
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < KPS; ++u) {
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], off);
      }
    }
    if (j0 < len) {  // this group holds at least one valid position
#pragma unroll
      for (int u = 1; u < KPS; ++u) {
        if (j0 + u >= len) {
#pragma unroll
          for (int r = 0; r < REP; ++r) s[u][r] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = s[0][r];
#pragma unroll
        for (int u = 1; u < KPS; ++u) mx = fmaxf(mx, s[u][r]);
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);  // 0 on the group's first key
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < P; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int u = 0; u < KPS; ++u) {
          const float p = expf(s[u][r] - m_new);  // 0 for a masked position
          l[r] += p;
#pragma unroll
          for (int e = 0; e < P; ++e) acc[r][e] = fmaf(p, vf[u][e], acc[r][e]);
        }
        m[r] = m_new;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < P; ++e) sm_acc[grp][r][d0 + e] = acc[r][e];
    }
  }
  __syncthreads();

  // merge the groups' online-softmax states in fixed group order
  for (int o = threadIdx.x; o < rows * HD; o += kThreads) {
    const int r = o / HD;
    const int d = o % HD;
    float mx = -INFINITY;
    for (int gi = 0; gi < NG; ++gi) mx = fmaxf(mx, sm_m[gi][r]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {  // kv_len 0 leaves every group empty: output 0
      for (int gi = 0; gi < NG; ++gi) {
        const float w = expf(sm_m[gi][r] - mx);  // 0 for an empty group
        den = fmaf(sm_l[gi][r], w, den);
        num = fmaf(sm_acc[gi][r][d], w, num);
      }
    }
    store(out + (static_cast<size_t>(b) * H + head0 + r) * HD + d,
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, bool PAGED>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const int* kv_len,
                      T* out, int B, const Layout& lay, int KVH, int rep,
                      cudaStream_t stream) {
  const dim3 grid(B * KVH * ((rep + kMaxRows - 1) / kMaxRows));
  const size_t smem = PAGED ? sizeof(int) * lay.nb : 0;
  if (rep == 1) {
    decode_attention_kernel<T, HD, 1, PAGED>
        <<<grid, kThreads, smem, stream>>>(q, k, v, kv_len, out, lay, KVH,
                                           rep);
  } else if (rep == 2) {
    decode_attention_kernel<T, HD, 2, PAGED>
        <<<grid, kThreads, smem, stream>>>(q, k, v, kv_len, out, lay, KVH,
                                           rep);
  } else if (rep <= 4) {
    decode_attention_kernel<T, HD, 4, PAGED>
        <<<grid, kThreads, smem, stream>>>(q, k, v, kv_len, out, lay, KVH,
                                           rep);
  } else {   // 8 rows a block; a group wider than 8 takes several blocks
    decode_attention_kernel<T, HD, kMaxRows, PAGED>
        <<<grid, kThreads, smem, stream>>>(q, k, v, kv_len, out, lay, KVH,
                                           rep);
  }
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, int B, const Layout& lay,
                     int KVH, int rep, int hd, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      return launch_hd<T, 32, PAGED>(qt, kt, vt, kv_len, ot, B, lay, KVH, rep,
                                     stream);
    case 64:
      return launch_hd<T, 64, PAGED>(qt, kt, vt, kv_len, ot, B, lay, KVH, rep,
                                     stream);
    case 112:
      return launch_hd<T, 112, PAGED>(qt, kt, vt, kv_len, ot, B, lay, KVH,
                                      rep, stream);
    case 128:
      return launch_hd<T, 128, PAGED>(qt, kt, vt, kv_len, ot, B, lay, KVH,
                                      rep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, int B, int H, int KVH, int hd, int dtype,
           const Layout& lay, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || lay.span <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = H / KVH;
  const int* lens = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_t<float, PAGED>(q, k, v, lens, out, B,
                                                   lay, KVH, rep, hd, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_t<__nv_bfloat16, PAGED>(
        q, k, v, lens, out, B, lay, KVH, rep, hd, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the CUDA error of the launch (0 = cudaSuccess).

// k, v (B, S, KVH, hd)
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, int B, int S, int H,
                                       int KVH, int hd, int dtype,
                                       void* stream) {
  const Layout lay{nullptr, S, 0, 0, 0};
  return launch<false>(q, k, v, kv_len, out, B, H, KVH, hd, dtype, lay,
                       stream);
}

// k_pages, v_pages (P, BS, KVH, hd); tables (B, NB) int32
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_len, void* out, int B, int H, int KVH,
    int hd, int P, int BS, int NB, int dtype, void* stream) {
  if (P <= 0 || BS <= 0 || NB <= 0 || NB > kMaxTableBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay{static_cast<const int*>(tables), NB * BS, NB, BS, P};
  return launch<true>(q, k_pages, v_pages, kv_len, out, B, H, KVH, hd, dtype,
                      lay, stream);
}
