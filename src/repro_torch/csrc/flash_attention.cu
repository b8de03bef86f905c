// GQA flash attention (forward), causal or not, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:71 flash_attention_pallas
//   (pallas_call at :95, body _kernel at :28-68)
// with both values of its causal flag and any Sq and Sk: causal over a
// full sequence is the product attention_prefill needs; non-causal, the
// encoder's self-attention and the cross-attention of an encoder-decoder
// (src/repro/models/attention.py and encdec.py run both as
// chunked_attention).
//
//   q    (B, Sq, H, hd)    f32 or bf16
//   k, v (B, Sk, KVH, hd)  q's dtype; head h reads KV head h / (H / KVH)
//   out  (B, Sq, H, hd)    q's dtype
// Causal: query i attends to keys 0..i (the top-left mask of the
// reference's attention_ref, also where Sq != Sk); non-causal: to keys
// 0..Sk-1.  q's 1/sqrt(hd) is applied in f32 (to the scores on the
// tensor-core path, to q on the CUDA-core one, never to a rounded q);
// scores, the online softmax and the sums are f32.
//
// The TPU kernel walks a sequential grid axis over KV blocks with the
// running max, denominator and accumulator in VMEM scratch, and skips the
// blocks above the diagonal with pl.when.  Blocks on this card run in no
// order, so one thread block owns 64 query rows of one (b, h) and loops
// over the KV tiles itself: causal, only up to the diagonal (the causal
// skip), the blocks with the longest row ranges starting first;
// non-causal, over all ceil(Sk / tile) tiles.  The keys at or past Sk in
// the last tile are masked on both paths (TMA zero-fills those rows,
// which would otherwise score 0 rather than -inf).
//
// What bounds it: operations, at a prefill's shapes.  A call does 4 hd
// flops per (query, key) pair it attends, about 2 S^2 hd H in all for a
// causal S (4 Sq Sk hd H non-causal), against (Sq H + 2 Sk KVH) hd
// elements read and Sq H hd written: at S 700, hd 128 hundreds of flops a
// byte, so the products belong on the tensor cores.  A few queries
// against many keys (cross-attention of a 4-token decoder prompt over an
// encoder's 1,500 frames) is bound by its bytes instead.
//
// bf16 (the served models' path): the tensor cores, FlashAttention-3's
// shape (hopper.cuh has the layouts).  A block is one consumer warpgroup
// (warps 0-3) and one producer warp (warp 4).  The producer's one thread
// loads Q once and keeps K/V tiles of 64 keys in flight by TMA, in a ring
// of two stages with full (K and V apart) and empty mbarriers; TMA
// zero-fills rows past Sq or Sk and columns past hd, so ragged lengths
// need no padding and hd 32 and 112 are carried as 64 and 128 columns of
// which the zeros add nothing (the Q K^T product runs ceil(hd / 16) k-steps:
// seven at hd 112).  The consumer runs S = Q K^T with wgmma m64n64k16 (Q
// and K from shared memory, both K-major), the online softmax on the f32
// accumulator in registers (row max and the exp2 of the scaled scores;
// the four lanes of a row combine with two shuffles), converts P to bf16
// in registers and feeds it as the A operand of O += P V (wgmma
// m64n{hd}k16, V the MN-major B operand through the descriptor's
// transpose bit).  Only the last tile a block reads is masked (causal: at
// the diagonal; both: the keys past Sk); tiles above the diagonal are
// never loaded.  P rounded to bf16 adds about 2^-9 relative error to each
// weight, averaged over the keys (the denominator sums the f32 weights).
// GQA: the heads of one KV group read the same K/V tiles; the grid puts
// them next to each other (heads fastest, then query tiles from the
// longest, then batch), so they run together and share the tiles
// through L2 rather than through one block's shared memory.  Shared
// memory: Q plus two stages of K and V, 80 KB at hd 112-128 (two blocks a
// SM), 40 KB at hd 32-64.
//
// f32: the CUDA cores, since TF32 would miss the f32 tolerance of 1e-5.
// Per KV tile of kBK = 32 keys: K goes to shared memory, each thread forms
// a 4 x 2 block of scores (rows ty + 16 i, keys tx + 16 j) from the f32 Q
// tile in shared memory, the 16 lanes of a row reduce max and sum with
// shuffles, the probabilities go to shared memory, V replaces K, and each
// thread accumulates 4 rows x hd/16 output dims (tx + 16 k) in registers.
// Rows are padded by one float so column reads hit distinct banks; the
// ragged last tile of queries and keys is masked.  Shared memory: (64 +
// 32) (hd + 1) + 64 * 33 floats, 58 KB at hd 128.
//
// The C entry point picks the path from the dtype before it launches, and
// reports it (0 CUDA cores, 1 tensor cores).  TMA takes only 16-byte
// aligned bases, so it refuses bf16 pointers that are not; the wrapper
// refuses them first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows a block owns
constexpr int kBK = 32;         // keys a tile
constexpr int kRows = kBQ / 16; // rows a thread owns
constexpr int kKeys = kBK / 16; // scores a thread forms per row and tile
constexpr int kLP = kBK + 1;    // padded probability row
constexpr int kMaxDevices = 64;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (HD + 1) + kBQ * kLP);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Sk, int H,
                           int KVH, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / 16;  // output dims a thread owns
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  extern __shared__ float smem[];
  float* sq = smem;             // [kBQ][LD]   scaled queries
  float* skv = sq + kBQ * LD;   // [kBK][LD]   K, then V
  float* sp = skv + kBK * LD;   // [kBQ][kLP]  probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t q_row = static_cast<size_t>(H) * HD;     // position stride
  const size_t kv_row = static_cast<size_t>(KVH) * HD;
  const float* qb = q + static_cast<size_t>(b) * Sq * q_row + h * HD;
  const float* kb = k + static_cast<size_t>(b) * Sk * kv_row + g * HD;
  const float* vb = v + static_cast<size_t>(b) * Sk * kv_row + g * HD;

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int qi = q0 + r;
    sq[r * LD + d] = qi < Sq ? qb[qi * q_row + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], o[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] = 0.f;
  }

  // keys any row of the tile sees
  const int kv_end = causal ? min(q0 + kBQ, Sk) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q stored; the previous tile's V reads done
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i % HD;
      const int kj = k0 + c;
      skv[c * LD + d] = kj < Sk ? kb[kj * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], kk[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kk[j] = skv[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
    }

    // mask, then the online softmax; the 16 lanes of a row are one
    // half-warp (lane = 16 * (ty % 2) + tx), so xor shuffles below 16 stay
    // inside the row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= Sk || (causal && kj > qi)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - base);  // 0 before the first key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = expf(s[i][j] - base);       // 0 for a masked key
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[i][c] *= corr;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sp[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();  // probabilities written; K reads done

    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i % HD;
      const int kj = k0 + c;
      skv[c * LD + d] = kj < Sk ? vb[kj * kv_row + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sp[(ty + 16 * i) * kLP + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = skv[c * LD + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) o[i][dd] = fmaf(pv[i], vv, o[i][dd]);
      }
    }
  }

  float* ob = out + static_cast<size_t>(b) * Sq * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        ob[qi * q_row + tx + 16 * dd] = o[i][dd] / den;
      }
    }
  }
}

// Lets the kernel use more than 48 KB of dynamic shared memory; set once
// per device (a graph capture then replays launches without it).
template <int HD>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<HD>()));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The shape of one call, as the C entry point takes it.
struct Shape {
  int B, Sq, Sk, H, KVH, causal;
};

template <int HD>
cudaError_t launch_f32_hd(const void* q, const void* k, const void* v,
                          void* out, const Shape& sh, cudaStream_t stream) {
  const cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Sq + kBQ - 1) / kBQ, sh.H, sh.B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_attention_kernel<HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sh.Sq, sh.Sk,
      sh.H, sh.KVH, scale, sh.causal);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, const Shape& sh, int hd,
                       cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_f32_hd<32>(q, k, v, out, sh, stream);
    case 64:
      return launch_f32_hd<64>(q, k, v, out, sh, stream);
    case 112:
      return launch_f32_hd<112>(q, k, v, out, sh, stream);
    case 128:
      return launch_f32_hd<128>(q, k, v, out, sh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V by TMA
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;          // query rows a block owns (one warpgroup)
constexpr int kBK = 64;          // keys a tile
constexpr int kStages = 2;       // K/V tiles in flight
constexpr int kThreads = 160;    // warps 0-3 consume, warp 4 loads
constexpr int kPanelBytes = 64 * 128;   // 64 rows of 64 bf16 columns

template <int HD>
struct Cfg {
  static constexpr int kPanels = (HD + 63) / 64;      // 64-column panels
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kKSteps = (HD + 15) / 16;      // k16 steps of Q K^T
  // 1 KB of slack to align the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmem = 1024 + size_t(kTileBytes) * (1 + 2 * kStages);
};

// O += P V for one k16 step: N = HD columns of V (MN-major, transposed B).
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) hopper::wgmma_rs_n32<1>(o, a, db, 1);
  if constexpr (HD == 64) hopper::wgmma_rs_n64<1>(o, a, db, 1);
  if constexpr (HD == 112) hopper::wgmma_rs_n112<1>(o, a, db, 1);
  if constexpr (HD == 128) hopper::wgmma_rs_n128<1>(o, a, db, 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ out, int Sq, int Sk, int H,
                       int KVH, float scale_log2, int causal) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sq = smem;                              // [kPanels][64][128 B]
  unsigned char* sk = sq + C::kTileBytes;                // [kStages] tiles
  unsigned char* sv = sk + kStages * C::kTileBytes;      // [kStages] tiles
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[kStages], full_v[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int q0 = qt * kBQ;
  // key tiles: up to the diagonal (causal), all of them (non-causal)
  const int nk = (Sk + kBK - 1) / kBK;
  const int n_tiles = causal ? min(qt + 1, nk) : nk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 4);         // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q once, then K and V tile by tile, a stage at a time
    if (lane == 0) {
      hopper::mbar_expect_tx(&bar_q, C::kTileBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p) {
        hopper::tma_load_4d(sq + p * kPanelBytes, &qmap, &bar_q, 64 * p, h,
                            q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int use = t / kStages;
        if (use > 0) hopper::mbar_wait(&empty[s], (use - 1) & 1);
        hopper::mbar_expect_tx(&full_k[s], C::kTileBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          hopper::tma_load_4d(sk + s * C::kTileBytes + p * kPanelBytes, &kmap,
                              &full_k[s], 64 * p, g, t * kBK, b);
        }
        hopper::mbar_expect_tx(&full_v[s], C::kTileBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          hopper::tma_load_4d(sv + s * C::kTileBytes + p * kPanelBytes, &vmap,
                              &full_v[s], 64 * p, g, t * kBK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows r and r + 8 of the tile, r = 16 warp + lane/4
  const int r = 16 * warp + lane / 4;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  const uint32_t q_addr = hopper::smem_u32(sq);

  hopper::mbar_wait(&bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t k_addr = hopper::smem_u32(sk + s * C::kTileBytes);
    const uint32_t v_addr = hopper::smem_u32(sv + s * C::kTileBytes);

    // S = Q K^T (64 x 64, f32)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::mbar_wait(&full_k[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      hopper::wgmma_ss_n64<0, 0>(sc, hopper::desc_sw128(q_addr + off, 16, 1024),
                                 hopper::desc_sw128(k_addr + off, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // mask the last tile: keys past Sk (zero-filled by TMA), and, causal,
    // keys past the query (that tile is the diagonal one, or one wholly
    // below it), then the online softmax over the tile, in f32
    const bool last = t == n_tiles - 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = q0 + r + 8 * ((i / 2) % 2);
      const int key = t * kBK + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if (last && (key >= Sk || (causal && key > row))) sc[i] = -INFINITY;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
    float base[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      // finite: key 0 of tile 0 is visible to every row
      const float corr = exp2f((m[j] - mx[j]) * scale_log2);  // 0 at first
      l[j] *= corr;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        if ((i / 2) % 2 == j) o[i] *= corr;
      }
      m[j] = mx[j];
      base[j] = mx[j] * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -base[j]));  // 0 where masked
      l[j] += sc[i];
    }
    // P to bf16: the accumulator's columns 16kk.. are k-step kk of A
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = hopper::pack_bf16(sc[8 * kk + 2 * i],
                                      sc[8 * kk + 2 * i + 1]);
      }
    }

    // O += P V
    hopper::mbar_wait(&full_v[s], parity);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pv_step<HD>(o, pa[kk],
                  hopper::desc_sw128(v_addr + kk * 16 * 128, kPanelBytes,
                                     1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);   // K and V read
  }

  // the four lanes of a row hold quarters of its sum
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    inv[j] = 1.f / l[j];
  }
  const size_t q_row = static_cast<size_t>(H) * HD;
  bf16* ob = out + static_cast<size_t>(b) * Sq * q_row + h * HD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r + 8 * j;
    if (qi < Sq) {
      uint32_t* orow = reinterpret_cast<uint32_t*>(ob + qi * q_row);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        orow[4 * c + lane % 4] = hopper::pack_bf16(o[4 * c + 2 * j] * inv[j],
                                                   o[4 * c + 2 * j + 1] * inv[j]);
      }
    }
  }
}

template <int HD>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Cfg<HD>::kSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// (hd, heads, S, B) of a (B, S, heads, hd) bf16 tensor, boxes of 64
// columns x 1 head x 64 positions x 1 batch.
bool encode(CUtensorMap* map, const void* base, int B, int S, int heads,
            int hd) {
  const uint64_t dims[4] = {uint64_t(hd), uint64_t(heads), uint64_t(S),
                            uint64_t(B)};
  const uint64_t row = uint64_t(hd) * sizeof(bf16);
  const uint64_t strides[3] = {row, row * heads, row * heads * S};
  const uint32_t box[4] = {64, 1, uint32_t(kBK), 1};
  return hopper::encode_bf16(map, base, 4, dims, strides, box);
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      const Shape& sh, cudaStream_t stream) {
  static_assert(kBQ == kBK, "query tile qt's diagonal is key tile qt");
  const cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, q, sh.B, sh.Sq, sh.H, HD) ||
      !encode(&kmap, k, sh.B, sh.Sk, sh.KVH, HD) ||
      !encode(&vmap, v, sh.B, sh.Sk, sh.KVH, HD)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(sh.H, (sh.Sq + kBQ - 1) / kBQ, sh.B);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(HD)));
  flash_wgmma_kernel<HD><<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(out), sh.Sq, sh.Sk, sh.H, sh.KVH,
      scale_log2, sh.causal);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Shape& sh, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, sh, stream);
    case 64:
      return launch_hd<64>(q, k, v, out, sh, stream);
    case 112:
      return launch_hd<112>(q, k, v, out, sh, stream);
    case 128:
      return launch_hd<128>(q, k, v, out, sh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes.  q (B, Sq, H, hd), k and v (B, Sk, KVH,
// hd); causal: 1 for the top-left causal mask, 0 for none.  dtype: 0 =
// float32, 1 = bfloat16.  *path is set before the launch: 0 the CUDA-core
// kernel (f32), 1 the tensor-core kernel (bf16).  Returns the CUDA error
// of the launch (0 = cudaSuccess).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int KVH, int hd,
                                      int causal, int dtype, void* stream,
                                      int* path) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      H > 65535 || B > 65535 || (causal != 0 && causal != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh{B, Sq, Sk, H, KVH, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    *path = 0;
    return static_cast<int>(launch_f32(q, k, v, out, sh, hd, st));
  }
  if (dtype == 1 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(out)) {
    *path = 1;
    return static_cast<int>(tc::launch(q, k, v, out, sh, hd, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
