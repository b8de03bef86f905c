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
// scalar-prefetched block table.  Here a row's positions are split over
// the blocks of a thread-block cluster, each block walks its share with
// the same online softmax, and the blocks merge their states through
// distributed shared memory.  A position's row address is computed per
// position:
//   dense  (b*S + j) * KVH*hd                        k, v (B, S, KVH, hd)
//   paged  (tbl[b][j / BS]*BS + j % BS) * KVH*hd      pools (P, BS, KVH, hd)
// Nothing else differs between the two, so with NB*BS == S and identity
// tables the paged kernel does the dense kernel's arithmetic in the same
// order and its output equals the dense kernel's bit for bit.
//
//   q      (B, H, hd)        f32 or bf16
//   kv_len (B,) int32        positions >= kv_len[b] are masked; clamped to
//                            the span (S, or NB*BS)
//   tables (B, NB) int32     paged only; entries >= P are sentinels, clamped
//                            to P-1 and never read (they lie past kv_len)
//   out    (B, H, hd)        q's dtype; scores, softmax and sums in f32
//
// What bounds it: memory.  A call reads 2 * sum(kv_len) * KVH * hd cache
// elements and does 4 * H * hd flops per cached position, i.e. rep flops
// per byte read in bf16 (rep = H / KVH, at most 48 in the repo's configs),
// far below the ~295 flops/byte at which the H100 turns compute-bound.
// For qwen3-4b (KVH 8, hd 128, bf16) with 8 slots averaging 400 positions
// that is ~13 MB a layer, ~4 us at 3.35 TB/s.  The paged form adds the
// row's used table entries (4 bytes per BS positions).  Reaching that
// rate takes many blocks with copies in flight, each byte read once, and
// little arithmetic on the way:
//
// * Split-KV over a cluster.  A cluster of kCluster (8) blocks owns one
//   (b, kv_head) pair and its group's query rows (up to kMaxRows, 64: one
//   cluster for every GQA ratio of the repo's configs).  Block `rank`
//   takes positions [rank * share, (rank + 1) * share) of the row, share =
//   ceil(kv_len / kCluster) rounded up to whole tiles; the grid is
//   B * KVH * 8 blocks (512 at 8 slots of qwen3-4b, on 132 SMs).  The
//   split, and the order of every f32 sum, depend only on kv_len[b] and
//   compile-time constants, never on B or on other rows, so a row's result
//   does not depend on the batch.  After its walk each block sends every
//   row's (m, l, acc) to the row's owner, block r % 8, into the owner's
//   shared memory (map_shared_rank); after one cluster.sync() each owner
//   merges its rows' 8 states in rank order and writes them once.  No
//   workspace, no atomics, no second launch.  A block whose share is empty
//   (kv_len 1) still sends, as m = -inf, l = 0: weight exp(-inf - m) = 0.
// * One cache read per (b, kv_head).  K and V tiles of kTile (32)
//   positions come into shared memory once, and every query row of the
//   group is computed from them.
// * Asynchronous copies.  Tiles come through a ring of kStages (2) stages
//   by 16-byte cp.async copies (hopper.cuh); a stage is refilled as soon
//   as its tile is computed, so the tile waited for and the next one are
//   in flight together.  Positions past the block's share are zero-filled,
//   not read, so masked positions meet zeros and never NaN.  The paged
//   block first reads the table entries its share needs into shared
//   memory; a lane then finds one position's address and the copies take
//   it by shuffle.
// * The arithmetic (Rows).  bf16 groups of 2 or more rows run on the
//   tensor cores (TensorRows): a warp for each 16 rows (and at least two
//   warps a block, for the copies) does S = Q K^T and O += P V as mma.sync
//   m16n8k16 with K and V fragments by ldmatrix from the padded tile, and
//   the softmax on the accumulators in registers; at rep 4 three quarters
//   of the 16 rows are padding, which the tensor cores absorb.  f32 (all
//   ratios) and bf16 at rep 1 (zamba2-7b: no rows to pad) run on the CUDA
//   cores (CoreRows): rows spread over warps, one lane per position for the
//   scores and lanes over the head dim for P.V.
// Launch: cudaLaunchKernelEx with a cluster dimension; no host sync and
// no allocation, so a CUDA graph can capture it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

// Blocks of a cluster, which split one row's positions (portable size).
constexpr int kCluster = 8;
// Positions a tile: one a lane in the score step.
constexpr int kTile = 32;
// Shared-memory stages of the copy ring: a stage is refilled as soon as
// its tile is computed, so kStages tiles are in flight while one is
// waited for.
constexpr int kStages = 2;
// Query rows one cluster holds; a group wider than this (none of the
// repo's configs) splits over clusters, each reading the cache again.
constexpr int kMaxRows = 64;
// Most block-table entries one row may have (the paged block's share of
// the table is staged in dynamic shared memory sized for the whole row).
constexpr int kMaxTableBlocks = 2048;

// Where a row's cache positions live.  Dense: nb = 0, span = S.  Paged:
// tables (B, nb) int32 into a pool of `pages` blocks of `bs` positions.
struct Layout {
  const int* tables;
  int span;   // positions a row can hold: S, or nb * bs
  int nb;
  int bs;
  int pages;
};

// N consecutive elements of a shared-memory tile, as f32.
template <int N>
__device__ __forceinline__ void to_f32(const float* p, float (&o)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "one load");
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x;
    o[1] = u.y;
    o[2] = u.z;
    o[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    o[0] = u.x;
    o[1] = u.y;
  } else {
    o[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void to_f32(const __nv_bfloat16* p,
                                       float (&o)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "one load");
  if constexpr (N == 1) {
    o[0] = __bfloat162float(*p);
  } else {
    using Word = typename std::conditional<
        N == 8, uint4, typename std::conditional<N == 4, uint2,
                                                 uint32_t>::type>::type;
    const Word u = *reinterpret_cast<const Word*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// 16 bytes of global memory (4 f32 or 8 bf16 elements), as f32.
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = u.x;
  o[1] = u.y;
  o[2] = u.z;
  o[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
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

// N f32 to shared memory (this block's or, mapped, another's) in one store.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "one store");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Cluster barrier halves: a relaxed arrival, and the wait for everyone's.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Where a row's state goes: block r % kCluster merges row r, and keeps
// each block's m, l [kCluster][own] and acc [kCluster][own][HD] (f32).
struct Inbox {
  float* m;
  float* l;
  float* acc;
  int own;   // rows a block merges, at most: ceil(rows / kCluster)
  int rank;  // the sending block
};

// Sends row r's state (this lane's `n` accumulators from column d) to
// the row's owner; lanes with `head` also send m and l.
template <int N>
__device__ __forceinline__ void send_row(cg::cluster_group& cluster,
                                         const Inbox& in, int r, bool head,
                                         float m, float l, int d,
                                         const float (&acc)[N], int HD) {
  const int slot = in.rank * in.own + r / kCluster;
  const unsigned owner = r % kCluster;
  if (head) {
    *cluster.map_shared_rank(in.m + slot, owner) = m;
    *cluster.map_shared_rank(in.l + slot, owner) = l;
  }
  store_f32(cluster.map_shared_rank(in.acc + slot * HD + d, owner), acc);
}

// ---------------------------------------------------------------------
// CUDA-core rows (f32, and bf16 at rep 1): RC query rows a warp, held in
// registers.  Per tile a warp computes scores with one lane per position
// (the K row read from the padded tile, the queries broadcast from shared
// memory), keeps each row's running max across the warp, stages the
// tile's probabilities in shared memory, and accumulates P.V with lanes
// over the head dim.
template <typename T, int HD, int RC>
struct CoreRows {
  static constexpr int PK = 16 / sizeof(T);  // elements a 16-byte chunk
  static constexpr int CPR = HD / PK;
  static constexpr int RS = HD + PK;          // the ring's padded row
  static constexpr int EPL = HD <= 32 ? 1 : (HD <= 64 ? 2 : 4);
  static_assert(HD % PK == 0 && HD <= 32 * EPL && HD % EPL == 0,
                "a cache row maps onto the lanes of one warp");

  // scaled queries [nw * RC][HD] and probability tiles [nw][RC][kTile]
  __host__ __device__ static size_t smem(int nw) {
    return sizeof(float) * nw * RC * (HD + kTile);
  }

  float* qs;
  float* pw;  // this warp's probability tiles
  int warp, lane, nw, mine;
  float m[RC], l[RC], acc[RC][EPL];

  __device__ void init(unsigned char* mem, int rows) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    nw = blockDim.x / 32;
    mine = (rows - warp + nw - 1) / nw;  // rows warp, warp + nw, ...
    qs = reinterpret_cast<float*>(mem);
    pw = qs + nw * RC * HD + warp * RC * kTile;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
    }
  }

  __device__ void stage_q(const T* qg, int rows) {
    const float sqrt_hd = sqrtf(static_cast<float>(HD));
    for (int o = threadIdx.x * PK; o < rows * HD; o += blockDim.x * PK) {
      float qf[PK];
      load16(qg + o, qf);
#pragma unroll
      for (int e = 0; e < PK; ++e) qs[o + e] = qf[e] / sqrt_hd;  // as ref
    }
  }

  __device__ void ready() {}

  // n_valid: the tile's positions before the share's end (>= 1)
  __device__ void tile(const T* ks, const T* vs, int n_valid) {
    const bool valid = lane < n_valid;
    // scores: four partial sums a row so that the FMAs do not wait on
    // each other (a partial unroll keeps the K chunks in flight from
    // taking every register)
    float sp[RC][4];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
#pragma unroll
      for (int h = 0; h < 4; ++h) sp[i][h] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < CPR; ++c) {
      float kf[PK];
      to_f32<PK>(ks + lane * RS + c * PK, kf);
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        if (i < mine) {
#pragma unroll
          for (int h = 0; h < PK; h += 4) {
            const float4 u = *reinterpret_cast<const float4*>(
                qs + (warp + nw * i) * HD + c * PK + h);
            sp[i][0] = fmaf(u.x, kf[h], sp[i][0]);
            sp[i][1] = fmaf(u.y, kf[h + 1], sp[i][1]);
            sp[i][2] = fmaf(u.z, kf[h + 2], sp[i][2]);
            sp[i][3] = fmaf(u.w, kf[h + 3], sp[i][3]);
          }
        }
      }
    }
    // online softmax: the max across the warp, the sum kept per lane
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      if (i < mine) {
        const float x = valid ? (sp[i][0] + sp[i][1]) + (sp[i][2] + sp[i][3])
                              : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m[i], mx);    // finite: lane 0 is valid
        const float corr = expf(m[i] - m_new);  // 0 on the first tile
        const float p = expf(x - m_new);        // 0 for a masked position
        l[i] = fmaf(l[i], corr, p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
        pw[i * kTile + lane] = p;
        m[i] = m_new;
      }
    }
    __syncwarp();
    // P.V: lanes over the head dim, four positions at a time
    const int d = lane * EPL < HD ? lane * EPL : 0;
#pragma unroll
    for (int j = 0; j < kTile; j += 4) {
      float vf[4][EPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) to_f32<EPL>(vs + (j + u) * RS + d, vf[u]);
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        if (i < mine) {
          const float4 p =
              *reinterpret_cast<const float4*>(pw + i * kTile + j);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            float a = fmaf(p.x, vf[0][e], acc[i][e]);
            a = fmaf(p.y, vf[1][e], a);
            a = fmaf(p.z, vf[2][e], a);
            acc[i][e] = fmaf(p.w, vf[3][e], a);
          }
        }
      }
    }
    __syncwarp();  // pw is written again on the next tile
  }

  __device__ void send(cg::cluster_group& cluster, const Inbox& in) {
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      if (i < mine) {
        float sum = l[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        if (lane * EPL < HD) {  // lanes past hd 112 hold nothing
          send_row(cluster, in, warp + nw * i, lane == 0, m[i], sum,
                   lane * EPL, acc[i], HD);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------
// Tensor-core rows (bf16, rep >= 2): MT tiles of 16 query rows, warp w
// owning rows 16w..16w+15 (rows past the group are zero queries whose
// results are not sent).  Per tile of 32 positions a warp runs S = Q K^T
// as 4 x HD/16 mma.sync m16n8k16 (Q's fragments in registers, K's by
// ldmatrix from the padded tile), scales and masks S in f32, keeps each
// row's running max across the four lanes that hold it, turns P into the
// bf16 A fragments of P V in registers, and runs O += P V as 2 x HD/8
// mma.sync with V's fragments by ldmatrix.trans.  Scores are exact sums
// of bf16 products in f32.  P goes to P V as two bf16 parts, hi + lo
// (about 16 bits of P, for twice the P V products, which the tensor cores
// absorb), so that P's rounding adds little to the output's own (PERF.md,
// Findings, gives the errors with P as one bf16 and as hi + lo).
template <int HD, int MT>
struct TensorRows {
  using bf16 = __nv_bfloat16;
  static constexpr int RS = HD + 8;  // the ring's padded row (bf16)
  static constexpr int KS = HD / 16;
  static constexpr int NO = HD / 8;
  static_assert(HD % 16 == 0, "whole k16 steps");

  // the queries [16 * MT][RS] bf16, as they came
  __host__ __device__ static size_t smem(int) {
    return sizeof(bf16) * 16 * MT * RS;
  }

  bf16* qb;
  int warp, lane, rows;
  uint32_t qa[KS][4];
  float o[NO][4];
  float m[2], l[2];  // rows g and g + 8 of the warp's tile

  __device__ void init(unsigned char* mem, int rows_) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    rows = rows_;
    qb = reinterpret_cast<bf16*>(mem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    }
  }

  __device__ void stage_q(const bf16* qg, int n_rows) {
    constexpr int CPR = HD / 8;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < 16 * MT * CPR; c += blockDim.x) {
      const int r = c / CPR;
      const int e = c % CPR * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r < n_rows) {
        u = __ldg(reinterpret_cast<const uint4*>(qg + r * HD + e));
      }
      *reinterpret_cast<uint4*>(qb + r * RS + e) = u;
    }
  }

  // after a __syncthreads(): the warp's query fragments into registers
  __device__ void ready() {
    if (warp >= MT) return;
    const bf16* row = qb + (16 * warp + lane % 16) * RS + 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) hopper::ldmatrix_x4(qa[kk], row + 16 * kk);
  }

  __device__ void tile(const bf16* ks, const bf16* vs, int n_valid) {
    if (warp >= MT) return;
    const int t = lane % 4;
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    // K fragments: matrix i of an x4 is positions 8(nb + i / 2).., k
    // columns 16kk + 8(i % 2)..
    const bf16* krow = ks + (8 * (lane / 16) + lane % 8) * RS +
                       8 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        uint32_t b[4];
        hopper::ldmatrix_x4(b, krow + 8 * nb * RS + 16 * kk);
        hopper::mma_16816(s[nb], qa[kk], b[0], b[1]);
        hopper::mma_16816(s[nb + 1], qa[kk], b[2], b[3]);
      }
    }
    // scale, mask, and the running max of rows g and g + 8
    const float inv = 1.f / sqrtf(static_cast<float>(HD));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = 8 * n + 2 * t + (e & 1) < n_valid;
        s[n][e] = ok ? s[n][e] * inv : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: position 0 valid
      corr[h] = expf(m[h] - m_new);            // 0 on the first tile
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // P as the A fragments of P V's two k16 steps, in two bf16 parts
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[n][e] - m[e / 2]);  // 0 for a masked position
        l[e / 2] += p[e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t top = hopper::pack_bf16(p[2 * h], p[2 * h + 1]);
        const float2 back = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&top));
        hi[n / 2][2 * (n % 2) + h] = top;
        lo[n / 2][2 * (n % 2) + h] =
            hopper::pack_bf16(p[2 * h] - back.x, p[2 * h + 1] - back.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // V fragments (transposed): matrix i is positions 16kk + 8(i % 2)..,
    // columns 8(nb + i / 2)..
    const bf16* vrow = vs + (8 * ((lane / 8) % 2) + lane % 8) * RS +
                       8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NO; nb += 2) {
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(b, vrow + 16 * kk * RS + 8 * nb);
        hopper::mma_16816(o[nb], lo[kk], b[0], b[1]);
        hopper::mma_16816(o[nb + 1], lo[kk], b[2], b[3]);
        hopper::mma_16816(o[nb], hi[kk], b[0], b[1]);
        hopper::mma_16816(o[nb + 1], hi[kk], b[2], b[3]);
      }
    }
  }

  __device__ void send(cg::cluster_group& cluster, const Inbox& in) {
    if (warp >= MT) return;
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int r = 16 * warp + g + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float pair[2] = {o[n][2 * h], o[n][2 * h + 1]};
          send_row(cluster, in, r, t == 0 && n == 0, m[h], sum,
                   8 * n + 2 * t, pair, HD);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------
// One kernel for both entry points; PAGED picks the position's address,
// Rows the arithmetic (CoreRows or TensorRows).
template <typename T, int HD, class Rows, bool PAGED, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kv_len,
                            T* __restrict__ out, Layout lay, int KVH,
                            int rep) {
  constexpr int PK = 16 / sizeof(T);   // elements a 16-byte copy
  constexpr int CPR = HD / PK;         // 16-byte chunks a cache row
  constexpr int RS = HD + PK;          // padded row: an odd number of
                                       // 16-byte units, no bank conflicts
  constexpr size_t kRing = kStages * 2 * kTile * RS * sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // Arrive now, wait before the first write to another block's shared
  // memory: by then every block of the cluster has started.
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nt = blockDim.x;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.x / kCluster;
  const int b = pair / KVH;
  const int g = pair % KVH;
  const int head0 = g * rep + blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, rep - static_cast<int>(blockIdx.y) *
                                          kMaxRows);
  const int H = KVH * rep;
  const int len = max(0, min(kv_len[b], lay.span));
  const int share =
      ((len + kCluster - 1) / kCluster + kTile - 1) / kTile * kTile;
  const int start = min(len, rank * share);
  const int end = min(len, start + share);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  // the ring, the rows' own buffers, the inbox, the table entries
  T* ring = reinterpret_cast<T*>(smem);
  unsigned char* own_mem = smem + kRing;
  Inbox in;
  in.own = (min(rep, kMaxRows) + kCluster - 1) / kCluster;
  in.rank = rank;
  in.m = reinterpret_cast<float*>(own_mem + Rows::smem(nt / 32));
  in.l = in.m + kCluster * in.own;
  in.acc = in.l + kCluster * in.own;
  int* tbl = reinterpret_cast<int*>(in.acc + kCluster * in.own * HD);

  int first = 0;  // paged: the table entry of position `start`
  if constexpr (PAGED) {
    if (end > start) {
      first = start / lay.bs;
      const int count = (end - 1) / lay.bs - first + 1;
      const int* row = lay.tables + static_cast<size_t>(b) * lay.nb + first;
      for (int i = threadIdx.x; i < count; i += nt) {
        tbl[i] = min(max(row[i], 0), lay.pages - 1);
      }
    }
    __syncthreads();
  }

  const size_t pos_stride = static_cast<size_t>(KVH) * HD;
  const size_t head_off = static_cast<size_t>(g) * HD;
  // element offset of position j (< end) of row b, kv head g
  auto at = [&](int j) -> size_t {
    size_t row;
    if constexpr (PAGED) {
      row = static_cast<size_t>(tbl[j / lay.bs - first]) * lay.bs +
            j % lay.bs;
    } else {
      row = static_cast<size_t>(b) * lay.span + j;
    }
    return row * pos_stride + head_off;
  };
  // Tile t of the share into stage t % kStages; always one commit group.
  // Paged, each lane first finds the address of one position (a division
  // by BS) and the copies take it by shuffle.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      T* ks = ring + (t % kStages) * (2 * kTile * RS);
      T* vs = ks + kTile * RS;
      const int j0 = start + t * kTile;
      size_t lane_at = 0;
      if constexpr (PAGED) lane_at = j0 + lane < end ? at(j0 + lane) : 0;
      // uniform across a warp: nt and kTile * CPR are multiples of 32
      for (int c = threadIdx.x; c < kTile * CPR; c += nt) {
        const int p = c / CPR;
        const int e = c % CPR * PK;
        const bool ok = j0 + p < end;
        size_t off;
        if constexpr (PAGED) {
          off = __shfl_sync(0xffffffffu, lane_at, p);
        } else {
          off = ok ? at(j0 + p) : 0;
        }
        off = ok ? off + e : 0;
        hopper::cp_async16(ks + p * RS + e, k + off, ok);
        hopper::cp_async16(vs + p * RS + e, v + off, ok);
      }
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) load_tile(t);  // fill the ring

  // the queries, while the first tiles are in flight
  Rows st;
  st.init(own_mem, rows);
  st.stage_q(q + (static_cast<size_t>(b) * H + head0) * HD, rows);
  __syncthreads();
  st.ready();

  // While a tile is waited for, the next kStages - 1 are in flight too.
  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 1>();  // this thread's copies of tile t
    __syncthreads();                       // everyone's copies of tile t
    const T* ks = ring + (t % kStages) * (2 * kTile * RS);
    // tile t holds at least one valid position (its first)
    st.tile(ks, ks + kTile * RS, end - start - t * kTile);
    __syncthreads();                       // everyone is done with tile t
    load_tile(t + kStages);                // into its stage
  }

  // Send each row's state to the row's owner, block r % kCluster.
  hopper::cp_async_wait<0>();
  cluster_wait();
  st.send(cluster, in);
  cluster.sync();  // every block's sends have landed

  // Merge the states of this block's rows in rank order and write them.
  const int mine = (rows - rank + kCluster - 1) / kCluster;
  for (int o = threadIdx.x; o < mine * HD; o += nt) {
    const int lr = o / HD;
    const int d = o % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) mx = fmaxf(mx, in.m[c * in.own + lr]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {  // kv_len 0 leaves every block empty: output 0
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        const int slot = c * in.own + lr;
        const float w = expf(in.m[slot] - mx);  // 0 for an empty block
        den = fmaf(in.l[slot], w, den);
        num = fmaf(in.acc[slot * HD + d], w, num);
      }
    }
    const int r = rank + kCluster * lr;
    store(out + (static_cast<size_t>(b) * H + head0 + r) * HD + d,
          num / fmaxf(den, 1e-30f));
  }
}

// Dynamic shared memory of a launch; the table is sized for the row.
template <typename T, int HD, class Rows>
size_t smem_bytes(int nw, int rep, int table_entries) {
  const int own = ((rep < kMaxRows ? rep : kMaxRows) + kCluster - 1) /
                  kCluster;
  return kStages * 2 * kTile * (HD + 16 / sizeof(T)) * sizeof(T) +
         Rows::smem(nw) + sizeof(float) * kCluster * own * (HD + 2) +
         sizeof(int) * table_entries;
}

template <typename T, int HD, class Rows, bool PAGED, int kThreads>
cudaError_t launch_rows(const T* q, const T* k, const T* v,
                        const int* kv_len, T* out, int B, const Layout& lay,
                        int KVH, int rep, int nw, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD, Rows, PAGED, kThreads>;
  // raised once, to the most any launch of this instantiation asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, HD, Rows>(
          kThreads / 32, kMaxRows, PAGED ? kMaxTableBlocks : 0)));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KVH * kCluster, (rep + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes =
      smem_bytes<T, HD, Rows>(nw, rep, PAGED ? lay.nb : 0);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, q, k, v, kv_len, out, lay, KVH, rep);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int HD, bool PAGED>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const int* kv_len,
                      T* out, int B, const Layout& lay, int KVH, int rep,
                      cudaStream_t stream) {
  const int rows = rep < kMaxRows ? rep : kMaxRows;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 groups of 2 or more rows on the tensor cores: a warp for each
    // 16 rows, and at least 2 warps for the copies
    if (rows >= 2) {
      if (rows <= 16) {
        return launch_rows<T, HD, TensorRows<HD, 1>, PAGED, 64>(
            q, k, v, kv_len, out, B, lay, KVH, rep, 2, stream);
      }
      if (rows <= 32) {
        return launch_rows<T, HD, TensorRows<HD, 2>, PAGED, 64>(
            q, k, v, kv_len, out, B, lay, KVH, rep, 2, stream);
      }
      return launch_rows<T, HD, TensorRows<HD, 4>, PAGED, 128>(
          q, k, v, kv_len, out, B, lay, KVH, rep, 4, stream);
    }
    // rep 1 (multi-head attention): one warp of one row, no padding
    return launch_rows<T, HD, CoreRows<T, HD, 1>, PAGED, 32>(
        q, k, v, kv_len, out, B, lay, KVH, rep, 1, stream);
  } else {
    // f32 on the CUDA cores: rows a warp grow with the group, warps =
    // ceil(rows / rc) <= 16
    const int rc = rows <= 4 ? 1 : (rows <= 16 ? 2 : 4);
    const int nw = (rows + rc - 1) / rc;
    if (rc == 1) {
      return launch_rows<T, HD, CoreRows<T, HD, 1>, PAGED, 128>(
          q, k, v, kv_len, out, B, lay, KVH, rep, nw, stream);
    }
    if (rc == 2) {
      return launch_rows<T, HD, CoreRows<T, HD, 2>, PAGED, 256>(
          q, k, v, kv_len, out, B, lay, KVH, rep, nw, stream);
    }
    return launch_rows<T, HD, CoreRows<T, HD, 4>, PAGED, 512>(
        q, k, v, kv_len, out, B, lay, KVH, rep, nw, stream);
  }
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
// Each launch returns the CUDA error of the launch (0 = cudaSuccess).

// Blocks a cluster: the blocks that split one row's positions.
extern "C" int decode_attention_cluster_blocks() { return kCluster; }

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
