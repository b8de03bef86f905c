// Grouped matmul, out[e] = x[e] @ w[e], for Hopper (sm_90a): the MoE
// expert FFN's contraction.
//
// Replaces the TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py:40 gmm_pallas
//     (pallas_call at :51, body _kernel at :25-37),
// the contraction src/repro/models/moe.py: moe_block spells as
// einsum('ecd,edf->ecf') (three calls per block: gate, up, down).
//
//   x    (E, C, D)  f32 or bf16, contiguous (the dispatch buffer)
//   w    (E, D, F)  x's dtype, contiguous, row-major (D, F) per expert
//   out  (E, C, F)  x's dtype
// Every product is accumulated in f32 and rounded once to x's dtype.
//
// The TPU kernel walks a sequential grid (E, C/bc, F/bf, D/bd) with the
// contraction axis innermost, carries an f32 accumulator in VMEM scratch
// from one D step to the next, and needs C, D and F to be multiples of its
// 512-wide blocks.  Blocks on this card run in no order, so one thread
// block owns a (C tile, F tile) of one expert and loops over D itself; the
// ragged last tiles of C, D and F are zero-filled on the way in and masked
// on the way out, so no size needs padding.
//
// What bounds it: at decode, bytes.  Whatever the routing, a call reads one
// expert matrix, 16 x 6144 x 10752 bf16 = 2.11 GB at dbrx-132b's widths,
// for 2 x 16 x 8 x 6144 x 10752 = 17 GFLOP: 0.63 ms at 3.35 TB/s, about 8
// flops a byte against the ~295 at which the bf16 tensor cores become the
// limit.  At a 700-token prefill (cap 224) a call is 474 GFLOP: 0.48 ms at
// the bf16 peak, under the 0.63 ms of the weights, so a prefill kernel has
// to stream the weights and keep the tensor cores busy at once.
//
// Four paths; the C entry point picks one from the dtype, the shape and
// the alignment before it launches, and reports it:
//
// 0 f32: CUDA-core FMAs (TF32 would miss the reference's f32 tolerance),
//   32 x 64 tiles of 256 threads, each thread 2 x 4 outputs, D steps of
//   16, summed over D in order.
//
// 1 bf16, C <= 16 (decode: cap is 8 at up to 8 slots): WMMA (mma.sync)
//   16x16x16 bf16 fragments with f32 sums; 16 x 128 tiles, 4 warps each
//   owning 16 x 32, D steps of 32 double-buffered by cp.async; half of a
//   16-row fragment is padding at C 8.  It streams the weights at ~86% of
//   HBM's rate, which is what decode needs.
//
// 2 bf16, C > 16, where TMA takes the tensors (D and F multiples of 8,
//   so every global stride is a multiple of 16 bytes; 16-byte aligned
//   pointers): wgmma.  A block owns 256 rows of C (four m64 blocks: the
//   whole capacity of a prefill bucket up to 1024 tokens, so each weight
//   tile is read from HBM once; 128 rows where C <= 128) and 128 columns
//   of F, and walks D in steps of 64.  A producer warpgroup's one thread
//   (its registers given to the consumers with setmaxnreg) keeps a ring of
//   four stages full by TMA: the x tile (rows x 64, K-major) and the w
//   tile (64 x 128, two 64-column panels, MN-major), zero past every edge,
//   one full and one empty mbarrier a stage.  Two consumer warpgroups each
//   own two m64 blocks (one where C <= 128; 128 accumulator floats a
//   thread) and issue wgmma m64n128k16 from shared memory on all of them,
//   rows past C included, so that no wgmma sits on a divergent path; w
//   goes through the descriptor's transpose bit.  One wgmma group stays
//   in flight while the next stage is waited for, and a stage is released
//   once the group that read it has completed.  Blocks run F tile
//   fastest, so the blocks of one expert share its x tile through L2.
//   The f32 sums are rounded once to bf16 (to nearest even) and stored
//   from registers.  Shared memory: 4 x (32 + 16) KB.
//
// 3 bf16, C > 16, where TMA cannot take a stride (D or F no multiple of
//   8: the edge case D 100, a 200-byte row of x): WMMA as in path 1 with
//   64 x 128 tiles and 8 warps each owning 32 x 32, tiles by plain loads.
//
// Every output element is one block's own sum: no atomics, and a result
// does not depend on the rest of the batch or on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int BC, int BF, int BD, int WM, int WN>
struct TcTile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpRows = BC / WM;    // rows of C a warp owns
  static constexpr int kWarpCols = BF / WN;    // columns of F a warp owns
  static constexpr int kFragM = kWarpRows / 16;
  static constexpr int kFragN = kWarpCols / 16;
  // Shared rows padded by 8 bf16 (16 bytes): WMMA wants a leading dimension
  // that is a multiple of 8 and fragment pointers 32-byte aligned, which
  // every fragment offset below keeps; the pad spreads rows over banks.
  static constexpr int kXLd = BD + 8;
  static constexpr int kWLd = BF + 8;
  static constexpr int kOLd = BF + 4;          // f32 staging of the output
  static constexpr int kXStage = BC * kXLd;    // bf16 elements a stage
  static constexpr int kWStage = BD * kWLd;
  static constexpr size_t kInBytes = 2 * (kXStage + kWStage) * sizeof(bf16);
  static constexpr size_t kOutBytes = BC * kOLd * sizeof(float);
  static constexpr size_t kSmem = kInBytes > kOutBytes ? kInBytes : kOutBytes;
  static_assert(BC % (16 * WM) == 0 && BF % (16 * WN) == 0 && BD % 16 == 0,
                "tiles are whole fragments");
  static_assert(BD % 8 == 0 && BF % 8 == 0, "16-byte chunks");
  static_assert(kSmem <= 48 * 1024, "within the default shared memory");
};

// One stage: the (BC, BD) tile of x at rows c0.., columns d0.., and the
// (BD, BF) tile of w at rows d0.., columns f0.., zero past every edge.
template <typename Tile, int BC, int BF, int BD, bool kVec>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ xe,
                                           const bf16* __restrict__ we,
                                           bf16* xs, bf16* ws, int c0, int d0,
                                           int f0, int C, int D, int F) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    // D % 8 == 0 and F % 8 == 0: an 8-element chunk is all in or all out.
    constexpr int kXChunks = BC * BD / 8;
    for (int i = tid; i < kXChunks; i += Tile::kThreads) {
      const int r = i / (BD / 8), k = (i % (BD / 8)) * 8;
      const bool ok = c0 + r < C && d0 + k < D;
      hopper::cp_async16(
          xs + r * Tile::kXLd + k,
          ok ? xe + static_cast<size_t>(c0 + r) * D + d0 + k : xe, ok);
    }
    constexpr int kWChunks = BD * BF / 8;
    for (int i = tid; i < kWChunks; i += Tile::kThreads) {
      const int r = i / (BF / 8), k = (i % (BF / 8)) * 8;
      const bool ok = d0 + r < D && f0 + k < F;
      hopper::cp_async16(
          ws + r * Tile::kWLd + k,
          ok ? we + static_cast<size_t>(d0 + r) * F + f0 + k : we, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < BC * BD; i += Tile::kThreads) {
      const int r = i / BD, k = i % BD;
      xs[r * Tile::kXLd + k] =
          (c0 + r < C && d0 + k < D)
              ? xe[static_cast<size_t>(c0 + r) * D + d0 + k] : zero;
    }
    for (int i = tid; i < BD * BF; i += Tile::kThreads) {
      const int r = i / BF, k = i % BF;
      ws[r * Tile::kWLd + k] =
          (d0 + r < D && f0 + k < F)
              ? we[static_cast<size_t>(d0 + r) * F + f0 + k] : zero;
    }
  }
}

template <int BC, int BF, int BD, int WM, int WN, bool kVec>
__global__ void __launch_bounds__(32 * WM * WN)
    gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int C, int D, int F) {
  using Tile = TcTile<BC, BF, BD, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);      // [2][BC][kXLd]
  bf16* ws = xs + 2 * Tile::kXStage;                  // [2][BD][kWLd]
  float* os = reinterpret_cast<float*>(smem_raw);    // [BC][kOLd], at the end

  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BC;
  const int f0 = blockIdx.y * BF;
  const bf16* xe = x + static_cast<size_t>(e) * C * D;
  const bf16* we = w + static_cast<size_t>(e) * D * F;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / WN) * Tile::kWarpRows;
  const int wc = (warp % WN) * Tile::kWarpCols;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[Tile::kFragM][Tile::kFragN];
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  const int n_steps = (D + BD - 1) / BD;
  load_stage<Tile, BC, BF, BD, kVec>(xe, we, xs, ws, c0, 0, f0, C, D, F);
  hopper::cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {
      const int s = (t + 1) & 1;
      load_stage<Tile, BC, BF, BD, kVec>(xe, we, xs + s * Tile::kXStage,
                                         ws + s * Tile::kWStage, c0,
                                         (t + 1) * BD, f0, C, D, F);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();       // step t's tiles have landed
    __syncthreads();
    const bf16* xt = xs + (t & 1) * Tile::kXStage;
    const bf16* wt = ws + (t & 1) * Tile::kWStage;
#pragma unroll
    for (int kk = 0; kk < BD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[Tile::kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[Tile::kFragN];
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
        wmma::load_matrix_sync(a[i], xt + (wr + 16 * i) * Tile::kXLd + kk,
                               Tile::kXLd);
      }
#pragma unroll
      for (int j = 0; j < Tile::kFragN; ++j) {
        wmma::load_matrix_sync(b[j], wt + kk * Tile::kWLd + wc + 16 * j,
                               Tile::kWLd);
      }
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
        for (int j = 0; j < Tile::kFragN; ++j) {
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                  // the stage may be overwritten now
  }

  // Every tile has been read: the input stages become the f32 staging.
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) {
      wmma::store_matrix_sync(os + (wr + 16 * i) * Tile::kOLd + wc + 16 * j,
                              acc[i][j], Tile::kOLd, wmma::mem_row_major);
    }
  }
  __syncthreads();
  bf16* oe = out + static_cast<size_t>(e) * C * F;
  for (int i = threadIdx.x; i < BC * BF; i += Tile::kThreads) {
    const int r = i / BF, k = i % BF;
    if (c0 + r < C && f0 + k < F) {
      oe[static_cast<size_t>(c0 + r) * F + f0 + k] =
          __float2bfloat16(os[r * Tile::kOLd + k]);
    }
  }
}

template <int BC, int BF, int BD, int WM, int WN>
cudaError_t launch_bf16(const bf16* x, const bf16* w, bf16* out, int E, int C,
                        int D, int F, bool vec, cudaStream_t stream) {
  using Tile = TcTile<BC, BF, BD, WM, WN>;
  const dim3 grid((C + BC - 1) / BC, (F + BF - 1) / BF, E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (vec) {
    gmm_bf16_kernel<BC, BF, BD, WM, WN, true>
        <<<grid, Tile::kThreads, Tile::kSmem, stream>>>(x, w, out, C, D, F);
  } else {
    gmm_bf16_kernel<BC, BF, BD, WM, WN, false>
        <<<grid, Tile::kThreads, Tile::kSmem, stream>>>(x, w, out, C, D, F);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 16 x 16
constexpr int kF32BC = 32;
constexpr int kF32BF = 64;
constexpr int kF32BD = 16;

__global__ void __launch_bounds__(kF32Threads)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int C, int D, int F) {
  constexpr int kRows = kF32BC / 16, kCols = kF32BF / 16;
  __shared__ float xs[kF32BC][kF32BD + 1];
  __shared__ float ws[kF32BD][kF32BF];
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * kF32BC;
  const int f0 = blockIdx.y * kF32BF;
  const float* xe = x + static_cast<size_t>(e) * C * D;
  const float* we = w + static_cast<size_t>(e) * D * F;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += kF32BD) {
    for (int i = threadIdx.x; i < kF32BC * kF32BD; i += kF32Threads) {
      const int r = i / kF32BD, k = i % kF32BD;
      xs[r][k] = (c0 + r < C && d0 + k < D)
                     ? xe[static_cast<size_t>(c0 + r) * D + d0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32BD * kF32BF; i += kF32Threads) {
      const int r = i / kF32BF, k = i % kF32BF;
      ws[r][k] = (d0 + r < D && f0 + k < F)
                     ? we[static_cast<size_t>(d0 + r) * F + f0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BD; ++k) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* oe = out + static_cast<size_t>(e) * C * F;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = c0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = f0 + tx + 16 * j;
      if (r < C && k < F) oe[static_cast<size_t>(r) * F + k] = acc[i][j];
    }
  }
}

cudaError_t launch_f32(const float* x, const float* w, float* out, int E,
                       int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((C + kF32BC - 1) / kF32BC, (F + kF32BF - 1) / kF32BF, E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gmm_f32_kernel<<<grid, kF32Threads, 0, stream>>>(x, w, out, C, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, C > 16, TMA-able: wgmma with a TMA ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 256;        // most rows of C a block covers: 4 x m64
constexpr int kBN = 128;        // columns of F
constexpr int kBK = 64;         // D step: one 128-byte swizzle row of x
constexpr int kStages = 4;
constexpr int kThreads = 384;   // warpgroups 0-1 consume, 2 loads
constexpr int kPanelBytes = kBK * 128;         // 64 rows x 64 bf16
constexpr int kXStage = kBM * kBK * 2;         // 32 KB
constexpr int kWStage = 2 * kPanelBytes;       // 64 x 128: 16 KB
constexpr size_t kSmem = 1024 + size_t(kStages) * (kXStage + kWStage);

// MB: m64 blocks a consumer warpgroup owns (2: 256 rows a block; 1: 128
// rows, for C <= 128).  Every warpgroup issues all of its blocks, rows past
// C included (TMA made them zeros), so no wgmma sits on a divergent path.
template <int MB>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     bf16* __restrict__ out, int C, int D, int F,
                     uint32_t x_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = smem;                         // [kStages][rows][128 B]
  unsigned char* ws = xs + kStages * kXStage;       // [kStages][2][64][128 B]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int f0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * 128 * MB;
  const int e = blockIdx.z;
  const int n_steps = (D + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % kStages;
        const int use = t / kStages;
        if (use > 0) hopper::mbar_wait(&empty[s], (use - 1) & 1);
        hopper::mbar_expect_tx(&full[s], x_bytes + kWStage);
        hopper::tma_load_3d(xs + s * kXStage, &xmap, &full[s], t * kBK, c0,
                            e);
        hopper::tma_load_3d(ws + s * kWStage, &wmap, &full[s], f0, t * kBK,
                            e);
        hopper::tma_load_3d(ws + s * kWStage + kPanelBytes, &wmap, &full[s],
                            f0 + 64, t * kBK, e);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // this warpgroup's m64 blocks: MB wg .. MB wg + MB - 1
    const int mb0 = MB * wg;
    float acc[MB][64];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
    }
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t x_addr =
          hopper::smem_u32(xs + s * kXStage) + mb0 * 64 * 128;
      const uint32_t w_addr = hopper::smem_u32(ws + s * kWStage);
#pragma unroll
      for (int i = 0; i < MB; ++i) hopper::fence_regs(acc[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db =
            hopper::desc_sw128(w_addr + kk * 16 * 128, kPanelBytes, 1024);
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          hopper::wgmma_ss_n128<0, 1>(
              acc[i],
              hopper::desc_sw128(x_addr + i * 64 * 128 + kk * 32, 16, 1024),
              db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // the group that read stage t - 1 is done
#pragma unroll
      for (int i = 0; i < MB; ++i) hopper::fence_regs(acc[i]);
      if (t > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % kStages]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MB; ++i) hopper::fence_regs(acc[i]);

    // rows 16 (warp % 4) + lane/4 (+ 8) of each m64 block; column pairs
    const int col0 = f0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c0 + (mb0 + i) * 64 + 16 * (warp % 4) + lane / 4 +
                        8 * h;
        if (row >= C) continue;
        bf16* orow = out + (static_cast<size_t>(e) * C + row) * F;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + 8 * j;
          if (col < F) {   // F is even: the pair is in or out together
            *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
                acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

template <int MB>
cudaError_t configure() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gmm_wgmma_kernel<MB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int MB>
cudaError_t launch_mb(const bf16* x, const bf16* w, bf16* out, int E, int C,
                      int D, int F, cudaStream_t stream) {
  const cudaError_t err = configure<MB>();
  if (err != cudaSuccess) return err;
  // x as (D, C, E), boxes of 64 columns x the rows one block covers
  // (C rounded up to 64, at most 128 MB) x 1 expert; w as (F, D, E), boxes
  // of 64 x 64 x 1
  const int c64 = (C + 63) / 64 * 64;
  const uint32_t rows = static_cast<uint32_t>(c64 < 128 * MB ? c64
                                                             : 128 * MB);
  const uint64_t x_dims[3] = {uint64_t(D), uint64_t(C), uint64_t(E)};
  const uint64_t x_strides[2] = {uint64_t(D) * 2, uint64_t(D) * C * 2};
  const uint32_t x_box[3] = {kBK, rows, 1};
  const uint64_t w_dims[3] = {uint64_t(F), uint64_t(D), uint64_t(E)};
  const uint64_t w_strides[2] = {uint64_t(F) * 2, uint64_t(F) * D * 2};
  const uint32_t w_box[3] = {64, kBK, 1};
  CUtensorMap xmap, wmap;
  if (!hopper::encode_bf16(&xmap, x, 3, x_dims, x_strides, x_box) ||
      !hopper::encode_bf16(&wmap, w, 3, w_dims, w_strides, w_box)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((F + kBN - 1) / kBN, (C + 128 * MB - 1) / (128 * MB), E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gmm_wgmma_kernel<MB><<<grid, kThreads, kSmem, stream>>>(
      xmap, wmap, out, C, D, F, rows * 128);
  return cudaGetLastError();
}

cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  return C <= 128 ? launch_mb<1>(x, w, out, E, C, D, F, stream)
                  : launch_mb<2>(x, w, out, E, C, D, F, stream);
}

}  // namespace tc

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// *path is set before the launch to the path taken (0 f32, 1 bf16 decode,
// 2 bf16 wgmma, 3 bf16 WMMA; see the note at the top).  Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int E,
                              int C, int D, int F, int dtype, void* stream,
                              int* path) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    *path = 0;
    return static_cast<int>(launch_f32(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), E, C, D, F,
                                       st));
  }
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w);
    if (C <= 16) {
      *path = 1;
      return static_cast<int>(
          launch_bf16<16, 128, 32, 1, 4>(xb, wb, ob, E, C, D, F, vec, st));
    }
    if (vec && D > 0 && aligned16(out)) {
      *path = 2;
      return static_cast<int>(tc::launch(xb, wb, ob, E, C, D, F, st));
    }
    *path = 3;
    return static_cast<int>(
        launch_bf16<64, 128, 32, 2, 4>(xb, wb, ob, E, C, D, F, vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
