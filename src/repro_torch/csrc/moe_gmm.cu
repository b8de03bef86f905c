// Grouped matmul, out[e] = x[e] @ w[e], and its two gradient products, for
// Hopper (sm_90a): the MoE expert FFN's contraction.
//
// Replaces the TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py:40 gmm_pallas
//     (pallas_call at :51, body _kernel at :25-37),
// the contraction src/repro/models/moe.py: moe_block spells as
// einsum('ecd,edf->ecf') (three calls per block: gate, up, down), and the
// gradient of that einsum, which the reference takes by autodiff:
//
//   x    (E, C, D)  f32 or bf16, contiguous (the dispatch buffer)
//   w    (E, D, F)  x's dtype, contiguous, row-major (D, F) per expert
//   out  (E, C, F)  x's dtype
//   dX = dY W^T  (E, C, D),  dW = X^T dY  (E, D, F), dY (E, C, F)
// Every product is accumulated in f32 and rounded once to x's dtype.
//
// The TPU kernel walks a sequential grid (E, C/bc, F/bf, D/bd) with the
// contraction axis innermost, carries an f32 accumulator in VMEM scratch
// from one D step to the next, and needs C, D and F to be multiples of its
// 512-wide blocks.  Blocks on this card run in no order, so a block owns
// whole output tiles and loops over the contraction itself; the ragged
// last tiles are zero-filled on the way in and masked (or clipped by the
// TMA store) on the way out, so no size needs padding.
//
// What bounds it: at decode, bytes.  Whatever the routing, a call reads one
// expert matrix, 16 x 6144 x 10752 bf16 = 2.11 GB at dbrx-132b's widths,
// for 2 x 16 x 8 x 6144 x 10752 = 17 GFLOP: 0.63 ms at 3.35 TB/s, about 8
// flops a byte against the ~295 at which the bf16 tensor cores become the
// limit.  At a 700-token prefill (cap 224) a call is 474 GFLOP: 0.48 ms at
// the bf16 peak, under the 0.63 ms of the weights, so a prefill kernel has
// to stream the weights and keep the tensor cores busy at once.  The
// backward at that shape is two such products: dX reads W (2.11 GB), dW
// writes a W-sized gradient (2.11 GB) from a contraction only C = 224
// deep, 1.33 ms of bytes between them.
//
// Forward paths; moe_gmm_launch picks one from the dtype, the shape and
// the alignment before it launches, and reports it:
//
// 0 f32: CUDA-core FMAs (TF32 would miss the reference's f32 tolerance),
//   32 x 64 tiles of 256 threads, each thread 2 x 4 outputs, contraction
//   steps of 16, summed in order.  The kernel reads its operands through
//   strides, so the backward's f32 products (paths 4 and 7) are the same
//   kernel on the untransposed tensors.
//
// 1 bf16, C <= 16 (decode: cap is 8 at up to 8 slots).  Where TMA takes
//   the tensors (D and F multiples of 8, 16-byte aligned x and w,
//   D > 0): wgmma with A and B swapped, out^T = w^T x^T, so that the <= 16
//   tokens are wgmma's N (m64n8k16 at C <= 8, m64n16k16 to 16) and no
//   tensor-core row is padding (a 16-row fragment at C 8 would be half
//   padding).  w^T is the MN-major A (TMA boxes of 64 F columns x 64 D
//   rows, the descriptor's transpose bit); x is the K-major B (C rows
//   of 64 D, zero past C).  Persistent blocks of one consumer warpgroup
//   and one producer warp walk units of (expert, 128 F columns) over
//   all of D, the units dealt in turn, so the blocks running at once
//   read the same D rows of neighbouring columns; the producer's ring
//   of four stages (17 KB each) runs across unit boundaries, so the
//   next unit's loads overlap this one's last products and its store.
//   Bytes in flight: HBM's 3.35 TB/s over 132 SMs is 25 GB/s an SM, so
//   at ~1-2 us of loaded latency an SM needs 25-50 KB of w in flight; a
//   block keeps 4 x 16 KB, and three blocks share an SM (69 KB of
//   shared memory each), ~190 KB, enough that the last units, one block
//   an SM, still stream at the SM's share.  A unit of 128 columns reads
//   256 contiguous bytes a row of w; units of 64 columns read too few,
//   much wider ones leave too few units for the tail.  Elsewhere (the
//   edge shapes) the WMMA 16 x 128 tile: mma.sync 16x16x16 fragments, 4
//   warps each owning 16 x 32, D steps of 32 double-buffered by plain
//   loads.
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
//   8: the edge case D 100, a 200-byte row of x): WMMA as in path 1's edge
//   tile with 64 x 128 tiles and 8 warps each owning 32 x 32, tiles by
//   plain loads through strides.
//
// Backward paths; moe_gmm_backward_launch takes the operands as they lie
// (dY, W and X untransposed, no copies) and reports the path:
//
// 4 dx_f32, 7 dw_f32: path 0's kernel through strides (dX reads W^T with
//   stride F along D; dW reads X^T with stride D along C).
//
// 5 dx_wgmma (bf16, TMA as in path 2): dX = dY W^T is path 2's kernel with
//   M = C, K = F, N = D: dY is its K-major A, and W, whose rows are D and
//   whose contiguous axis is F = K, is a K-major B read as it lies (128
//   rows of 64 F a TMA box), the descriptor's transpose bit off.
//
// 8 dw_wgmma (bf16, TMA as in path 2): dW = X^T dY with M = D, N = F and a
//   contraction only K = C deep (224 at dbrx-132b's prefill).  Both
//   operands are MN-major as they lie: X^T is A through TMA boxes of 64 D
//   columns x 64 C rows and the transpose bit (bf16 allows it), dY is B as
//   the forward reads w.  Per output tile there is little arithmetic and a
//   large store (256 x 128 bf16 = 64 KB for 14.7 MFLOP), so the kernel is
//   built around the store: persistent blocks, one an SM, each walking
//   units of (expert, 256 rows of D, a range of 128-column F tiles).  A
//   unit's X^T panel (256 x C) is loaded once and stays in shared memory
//   while the unit's F tiles stream dY through a ring of 64-row chunks,
//   so each F tile reads only C x 128 of dY (from L2: the 24 row blocks of
//   an expert run side by side) and L2 carries C / 256 of the bytes
//   written instead of C / 256 + C / 128.  The producer's ring runs across
//   tile and unit boundaries, so the next tile's dY arrives during this
//   tile's epilogue.  The epilogue goes registers -> shared memory
//   (stmatrix, in the 128-byte swizzled layout, conflict-free) -> TMA
//   store (cp.async.bulk.tensor, clipped at D and F), a 128 x 64 half of
//   each consumer warpgroup's 128 x 128 at a time; the second half waits
//   only until the first one's store has read the buffer, and the stores
//   drain while the next tile computes.  Where C > 256 the X^T panel does
//   not fit and is brought pass by pass (256 C rows a pass) for every
//   tile.  Shared memory: 32 KB of store buffers, 4 x 16 KB of dY ring,
//   4 x 32 KB of X^T at most: 225 KB.  At dbrx-132b's prefill shape on an
//   H100 (tools/gmm_ab.py times the parts) the stores alone take ~0.80 ms
//   and the products alone ~0.79 (0.48 at the bf16 peak); they overlap to
//   ~0.96 ms, 2.2 TB/s of dW written.
//
// 6 dx_wmma, 9 dw_wmma (bf16, where TMA cannot take the tensors): path 3's
//   kernel through strides.
//
// Every output element is one block's own sum, over the contraction in a
// fixed order: no split-K, no atomics, and a result does not depend on the
// rest of the batch or on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Element (m, k) of expert e's A is a[e * ae + m * am + k * ak]; element
// (k, n) of its B is b[e * be + k * bk + n * bn].  The output is (E, M, N),
// contiguous.
struct Strides {
  long long ae, am, ak, be, bk, bn;
};

// x @ w, dY @ W^T and X^T @ dY as (A, B) strides of their untransposed
// operands: x (E, C, D), w (E, D, F), dY (E, C, F).
Strides forward_strides(int C, int D, int F) {
  return {1LL * C * D, D, 1, 1LL * D * F, F, 1};
}
Strides dx_strides(int C, int D, int F) {
  return {1LL * C * F, F, 1, 1LL * D * F, 1, F};
}
Strides dw_strides(int C, int D, int F) {
  return {1LL * C * D, 1, D, 1LL * C * F, F, 1};
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

// Raises Kernel's dynamic shared-memory limit to `bytes`, once a device.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// bf16: WMMA tiles (path 1's edge shapes, paths 3, 6 and 9)
// ---------------------------------------------------------------------------

template <int BC, int BF, int BD, int WM, int WN>
struct TcTile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpRows = BC / WM;    // output rows a warp owns
  static constexpr int kWarpCols = BF / WN;    // columns a warp owns
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

// One stage: the (BC, BD) tile of A at rows m0.., columns k0.., and the
// (BD, BF) tile of B at rows k0.., columns n0.., zero past every edge.
// kVec: A and B are row-major (ak = bn = 1) with rows of whole 16-byte
// chunks (am and bk multiples of 8, aligned bases): cp.async.  Otherwise
// plain loads through the strides, the unit-stride axis fastest.
template <typename Tile, int BC, int BF, int BD, bool kVec>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ ae,
                                           const bf16* __restrict__ be,
                                           bf16* xs, bf16* ws, int m0, int k0,
                                           int n0, int M, int K, int N,
                                           const Strides& s) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kXChunks = BC * BD / 8;
    for (int i = tid; i < kXChunks; i += Tile::kThreads) {
      const int r = i / (BD / 8), k = (i % (BD / 8)) * 8;
      const bool ok = m0 + r < M && k0 + k < K;
      hopper::cp_async16(
          xs + r * Tile::kXLd + k,
          ok ? ae + (m0 + r) * s.am + k0 + k : ae, ok);
    }
    constexpr int kWChunks = BD * BF / 8;
    for (int i = tid; i < kWChunks; i += Tile::kThreads) {
      const int r = i / (BF / 8), k = (i % (BF / 8)) * 8;
      const bool ok = k0 + r < K && n0 + k < N;
      hopper::cp_async16(
          ws + r * Tile::kWLd + k,
          ok ? be + (k0 + r) * s.bk + n0 + k : be, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < BC * BD; i += Tile::kThreads) {
      const int r = s.ak == 1 ? i / BD : i % BC;
      const int k = s.ak == 1 ? i % BD : i / BC;
      xs[r * Tile::kXLd + k] =
          (m0 + r < M && k0 + k < K)
              ? ae[(m0 + r) * s.am + (k0 + k) * s.ak] : zero;
    }
    for (int i = tid; i < BD * BF; i += Tile::kThreads) {
      const int r = s.bn == 1 ? i / BF : i % BD;
      const int k = s.bn == 1 ? i % BF : i / BD;
      ws[r * Tile::kWLd + k] =
          (k0 + r < K && n0 + k < N)
              ? be[(k0 + r) * s.bk + (n0 + k) * s.bn] : zero;
    }
  }
}

template <int BC, int BF, int BD, int WM, int WN, bool kVec>
__global__ void __launch_bounds__(32 * WM * WN)
    gmm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    bf16* __restrict__ out, int M, int K, int N, Strides s) {
  using Tile = TcTile<BC, BF, BD, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);      // [2][BC][kXLd]
  bf16* ws = xs + 2 * Tile::kXStage;                  // [2][BD][kWLd]
  float* os = reinterpret_cast<float*>(smem_raw);    // [BC][kOLd], at the end

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BC;
  const int n0 = blockIdx.y * BF;
  const bf16* ae = a + e * s.ae;
  const bf16* be = b + e * s.be;
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

  const int n_steps = (K + BD - 1) / BD;
  load_stage<Tile, BC, BF, BD, kVec>(ae, be, xs, ws, m0, 0, n0, M, K, N, s);
  hopper::cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {
      const int st = (t + 1) & 1;
      load_stage<Tile, BC, BF, BD, kVec>(ae, be, xs + st * Tile::kXStage,
                                         ws + st * Tile::kWStage, m0,
                                         (t + 1) * BD, n0, M, K, N, s);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();       // step t's tiles have landed
    __syncthreads();
    const bf16* xt = xs + (t & 1) * Tile::kXStage;
    const bf16* wt = ws + (t & 1) * Tile::kWStage;
#pragma unroll
    for (int kk = 0; kk < BD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[Tile::kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[Tile::kFragN];
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
        wmma::load_matrix_sync(fa[i], xt + (wr + 16 * i) * Tile::kXLd + kk,
                               Tile::kXLd);
      }
#pragma unroll
      for (int j = 0; j < Tile::kFragN; ++j) {
        wmma::load_matrix_sync(fb[j], wt + kk * Tile::kWLd + wc + 16 * j,
                               Tile::kWLd);
      }
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
        for (int j = 0; j < Tile::kFragN; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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
  bf16* oe = out + static_cast<size_t>(e) * M * N;
  for (int i = threadIdx.x; i < BC * BF; i += Tile::kThreads) {
    const int r = i / BF, k = i % BF;
    if (m0 + r < M && n0 + k < N) {
      oe[static_cast<size_t>(m0 + r) * N + n0 + k] =
          __float2bfloat16(os[r * Tile::kOLd + k]);
    }
  }
}

template <int BC, int BF, int BD, int WM, int WN>
cudaError_t launch_bf16(const bf16* a, const bf16* b, bf16* out, int E, int M,
                        int K, int N, const Strides& s, bool vec,
                        cudaStream_t stream) {
  using Tile = TcTile<BC, BF, BD, WM, WN>;
  const dim3 grid((M + BC - 1) / BC, (N + BF - 1) / BF, E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (vec) {
    gmm_bf16_kernel<BC, BF, BD, WM, WN, true>
        <<<grid, Tile::kThreads, Tile::kSmem, stream>>>(a, b, out, M, K, N, s);
  } else {
    gmm_bf16_kernel<BC, BF, BD, WM, WN, false>
        <<<grid, Tile::kThreads, Tile::kSmem, stream>>>(a, b, out, M, K, N, s);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (paths 0, 4 and 7)
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 16 x 16
constexpr int kF32BC = 32;
constexpr int kF32BF = 64;
constexpr int kF32BD = 16;

__global__ void __launch_bounds__(kF32Threads)
    gmm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int M, int K, int N, Strides s) {
  constexpr int kRows = kF32BC / 16, kCols = kF32BF / 16;
  // padded by one float, so that the strided loads (the contraction axis
  // fastest) and the inner loop's reads are both free of bank conflicts
  __shared__ float xs[kF32BC][kF32BD + 1];
  __shared__ float ws[kF32BD][kF32BF + 1];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kF32BC;
  const int n0 = blockIdx.y * kF32BF;
  const float* ae = a + e * s.ae;
  const float* be = b + e * s.be;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kF32BD) {
    for (int i = threadIdx.x; i < kF32BC * kF32BD; i += kF32Threads) {
      const int r = s.ak == 1 ? i / kF32BD : i % kF32BC;
      const int k = s.ak == 1 ? i % kF32BD : i / kF32BC;
      xs[r][k] = (m0 + r < M && k0 + k < K)
                     ? ae[(m0 + r) * s.am + (k0 + k) * s.ak] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32BD * kF32BF; i += kF32Threads) {
      const int r = s.bn == 1 ? i / kF32BF : i % kF32BD;
      const int k = s.bn == 1 ? i % kF32BF : i / kF32BD;
      ws[r][k] = (k0 + r < K && n0 + k < N)
                     ? be[(k0 + r) * s.bk + (n0 + k) * s.bn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BD; ++k) {
      float fa[kRows], fb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) fa[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) fb[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = n0 + tx + 16 * j;
      if (r < M && k < N) oe[static_cast<size_t>(r) * N + k] = acc[i][j];
    }
  }
}

cudaError_t launch_f32(const float* a, const float* b, float* out, int E,
                       int M, int K, int N, const Strides& s,
                       cudaStream_t stream) {
  const dim3 grid((M + kF32BC - 1) / kF32BC, (N + kF32BF - 1) / kF32BF, E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gmm_f32_kernel<<<grid, kF32Threads, 0, stream>>>(a, b, out, M, K, N, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, TMA-able: wgmma with a TMA ring (paths 2 and 5)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 256;        // most output rows a block covers: 4 x m64
constexpr int kBN = 128;        // output columns
constexpr int kBK = 64;         // contraction step: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;   // warpgroups 0-1 consume, 2 loads
constexpr int kPanelBytes = kBK * 128;         // 64 rows x 64 bf16
constexpr int kAStage = kBM * kBK * 2;         // 32 KB
constexpr int kBStage = 2 * kPanelBytes;       // 64 x 128: 16 KB
constexpr size_t kSmem = 1024 + size_t(kStages) * (kAStage + kBStage);

// out (E, M, N) = A (E, M, K) B.  A is K-major (x, dY).  TB = 1: B is
// (E, K, N), MN-major (w in the forward); TB = 0: B is given as (E, N, K),
// K-major (W for dX = dY W^T), 128 rows of 64 k a TMA box.
// MB: m64 blocks a consumer warpgroup owns (2: 256 rows a block; 1: 128
// rows, for M <= 128).  Every warpgroup issues all of its blocks, rows past
// M included (TMA made them zeros), so no wgmma sits on a divergent path.
template <int MB, int TB>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     bf16* __restrict__ out, int M, int K, int N,
                     uint32_t a_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = align1024(smem_raw);           // [kStages][rows][128 B]
  unsigned char* bs = as + kStages * kAStage;        // [kStages][16 KB]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * 128 * MB;
  const int e = blockIdx.z;
  const int n_steps = (K + kBK - 1) / kBK;
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
        hopper::mbar_expect_tx(&full[s], a_bytes + kBStage);
        hopper::tma_load_3d(as + s * kAStage, &amap, &full[s], t * kBK, m0,
                            e);
        if constexpr (TB == 1) {
          hopper::tma_load_3d(bs + s * kBStage, &bmap, &full[s], n0,
                              t * kBK, e);
          hopper::tma_load_3d(bs + s * kBStage + kPanelBytes, &bmap,
                              &full[s], n0 + 64, t * kBK, e);
        } else {
          hopper::tma_load_3d(bs + s * kBStage, &bmap, &full[s], t * kBK,
                              n0, e);
        }
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
      const uint32_t a_addr =
          hopper::smem_u32(as + s * kAStage) + mb0 * 64 * 128;
      const uint32_t b_addr = hopper::smem_u32(bs + s * kBStage);
#pragma unroll
      for (int i = 0; i < MB; ++i) hopper::fence_regs(acc[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db =
            TB == 1 ? hopper::desc_sw128(b_addr + kk * 16 * 128, kPanelBytes,
                                         1024)
                    : hopper::desc_sw128(b_addr + kk * 32, 16, 1024);
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          hopper::wgmma_ss_n128<0, TB>(
              acc[i],
              hopper::desc_sw128(a_addr + i * 64 * 128 + kk * 32, 16, 1024),
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
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (mb0 + i) * 64 + 16 * (warp % 4) + lane / 4 +
                        8 * h;
        if (row >= M) continue;
        bf16* orow = out + (static_cast<size_t>(e) * M + row) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + 8 * j;
          if (col < N) {   // N is even: the pair is in or out together
            *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
                acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// a (E, M, K); b (E, K, N) for TB = 1, (E, N, K) for TB = 0; out (E, M, N).
template <int MB, int TB>
cudaError_t launch_mb(const bf16* a, const bf16* b, bf16* out, int E, int M,
                      int K, int N, cudaStream_t stream) {
  const cudaError_t err = allow_smem<gmm_wgmma_kernel<MB, TB>>(kSmem);
  if (err != cudaSuccess) return err;
  // a as (K, M, E), boxes of 64 columns x the rows one block covers
  // (M rounded up to 64, at most 128 MB) x 1 expert
  const int m64 = (M + 63) / 64 * 64;
  const uint32_t rows = static_cast<uint32_t>(m64 < 128 * MB ? m64
                                                             : 128 * MB);
  const uint64_t a_dims[3] = {uint64_t(K), uint64_t(M), uint64_t(E)};
  const uint64_t a_strides[2] = {uint64_t(K) * 2, uint64_t(K) * M * 2};
  const uint32_t a_box[3] = {kBK, rows, 1};
  // b as (N, K, E), boxes of 64 x 64 x 1 (two a stage); or as (K, N, E),
  // boxes of 64 k x 128 rows x 1
  const uint64_t b_dims[3] = {uint64_t(TB ? N : K), uint64_t(TB ? K : N),
                              uint64_t(E)};
  const uint64_t b_strides[2] = {uint64_t(TB ? N : K) * 2,
                                 uint64_t(K) * N * 2};
  const uint32_t b_box[3] = {64, TB ? 64u : 128u, 1};
  CUtensorMap amap, bmap;
  if (!hopper::encode_bf16(&amap, a, 3, a_dims, a_strides, a_box) ||
      !hopper::encode_bf16(&bmap, b, 3, b_dims, b_strides, b_box)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + 128 * MB - 1) / (128 * MB), E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gmm_wgmma_kernel<MB, TB><<<grid, kThreads, kSmem, stream>>>(
      amap, bmap, out, M, K, N, rows * 128);
  return cudaGetLastError();
}

template <int TB>
cudaError_t launch(const bf16* a, const bf16* b, bf16* out, int E, int M,
                   int K, int N, cudaStream_t stream) {
  return M <= 128 ? launch_mb<1, TB>(a, b, out, E, M, K, N, stream)
                  : launch_mb<2, TB>(a, b, out, E, M, K, N, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16, C <= 16, TMA-able: the decode product out^T = w^T x^T (path 1)
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kPanels = 2;             // 64-column panels of F a unit
constexpr int kStages = 4;
constexpr int kThreads = 160;          // warpgroup 0 consumes, warp 4 loads
constexpr int kPanelBytes = 64 * 128;  // 64 D rows x 64 F columns of w
constexpr int kWBytes = kPanels * kPanelBytes;

template <int NT>                      // wgmma's N: 8 (C <= 8) or 16
struct Cfg {
  static constexpr int kXBytes = NT * 128;   // NT rows of 64 D of x
  static constexpr size_t kSmem =
      1024 + size_t(kStages) * (kWBytes + kXBytes);
};

// Units of (expert, 64 kPanels columns of F) over all of D, u = e * f_tiles
// + f tile, dealt to the persistent blocks in turn.
template <int NT>
__global__ void __launch_bounds__(kThreads)
    gmm_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      bf16* __restrict__ out, int C, int D, int F,
                      int n_units) {
  constexpr int kXBytes = Cfg<NT>::kXBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = align1024(smem_raw);           // [kStages][kWBytes]
  unsigned char* xs = ws + kStages * kWBytes;        // [kStages][NT][128 B]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int f_tiles = (F + 64 * kPanels - 1) / (64 * kPanels);
  const int n_steps = (D + 63) / 64;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      int t = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int e = u / f_tiles, f0 = (u % f_tiles) * 64 * kPanels;
        for (int k = 0; k < n_steps; ++k, ++t) {
          const int s = t % kStages;
          if (t >= kStages) {
            hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
          }
          hopper::mbar_expect_tx(&full[s], kWBytes + kXBytes);
#pragma unroll
          for (int p = 0; p < kPanels; ++p) {
            hopper::tma_load_3d(ws + s * kWBytes + p * kPanelBytes, &wmap,
                                &full[s], f0 + 64 * p, k * 64, e);
          }
          hopper::tma_load_3d(xs + s * kXBytes, &xmap, &full[s], k * 64, 0,
                              e);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  int t = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int e = u / f_tiles, f0 = (u % f_tiles) * 64 * kPanels;
    float acc[kPanels][NT / 2];
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[p][i] = 0.f;
    }
    for (int k = 0; k < n_steps; ++k, ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t w_addr = hopper::smem_u32(ws + s * kWBytes);
      const uint32_t x_addr = hopper::smem_u32(xs + s * kXBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) hopper::fence_regs(acc[p]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // B = x^T: NT rows of x, K-major
        const uint64_t db = hopper::desc_sw128(x_addr + kk * 32, 16, 1024);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          // A = w^T: 64 F columns (M) x 16 D rows (k) of an MN-major panel
          const uint64_t da = hopper::desc_sw128(
              w_addr + p * kPanelBytes + kk * 16 * 128, kPanelBytes, 1024);
          if constexpr (NT == 8) {
            hopper::wgmma_ss_n8<1, 0>(acc[p], da, db, 1);
          } else {
            hopper::wgmma_ss_n16<1, 0>(acc[p], da, db, 1);
          }
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // the group that read stage t - 1 is done
#pragma unroll
      for (int p = 0; p < kPanels; ++p) hopper::fence_regs(acc[p]);
      if (k > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % kStages]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < kPanels; ++p) hopper::fence_regs(acc[p]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % kStages]);

    // acc[p][4 j + q]: row f0 + 64 p + 16 warp + lane/4 + 8 (q/2) of out^T
    // (an F column), column 8 j + 2 (lane%4) + q%2 (a token row c)
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) {
        const int q = i % 4;
        const int f = f0 + 64 * p + 16 * warp + lane / 4 + 8 * (q / 2);
        const int c = 8 * (i / 4) + 2 * (lane % 4) + q % 2;
        if (f < F && c < C) {
          out[(static_cast<size_t>(e) * C + c) * F + f] =
              __float2bfloat16(acc[p][i]);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_nt(const bf16* x, const bf16* w, bf16* out, int E, int C,
                      int D, int F, cudaStream_t stream) {
  constexpr size_t kSmem = Cfg<NT>::kSmem;
  cudaError_t err = allow_smem<gmm_decode_kernel<NT>>(kSmem);
  if (err != cudaSuccess) return err;
  static int per_sm[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], gmm_decode_kernel<NT>, kThreads, kSmem);
    if (err != cudaSuccess) return err;
  }
  // w as (F, D, E), boxes of 64 x 64 x 1; x as (D, C, E), boxes of 64 x NT
  // x 1 (rows past C arrive as zeros)
  const uint64_t w_dims[3] = {uint64_t(F), uint64_t(D), uint64_t(E)};
  const uint64_t w_strides[2] = {uint64_t(F) * 2, uint64_t(F) * D * 2};
  const uint32_t w_box[3] = {64, 64, 1};
  const uint64_t x_dims[3] = {uint64_t(D), uint64_t(C), uint64_t(E)};
  const uint64_t x_strides[2] = {uint64_t(D) * 2, uint64_t(D) * C * 2};
  const uint32_t x_box[3] = {64, uint32_t(NT), 1};
  CUtensorMap wmap, xmap;
  if (!hopper::encode_bf16(&wmap, w, 3, w_dims, w_strides, w_box) ||
      !hopper::encode_bf16(&xmap, x, 3, x_dims, x_strides, x_box)) {
    return cudaErrorInvalidValue;
  }
  const long long units = 1LL * E * ((F + 64 * kPanels - 1) / (64 * kPanels));
  const long long cap = 1LL * (per_sm[dev] > 0 ? per_sm[dev] : 1) * sm_count();
  if (units > 0x7fffffffLL || cap < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(units < cap ? units : cap);
  gmm_decode_kernel<NT><<<grid, kThreads, kSmem, stream>>>(
      wmap, xmap, out, C, D, F, static_cast<int>(units));
  return cudaGetLastError();
}

cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  return C <= 8 ? launch_nt<8>(x, w, out, E, C, D, F, stream)
                : launch_nt<16>(x, w, out, E, C, D, F, stream);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// bf16, TMA-able: dW = X^T dY (path 8)
// ---------------------------------------------------------------------------

namespace dw {

constexpr int kBM = 256;          // rows of dW (D) a tile: 4 m64 panels
constexpr int kBN = 128;          // columns of dW (F) a tile
constexpr int kKC = 64;           // C rows a chunk (one TMA box)
constexpr int kPass = 256;        // most C rows of X^T held at once
constexpr int kStages = 4;        // ring of dY chunks
constexpr int kThreads = 384;     // warpgroups 0-1 consume, 2 loads
constexpr int kChunkBytes = kKC * 128;          // 64 rows of 64 columns: 8 KB
constexpr int kBStage = 2 * kChunkBytes;        // 64 C rows x 128 F: 16 KB
constexpr int kOutBytes = 128 * 128;            // 128 rows x 64 columns
constexpr size_t smem_bytes(int pass_rows) {
  return 1024 + 2 * size_t(kOutBytes) + size_t(kStages) * kBStage +
         4 * size_t(pass_rows) * 128;
}
constexpr size_t kMaxSmem = smem_bytes(kPass);

// u = (e * n_splits + split) * m_tiles + m tile: the m tiles of one (e,
// split) are consecutive, so the blocks running at once read the same dY
// columns and share them through L2.
struct Unit {
  int e, m0, nt0, nt1;
};

__device__ __forceinline__ Unit unit_of(int u, int m_tiles, int n_splits,
                                        int tiles_per_unit, int n_tiles) {
  const int r = u / m_tiles;
  const int split = r % n_splits;
  const int nt0 = split * tiles_per_unit;
  const int nt1 = nt0 + tiles_per_unit < n_tiles ? nt0 + tiles_per_unit
                                                 : n_tiles;
  return {r / n_splits, (u % m_tiles) * kBM, nt0, nt1};
}

__global__ void __launch_bounds__(kThreads, 1)
    gmm_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap dymap,
                  const __grid_constant__ CUtensorMap omap, int C,
                  int m_tiles, int n_tiles, int n_splits, int tiles_per_unit,
                  int n_units, int pass_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* os = align1024(smem_raw);            // [2][128][128 B]
  unsigned char* bs = os + 2 * kOutBytes;           // [kStages][2][64][128 B]
  unsigned char* as = bs + kStages * kBStage;         // [4][pass_rows][128 B]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(8) uint64_t a_full, a_empty;

  const int n_passes = (C + kPass - 1) / kPass;
  const bool resident = n_passes == 1;   // X^T loaded once a unit
  const int panel = pass_rows * 128;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::mbar_init(&a_full, 1);
    hopper::mbar_init(&a_empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int t = 0, a_use = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit w = unit_of(u, m_tiles, n_splits, tiles_per_unit, n_tiles);
      for (int nt = w.nt0; nt < w.nt1; ++nt) {
        for (int p = 0; p < n_passes; ++p) {
          const int k0 = p * kPass;
          const int rows = C - k0 < kPass ? C - k0 : kPass;
          const int chunks = (rows + kKC - 1) / kKC;
          if (!resident || nt == w.nt0) {
            if (a_use > 0) hopper::mbar_wait(&a_empty, (a_use - 1) & 1);
            hopper::mbar_expect_tx(&a_full, 4 * chunks * kChunkBytes);
            for (int i = 0; i < 4; ++i) {
              for (int q = 0; q < chunks; ++q) {
                hopper::tma_load_3d(as + i * panel + q * kChunkBytes, &xmap,
                                    &a_full, w.m0 + 64 * i, k0 + kKC * q,
                                    w.e);
              }
            }
            ++a_use;
          }
          for (int q = 0; q < chunks; ++q, ++t) {
            const int s = t % kStages;
            if (t >= kStages) {
              hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
            }
            hopper::mbar_expect_tx(&full[s], kBStage);
            hopper::tma_load_3d(bs + s * kBStage, &dymap, &full[s],
                                nt * kBN, k0 + kKC * q, w.e);
            hopper::tma_load_3d(bs + s * kBStage + kChunkBytes, &dymap,
                                &full[s], nt * kBN + 64, k0 + kKC * q, w.e);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = threadIdx.x / 32;      // 0-7
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* out_s = os + wg * kOutBytes;
  int t = 0, a_use = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit w = unit_of(u, m_tiles, n_splits, tiles_per_unit, n_tiles);
    for (int nt = w.nt0; nt < w.nt1; ++nt) {
      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
      }
      int pending = -1;   // the stage whose last reader is still in flight
      for (int p = 0; p < n_passes; ++p) {
        const int rows = C - p * kPass < kPass ? C - p * kPass : kPass;
        const int chunks = (rows + kKC - 1) / kKC;
        if (!resident || nt == w.nt0) hopper::mbar_wait(&a_full, a_use & 1);
        // this warpgroup's panels: 2 wg and 2 wg + 1
        const uint32_t a_addr = hopper::smem_u32(as) + 2 * wg * panel;
        for (int q = 0; q < chunks; ++q, ++t) {
          const int s = t % kStages;
          hopper::mbar_wait(&full[s], (t / kStages) & 1);
          const uint32_t b_addr = hopper::smem_u32(bs + s * kBStage);
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKC / 16; ++kk) {
            const uint64_t db =
                hopper::desc_sw128(b_addr + kk * 16 * 128, kChunkBytes, 1024);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              hopper::wgmma_ss_n128<1, 1>(
                  acc[i],
                  hopper::desc_sw128(a_addr + i * panel + q * kChunkBytes +
                                         kk * 16 * 128,
                                     panel, 1024),
                  db, 1);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();   // the group that read `pending` is done
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          if (pending >= 0) {
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[pending]);
          }
          pending = s;
        }
        if (!resident || nt == w.nt1 - 1) {
          // the last products that read this X^T are done before the
          // producer overwrites it
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&a_empty);
          ++a_use;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      if (pending >= 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[pending]);
      }

      // Epilogue: this warpgroup's 128 x 128 a 64-column half at a time
      // into its buffer in the store's swizzled layout (stmatrix: lane l
      // gives row l % 8 of 8 x 8 block l / 8), each half once the store
      // before it has read the buffer, then one TMA store.
      const int row0 = w.m0 + 128 * wg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (leader) hopper::tma_store_wait_read<0>();
        hopper::named_barrier_sync(1 + wg, 128);
        const int blk = lane / 8;             // (column block, row half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 64 * i + 16 * (warp % 4) + 8 * (blk % 2) + lane % 8;
#pragma unroll
          for (int jp = 4 * half; jp < 4 * half + 4; ++jp) {
            const int jj = 2 * jp + blk / 2;  // this lane's column block
            hopper::stmatrix_x4(
                out_s + r * 128 + (((jj % 8) ^ (r % 8)) << 4),
                hopper::pack_bf16(acc[i][8 * jp], acc[i][8 * jp + 1]),
                hopper::pack_bf16(acc[i][8 * jp + 2], acc[i][8 * jp + 3]),
                hopper::pack_bf16(acc[i][8 * jp + 4], acc[i][8 * jp + 5]),
                hopper::pack_bf16(acc[i][8 * jp + 6], acc[i][8 * jp + 7]));
          }
        }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1 + wg, 128);
        if (leader) {
          hopper::tma_store_3d(&omap, out_s, nt * kBN + 64 * half, row0,
                               w.e);
          hopper::tma_store_commit();
        }
      }
    }
  }
  if (leader) hopper::tma_store_wait<0>();
}

// x (E, C, D), dy (E, C, F) -> dw (E, D, F); C > 0, D and F multiples of 8.
cudaError_t launch(const bf16* x, const bf16* dy, bf16* dwt, int E, int C,
                   int D, int F, cudaStream_t stream) {
  cudaError_t err = allow_smem<gmm_dw_kernel>(kMaxSmem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (D + kBM - 1) / kBM;
  const int n_tiles = (F + kBN - 1) / kBN;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  // enough units that every SM has two or more (the tail is at most one
  // unit an SM), none smaller than it must be
  const long long base = 1LL * E * m_tiles;
  long long splits = (2LL * sms + base - 1) / base;
  if (splits > n_tiles) splits = n_tiles;
  if (splits < 1) splits = 1;
  const int tiles_per_unit =
      static_cast<int>((n_tiles + splits - 1) / splits);
  const int n_splits = (n_tiles + tiles_per_unit - 1) / tiles_per_unit;
  const long long units = base * n_splits;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int pass_rows =
      C >= kPass ? kPass : (C + kKC - 1) / kKC * kKC;
  // x as (D, C, E) and dy as (F, C, E), boxes of 64 x 64 x 1; dw as (F, D,
  // E), store boxes of 64 x 128 x 1
  const uint64_t x_dims[3] = {uint64_t(D), uint64_t(C), uint64_t(E)};
  const uint64_t x_strides[2] = {uint64_t(D) * 2, uint64_t(D) * C * 2};
  const uint64_t dy_dims[3] = {uint64_t(F), uint64_t(C), uint64_t(E)};
  const uint64_t dy_strides[2] = {uint64_t(F) * 2, uint64_t(F) * C * 2};
  const uint32_t in_box[3] = {64, kKC, 1};
  const uint64_t o_dims[3] = {uint64_t(F), uint64_t(D), uint64_t(E)};
  const uint64_t o_strides[2] = {uint64_t(F) * 2, uint64_t(F) * D * 2};
  const uint32_t o_box[3] = {64, 128, 1};
  CUtensorMap xmap, dymap, omap;
  if (!hopper::encode_bf16(&xmap, x, 3, x_dims, x_strides, in_box) ||
      !hopper::encode_bf16(&dymap, dy, 3, dy_dims, dy_strides, in_box) ||
      !hopper::encode_bf16(&omap, dwt, 3, o_dims, o_strides, o_box)) {
    return cudaErrorInvalidValue;
  }
  const int grid = static_cast<int>(units < sms ? units : sms);
  gmm_dw_kernel<<<grid, kThreads, smem_bytes(pass_rows), stream>>>(
      xmap, dymap, omap, C, m_tiles, n_tiles, n_splits, tiles_per_unit,
      static_cast<int>(units), pass_rows);
  return cudaGetLastError();
}

}  // namespace dw

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
  const Strides s = forward_strides(C, D, F);
  if (dtype == 0) {
    *path = 0;
    return static_cast<int>(launch_f32(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), E, C, D, F,
                                       s, st));
  }
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w);
    if (C <= 16) {
      *path = 1;
      if (vec && D > 0) {
        return static_cast<int>(dec::launch(xb, wb, ob, E, C, D, F, st));
      }
      return static_cast<int>(launch_bf16<16, 128, 32, 1, 4>(
          xb, wb, ob, E, C, D, F, s, vec, st));
    }
    if (vec && D > 0 && aligned16(out)) {
      *path = 2;
      return static_cast<int>(tc::launch<1>(xb, wb, ob, E, C, D, F, st));
    }
    *path = 3;
    return static_cast<int>(launch_bf16<64, 128, 32, 2, 4>(
        xb, wb, ob, E, C, D, F, s, vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's two products, on the operands as they lie.  which 0: dX =
// dY W^T, a = dY (E, C, F), b = W (E, D, F), out = dX (E, C, D); which 1:
// dW = X^T dY, a = X (E, C, D), b = dY (E, C, F), out = dW (E, D, F).
// *path is set before the launch: 4 dx_f32, 5 dx_wgmma, 6 dx_wmma, 7
// dw_f32, 8 dw_wgmma, 9 dw_wmma (see the note at the top).  Returns the
// CUDA error of the launch.
extern "C" int moe_gmm_backward_launch(int which, const void* a,
                                       const void* b, void* out, int E,
                                       int C, int D, int F, int dtype,
                                       void* stream, int* path) {
  if (E <= 0 || C < 0 || D <= 0 || F <= 0 || (which != 0 && which != 1) ||
      (dtype != 0 && dtype != 1) || (which == 0 && C == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (M, K, N) of the product and its operands' strides
  const int M = which == 0 ? C : D, K = which == 0 ? F : C;
  const int N = which == 0 ? D : F;
  const Strides s = which == 0 ? dx_strides(C, D, F) : dw_strides(C, D, F);
  if (dtype == 0) {
    *path = which == 0 ? 4 : 7;
    return static_cast<int>(launch_f32(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<float*>(out), E, M, K, N,
                                       s, st));
  }
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  bf16* ob = static_cast<bf16*>(out);
  const bool tma = D % 8 == 0 && F % 8 == 0 && C > 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out);
  if (tma) {
    *path = which == 0 ? 5 : 8;
    return static_cast<int>(
        which == 0 ? tc::launch<0>(ab, bb, ob, E, C, F, D, st)
                   : dw::launch(ab, bb, ob, E, C, D, F, st));
  }
  *path = which == 0 ? 6 : 9;
  return static_cast<int>(launch_bf16<64, 128, 32, 2, 4>(
      ab, bb, ob, E, M, K, N, s, false, st));
}
