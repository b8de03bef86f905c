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
// block owns a (C tile, F tile) of one expert and loops over D itself,
// double-buffering its tiles in shared memory; the ragged last tiles of C,
// D and F are zero-filled on the way in and masked on the way out, so no
// size needs padding.
//
// bf16: the tensor cores through WMMA (mma.sync) 16x16x16 bf16 fragments
// with f32 accumulators.  Two tile shapes:
//   * C <= 16 (decode: cap is 8 at up to 8 slots): 16 x 128 tiles, 4 warps
//     each owning 16 x 32; half of a 16-row fragment is padding at C 8.
//   * C > 16 (prefill): 64 x 128 tiles, 8 warps each owning 32 x 32.
// D steps of 32.  Where D and F are multiples of 8 and both pointers are
// 16-byte aligned, tiles arrive by cp.async (16 bytes a thread, zero-fill
// past the edge), one tile ahead of the products; otherwise by plain loads.
// The f32 sums go through shared memory to the output, rounded to bf16 to
// nearest even (as torch's .to()).
//
// f32: CUDA-core FMAs (TF32 would miss the reference's f32 tolerance),
// 32 x 64 tiles of 256 threads, each thread 2 x 4 outputs, D steps of 16,
// summed over D in order.
//
// What bounds it: at decode, bytes.  Whatever the routing, a call reads one
// expert matrix, 16 x 6144 x 10752 bf16 = 2.11 GB at dbrx-132b's widths,
// for 2 x 16 x 8 x 6144 x 10752 = 17 GFLOP: 0.63 ms at 3.35 TB/s, about 8
// flops a byte against the ~295 at which the bf16 tensor cores become the
// limit.  At a 700-token prefill (cap 224) a call is 474 GFLOP: 0.48 ms at
// the bf16 peak, still under the 0.63 ms of the weights.  This first kernel
// streams weights through cp.async with one tile in flight a block and
// many blocks a SM; wgmma/TMA pipelines, and skipping the capacity rows an
// expert leaves empty at decode, are later work.
//
// Every output element is one block's own sum: no atomics, and a result
// does not depend on the rest of the batch or on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;      // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

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
      cp_async16(xs + r * Tile::kXLd + k,
                 ok ? xe + static_cast<size_t>(c0 + r) * D + d0 + k : xe, ok);
    }
    constexpr int kWChunks = BD * BF / 8;
    for (int i = tid; i < kWChunks; i += Tile::kThreads) {
      const int r = i / (BF / 8), k = (i % (BF / 8)) * 8;
      const bool ok = d0 + r < D && f0 + k < F;
      cp_async16(ws + r * Tile::kWLd + k,
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
  cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {
      const int s = (t + 1) & 1;
      load_stage<Tile, BC, BF, BD, kVec>(xe, we, xs + s * Tile::kXStage,
                                         ws + s * Tile::kWStage, c0,
                                         (t + 1) * BD, f0, C, D, F);
    }
    cp_async_commit();
    cp_async_wait_one();              // step t's tiles have landed
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int E,
                              int C, int D, int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
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
      return static_cast<int>(
          launch_bf16<16, 128, 32, 1, 4>(xb, wb, ob, E, C, D, F, vec, st));
    }
    return static_cast<int>(
        launch_bf16<64, 128, 32, 2, 4>(xb, wb, ob, E, C, D, F, vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
