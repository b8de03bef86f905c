// Mamba-2 SSD scan (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd/kernel.py:68 ssd_pallas (pallas_call at :94, body
//   _kernel at :28-65),
// and computes what `repro` runs in every Mamba-2 prefill,
// src/repro/models/mamba2.py:72 ssd_chunked: y in x's dtype and the final
// (B, H, N, P) state in f32.
//
//   x      (B, L, H, P)  f32 or bf16
//   dt     (B, L, H)     f32, positive (after the softplus)
//   a_neg  (H,)          f32, A = -exp(A_log)
//   bm, cm (B, L, G, N)  x's dtype; head h reads group h / (H / G)
//   y      (B, L, H, P)  x's dtype
//   state  (B, H, N, P)  f32
//
// The function is the recurrence  h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t),
// y_t = C_t . h_t, from a zero state.  The entry point takes one of two
// paths and reports which (ssd_scan_launch's `path`):
//
// * chunked (bf16, N 64 or 128, P a multiple of 64, more than kStepMaxL =
//   8 steps, 16-byte aligned: the served models' prefill scans).  The
//   state-space-duality form the TPU kernel's docstring gives, on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 sums).  A block owns one
//   (b, h) and 32 state columns p and walks the chunks of kQ = 64 steps in
//   order, the f32 state (N x 32) in its warps' accumulators from one
//   chunk to the next: nothing is written out between chunks.  Per chunk,
//   with cum the inclusive prefix sum of dt_s A over the chunk,
//     y_t    = exp(cum_t) C_t . state_in
//              + sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//     state' = exp(cum_Q) state_in + sum_s B_s exp(cum_Q - cum_s) dt_s x_s.
//   x, B and C are bf16 and exact as tensor-core operands; every f32
//   factor (the state, the decay-weighted scores W_ts, the weighted rows
//   x_s exp(cum_Q - cum_s) dt_s) is split into bf16 hi + lo and enters
//   two products, so each operand keeps ~16 bits and the f32 gates (1e-4
//   on the state) hold.  cum is summed in f64 by one warp and kept as an
//   f32 pair hi + lo, so that cum_t - cum_s = (hi_t - hi_s) + (lo_t -
//   lo_s) keeps f32 accuracy relative to the difference: in plain f32 it
//   would lose |cum| 2^-24 of the decay's accuracy (1.2e-4 at dt up to 5
//   over 64 steps), which is why the plain version takes it in f64.  The
//   exponent is clamped at 0 before ex2 and the s > t half selected away
//   after (exp of a positive difference overflows; inf * 0 is NaN).
//   Positions past L lie outside the TMA tensor maps and load as zeros,
//   dt by a zero-filling cp.async, so they neither decay nor feed the
//   state, as the plain version's zero-dt padding.
//   Pipeline: one thread brings the next chunk's x, B and C by TMA (whole
//   64-step boxes, 128-byte swizzled) into the second stage of a
//   two-stage ring on an mbarrier while the block computes this one; warp
//   0 turns the next chunk's dt into its scalars (cum, the decays) one
//   chunk ahead.  A warp owns 16 rows t of y and N / 4 rows n of the
//   state; warp w forms W over s < 16 (w + 1), two 16-step slices at a
//   time, so warps 0 and 1, which form the least, also build the chunk's
//   weighted rows of x and the next chunk's scalars.  The grid is
//   B * H * P / 32 blocks of 4 warps (224 for zamba2-7b at B 1).
// * step (f32, bf16 at other widths, and scans of at most 8 steps, where
//   a few dependent steps cost less than the chunked path's fixed cost).
//   The recurrence step by step on the CUDA cores, as the port's first
//   kernel ran every scan: a block owns PPB columns p of one (b, h), kNPT
//   = 8 state rows (n) a thread, N / 8 lanes a column; every kT steps it
//   stages B_t, C_t, exp(dt_t A) and dt_t x_t in shared memory and runs a
//   chain of kT dependent state updates, one FMA per state element, each
//   step's dot C_t . h_t left in shared memory and summed after the tile.
//   It forms no difference of cumulative sums, so f32 inputs keep f32
//   accuracy throughout.
//
// What bounds it: at zamba2-7b's prefill (L 700, H 112, P 64, N 64,
// bf16) the least time is the bytes, ~22 MB, 0.0067 ms; the recurrence's
// 4 N P flops a step and head would take 0.0013 ms on the tensor cores.
// The step path is held by its sequential chain, not by either: ~430 ns
// a step whatever the work (0.30 ms at 700 steps, 45x the bound), since
// each step's update waits for the last and the tile loads are not
// overlapped.  The chunked path replaces the L dependent steps by
// ceil(L / 64) dependent chunks of ~3 us each on an H100 (0.040 ms at 700
// steps, 6x the bound).  A chunk is held by the shared-memory traffic and
// the issue slots of the two blocks an SM holds (clock64 marks: no phase
// waits on memory), not by a chain of dependent MMAs (splitting the hi
// and lo products into two accumulators changed nothing): each warp reads
// the whole state and x w operands (hi and lo) from shared memory, and
// the two blocks of a head both form W.  A warpgroup MMA (wgmma) reading
// each operand once per block, with one block per head, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------ step path

constexpr int kThreads = 128;
constexpr int kT = 16;     // time steps staged in shared memory at once
constexpr int kNPT = 8;    // state rows a thread holds

template <typename T, int N>
__device__ __forceinline__ void step_body(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const T* __restrict__ bm,
    const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ state,
    int L, int H, int P, int G) {
  constexpr int NG = N / kNPT;         // lanes sharing one state column
  constexpr int PPB = kThreads / NG;   // state columns a block owns
  static_assert(N % kNPT == 0 && NG <= 32 && (NG & (NG - 1)) == 0,
                "a state column must map onto lanes of one warp");
  static_assert(kNPT == 8, "a thread reads its rows as two float4");

  // B_t, C_t: the kNPT rows of lane group g at [t][g][0..kNPT), padded
  __shared__ __align__(16) float sm_b[kT][NG][kNPT + 4];
  __shared__ __align__(16) float sm_c[kT][NG][kNPT + 4];
  __shared__ float sm_x[kT][PPB];          // dt * x
  __shared__ float sm_a[kT];               // exp(dt * A)
  __shared__ float sm_y[kT][NG][PPB + 1];  // partial dots C_t . h_t

  const int bh = blockIdx.x;           // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * PPB;
  const int grp = threadIdx.x % NG;
  const int col = threadIdx.x / NG;
  const int p = p0 + col;
  const int n0 = grp * kNPT;
  const float A = a_neg[h];

  float st[kNPT] = {};

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int nt = min(kT, L - t0);
    for (int i = threadIdx.x; i < kT * N; i += kThreads) {
      const int t = i / N;
      const int n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < nt) {
        const size_t at =
            ((static_cast<size_t>(b) * L + t0 + t) * G + g) * N + n;
        bv = to_float(bm[at]);
        cv = to_float(cm[at]);
      }
      sm_b[t][n / kNPT][n % kNPT] = bv;
      sm_c[t][n / kNPT][n % kNPT] = cv;
    }
    for (int i = threadIdx.x; i < kT * PPB; i += kThreads) {
      const int t = i / PPB;
      const int c = i % PPB;
      float v = 0.f;
      if (t < nt && p0 + c < P) {
        const size_t row = (static_cast<size_t>(b) * L + t0 + t) * H + h;
        v = to_float(x[row * P + p0 + c]) * dt[row];
      }
      sm_x[t][c] = v;
    }
    if (threadIdx.x < kT) {
      const int t = threadIdx.x;
      sm_a[t] = t < nt
                    ? expf(dt[(static_cast<size_t>(b) * L + t0 + t) * H + h] *
                           A)
                    : 1.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float a = sm_a[t];
      const float xv = sm_x[t][col];
      const float4* bq = reinterpret_cast<const float4*>(sm_b[t][grp]);
      const float4* cq = reinterpret_cast<const float4*>(sm_c[t][grp]);
      const float4 b_lo = bq[0], b_hi = bq[1], c_lo = cq[0], c_hi = cq[1];
      const float bb[kNPT] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                              b_hi.x, b_hi.y, b_hi.z, b_hi.w};
      const float cc[kNPT] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w,
                              c_hi.x, c_hi.y, c_hi.z, c_hi.w};
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kNPT; ++i) {
        st[i] = fmaf(a, st[i], bb[i] * xv);
        acc = fmaf(cc[i], st[i], acc);
      }
      sm_y[t][grp][col] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * PPB; i += kThreads) {
      const int t = i / PPB;
      const int c = i % PPB;
      if (p0 + c < P) {
        float acc = 0.f;
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) acc += sm_y[t][gi][c];
        store(y + ((static_cast<size_t>(b) * L + t0 + t) * H + h) * P + p0 +
                  c,
              acc);
      }
    }
    __syncthreads();
  }
  if (p < P) {
#pragma unroll
    for (int i = 0; i < kNPT; ++i) {
      state[(static_cast<size_t>(bh) * N + n0 + i) * P + p] = st[i];
    }
  }
}

// As the port's first kernel built it; for bf16 at N <= 32 with one block
// an SM allowed for, which keeps ptxas from spilling there
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_step_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_neg,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    T* __restrict__ y, float* __restrict__ state, int L,
                    int H, int P, int G) {
  step_body<T, N>(x, dt, a_neg, bm, cm, y, state, L, H, P, G);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_step_bf16_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a_neg,
                         const bf16* __restrict__ bm,
                         const bf16* __restrict__ cm, bf16* __restrict__ y,
                         float* __restrict__ state, int L, int H, int P,
                         int G) {
  step_body<bf16, N>(x, dt, a_neg, bm, cm, y, state, L, H, P, G);
}

template <typename T, int N>
cudaError_t launch_step_n(const void* x, const float* dt, const float* a_neg,
                          const void* bm, const void* cm, void* y,
                          float* state, int B, int L, int H, int P, int G,
                          cudaStream_t stream) {
  constexpr int PPB = kThreads / (N / kNPT);
  const dim3 grid(B * H, (P + PPB - 1) / PPB);
  if constexpr (sizeof(T) == 2 && N <= 32) {
    ssd_step_bf16_kernel<N><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), dt, a_neg, static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<T*>(y), state, L, H, P, G);
  } else {
    ssd_step_kernel<T, N><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), dt, a_neg, static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<T*>(y), state, L, H, P, G);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step(const void* x, const float* dt, const float* a_neg,
                        const void* bm, const void* cm, void* y,
                        float* state, int B, int L, int H, int P, int G,
                        int N, cudaStream_t st) {
  switch (N) {
    case 8:
      return launch_step_n<T, 8>(x, dt, a_neg, bm, cm, y, state, B, L, H, P,
                                 G, st);
    case 16:
      return launch_step_n<T, 16>(x, dt, a_neg, bm, cm, y, state, B, L, H,
                                  P, G, st);
    case 32:
      return launch_step_n<T, 32>(x, dt, a_neg, bm, cm, y, state, B, L, H,
                                  P, G, st);
    case 64:
      return launch_step_n<T, 64>(x, dt, a_neg, bm, cm, y, state, B, L, H,
                                  P, G, st);
    case 128:
      return launch_step_n<T, 128>(x, dt, a_neg, bm, cm, y, state, B, L, H,
                                   P, G, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- chunked path

constexpr int kQ = 64;         // steps a chunk
constexpr int kStepMaxL = 8;   // at most this many steps go step by step:
                               // there a few dependent steps cost less than
                               // the chunked path's fixed cost (PERF.md)
constexpr int kPP = 32;        // state columns (p) a block owns
constexpr int kCWarps = 4;     // a warp: 16 rows t of y, N / 4 rows n
constexpr int kCThreads = 32 * kCWarps;
constexpr int kXS = kPP + 8;   // row stride of the xw and state tiles:
                               // 80 bytes, an odd number of 16-byte units,
                               // so an ldmatrix's 8 rows hit distinct banks
constexpr int kPanel = 64 * 64;   // bf16 elements of a TMA panel: 64 rows
                                  // of 128 bytes, 128-byte swizzled

// Element (r, k) of a tile of 64-column panels as TMA writes them with
// the 128-byte swizzle (csrc/hopper.cuh): the 16-byte unit k / 8 of row r
// sits at unit (k / 8) ^ (r % 8) of the row, so the 8 rows an ldmatrix
// reads at one column hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int k) {
  return (k >> 6) * kPanel + r * 64 + ((((k & 63) >> 3) ^ (r & 7)) << 3) +
         (k & 7);
}

// Shared memory (after aligning the base to the 1024-byte swizzle atom),
// in bytes, in this order.
template <int N>
struct Chunk {
  static constexpr int MT = N / 64;                  // state m16 tiles a warp
  static constexpr int X_STAGE = kPanel * 2;         // 64 x 64 of x
  static constexpr int B_STAGE = (N / 64) * kPanel * 2;
  static constexpr int STAGE = X_STAGE + 2 * B_STAGE;   // x, B, C
  static constexpr int OFF_XW = 2 * STAGE;           // [2][kQ][kXS] bf16
  static constexpr int OFF_ST = OFF_XW + 2 * kQ * kXS * 2;   // [2][N][kXS]
  static constexpr int OFF_DT = OFF_ST + 2 * N * kXS * 2;    // f32 [2][kQ]
  static constexpr int OFF_SC = OFF_DT + 2 * kQ * 4;         // Scalars [2]
};

// A chunk's per-step scalars, computed by warp 0 one chunk ahead: cum
// log2(e) as an unevaluated f32 sum hi + lo of the f64 prefix sum (so
// cum_t - cum_s keeps f32 accuracy relative to the difference, not to
// |cum|, and exp of it is one ex2), exp(cum_t), exp(cum_Q - cum_s) dt_s
// and exp(cum_Q).
struct Scalars {
  float hi[kQ], lo[kQ], ecum[kQ], wst[kQ], etot[4];
};

// ... then the two stages' mbarriers
template <int N>
__host__ __device__ constexpr int barrier_offset() {
  return Chunk<N>::OFF_SC + 2 * static_cast<int>(sizeof(Scalars));
}

template <int N>
__host__ __device__ constexpr int chunk_bytes() {
  return 1024 + barrier_offset<N>() + 2 * 8;   // 1 KB of slack to align
}

// 4 bytes from global to shared memory (cp.async.ca); with `pred` false
// nothing is read and zeros are written.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

// 2^v for v <= 0 (ex2.approx: relative error below 2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp2_neg(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// bf16 hi + lo of two floats, as two packed registers: hi = bf16(v),
// lo = bf16(v - hi); hi + lo keeps ~16 significant bits of v.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  const float2 back =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = hopper::pack_bf16(v0 - back.x, v1 - back.y);
}

// Warp 0: the scalars of one chunk from its dt (in shared memory), lane l
// taking steps 2l and 2l + 1.  Rows past L hold dt 0: no decay, no input.
__device__ __forceinline__ void chunk_scalars(const float* dtc, float A,
                                              Scalars& sc, int lane) {
  const float la0 = dtc[2 * lane] * A, la1 = dtc[2 * lane + 1] * A;
  double incl = static_cast<double>(la0) + la1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double cum[2] = {excl + la0, excl + la0 + la1};
  const double total = __shfl_sync(0xffffffffu, cum[1], 31);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = 2 * lane + e;
    const double c2 = cum[e] * 1.4426950408889634;   // log2(e)
    const float hi = static_cast<float>(c2);
    sc.hi[s] = hi;
    sc.lo[s] = static_cast<float>(c2 - hi);
    sc.ecum[s] = expf(static_cast<float>(cum[e]));
    sc.wst[s] = expf(static_cast<float>(total - cum[e])) * dtc[s];
  }
  if (lane == 0) sc.etot[0] = expf(static_cast<float>(total));
}

// x (and B, C) arrive by TMA, whole 64-step boxes: x's 64-column panel
// that holds the block's 32 columns, and every 64-column panel of B and
// C.  Positions past L lie outside the tensor map (its L dimension), so
// TMA writes them as zeros: the last chunk's rows past L add nothing.
template <int N>
__global__ void __launch_bounds__(kCThreads)
    ssd_chunk_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap cmap,
                     const float* __restrict__ dt,
                     const float* __restrict__ a_neg, bf16* __restrict__ y,
                     float* __restrict__ state, int L, int H, int P, int G) {
  using S = Chunk<N>;
  constexpr int MT = S::MT;
  constexpr int KN = N / 16;     // k16 steps over n
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* xw = reinterpret_cast<bf16*>(smem + S::OFF_XW);   // hi, then lo
  bf16* sth = reinterpret_cast<bf16*>(smem + S::OFF_ST);  // hi, then lo
  float* dts = reinterpret_cast<float*>(smem + S::OFF_DT);
  Scalars* scs = reinterpret_cast<Scalars*>(smem + S::OFF_SC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + barrier_offset<N>());

  const int panels = P / kPP;
  const int bh = blockIdx.x / panels;   // b * H + h
  const int p0 = (blockIdx.x - bh * panels) * kPP;
  const int px = p0 & 63;               // the block's columns in x's panel
  const int b = bh / H;
  const int h = bh - b * H;
  const int grp = h / (H / G);
  const float A = a_neg[h];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int n_chunks = (L + kQ - 1) / kQ;

  auto stage_x = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * S::STAGE);
  };
  auto stage_b = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * S::STAGE + S::X_STAGE);
  };
  auto stage_c = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * S::STAGE + S::X_STAGE +
                                   S::B_STAGE);
  };
  // chunk c's x, B and C into stage st (one thread)
  auto issue_tma = [&](int c, int st) {
    hopper::mbar_expect_tx(bars + st, S::STAGE);
    hopper::tma_load_4d(stage_x(st), &xmap, bars + st, p0 - px, h, c * kQ,
                        b);
#pragma unroll
    for (int pn = 0; pn < N / 64; ++pn) {
      hopper::tma_load_4d(stage_b(st) + pn * kPanel, &bmap, bars + st,
                          64 * pn, grp, c * kQ, b);
      hopper::tma_load_4d(stage_c(st) + pn * kPanel, &cmap, bars + st,
                          64 * pn, grp, c * kQ, b);
    }
  };
  // chunk c's dt (warp 0, which turns it into the chunk's scalars) at
  // dt[(b L + t) H + h]; rows past L read nothing and land as zeros
  auto issue_dt = [&](int c, int st) {
    const int t0 = c * kQ;
#pragma unroll
    for (int e = 0; e < kQ / 32; ++e) {
      const int r = 32 * e + lane;
      const bool ok = t0 + r < L;
      cp_async4(dts + st * kQ + r,
                dt + (static_cast<size_t>(b) * L + (ok ? t0 + r : 0)) * H + h,
                ok);
    }
    hopper::cp_async_commit();
  };
  // x_s exp(cum_Q - cum_s) dt_s as bf16 hi (xw) and lo (xw + kQ kXS), the
  // rows [r0, r0 + kQ / 2) by one warp
  auto build_xw = [&](const bf16* xc, const Scalars& sc, int r0) {
    constexpr int PAIRS = kPP / 2;
#pragma unroll 4
    for (int k = 0; k < kQ / 2 * PAIRS / 32; ++k) {
      const int i = lane + 32 * k;
      const int s = r0 + i / PAIRS, p = i % PAIRS * 2;
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xc + swz(s, px + p)));
      const float w = sc.wst[s];
      uint32_t hi, lo;
      split2(v.x * w, v.y * w, hi, lo);
      *reinterpret_cast<uint32_t*>(xw + s * kXS + p) = hi;
      *reinterpret_cast<uint32_t*>(xw + (kQ + s) * kXS + p) = lo;
    }
  };

  // the warp's state rows n = N/4 warp + 16 mt + {g, g + 8}, columns
  // p0 + 8 j + 2 tq + {0, 1}
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    hopper::mbar_init(bars + 1, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) issue_tma(0, 0);
  if (warp == 0) {
    issue_dt(0, 0);
    hopper::cp_async_wait<0>();
    __syncwarp();
    chunk_scalars(dts, A, scs[0], lane);
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    hopper::mbar_wait(bars + st, (c >> 1) & 1);
    __syncthreads();  // chunk c and its scalars are in; chunk c - 1's
                      // readers are done
    if (c + 1 < n_chunks) {
      if (threadIdx.x == 0) issue_tma(c + 1, st ^ 1);
      if (warp == 0) issue_dt(c + 1, st ^ 1);
    }
    const bf16* xc = stage_x(st);
    const bf16* bc = stage_b(st);
    const bf16* cc = stage_c(st);
    const float* dtc = dts + st * kQ;
    const Scalars& sc = scs[st];

    // state_in as bf16 hi (sth) and lo (sth + N kXS), the warp's own rows
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = (N / 4) * warp + 16 * mt + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 8 * j + 2 * tq;
        uint32_t hi, lo;
        split2(acc[mt][j][0], acc[mt][j][1], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + n * kXS + p) = hi;
        *reinterpret_cast<uint32_t*>(sth + (N + n) * kXS + p) = lo;
        split2(acc[mt][j][2], acc[mt][j][3], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + (n + 8) * kXS + p) = hi;
        *reinterpret_cast<uint32_t*>(sth + (N + n + 8) * kXS + p) = lo;
      }
    }
    __syncthreads();

    // ---- y for rows t = 16 warp + {g, g + 8}
    uint32_t ca[KN][4];   // C_t as the A operand, k = n
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      hopper::ldmatrix_x4(ca[kk],
                          cc + swz(16 * warp + lane % 16,
                                   16 * kk + 8 * (lane / 16)));
    }
    float ya[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] = 0.f;
    // inter-chunk: C_t . state_in, hi and lo (state rows n are k)
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = 16 * kk + 8 * (mi & 1) + mr;
        const int col = 8 * (j + (mi >> 1));
        uint32_t bh4[4], bl4[4];
        hopper::ldmatrix_x4_trans(bh4, sth + r * kXS + col);
        hopper::ldmatrix_x4_trans(bl4, sth + (N + r) * kXS + col);
        hopper::mma_16816(ya[j], ca[kk], bh4[0], bh4[1]);
        hopper::mma_16816(ya[j + 1], ca[kk], bh4[2], bh4[3]);
        hopper::mma_16816(ya[j], ca[kk], bl4[0], bl4[1]);
        hopper::mma_16816(ya[j + 1], ca[kk], bl4[2], bl4[3]);
      }
    }
    const int t_lo = 16 * warp + g;
    {
      const float e0 = sc.ecum[t_lo], e1 = sc.ecum[t_lo + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ya[j][0] *= e0;
        ya[j][1] *= e0;
        ya[j][2] *= e1;
        ya[j][3] *= e1;
      }
    }
    // intra-chunk: W_ts = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t,
    // two k16 slices of s at a time (the second may lie wholly above the
    // diagonal, and then adds zeros).  The exponent is clamped at 0 (the
    // s > t half, selected away after) so that nothing overflows and no
    // branch splits the warp.
    const float th[2] = {sc.hi[t_lo], sc.hi[t_lo + 8]};
    const float tl[2] = {sc.lo[t_lo], sc.lo[t_lo + 8]};
    for (int kp = 0; kp <= warp; kp += 2) {
      float sv[2][2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[q][u][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t b4[4];
          hopper::ldmatrix_x4(b4, bc + swz(16 * (kp + q) + 8 * (mi >> 1) + mr,
                                           16 * kk + 8 * (mi & 1)));
          hopper::mma_16816(sv[q][0], ca[kk], b4[0], b4[1]);
          hopper::mma_16816(sv[q][1], ca[kk], b4[2], b4[3]);
        }
      }
      uint32_t wh[2][4], wl[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int s0 = 16 * (kp + q) + 8 * u + 2 * tq;
          const float2 sh = *reinterpret_cast<const float2*>(sc.hi + s0);
          const float2 sl = *reinterpret_cast<const float2*>(sc.lo + s0);
          const float2 sd = *reinterpret_cast<const float2*>(dtc + s0);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {   // rows g (hh 0) and g + 8
            const int t = t_lo + 8 * hh;
            const float e0 =
                exp2_neg(fminf((th[hh] - sh.x) + (tl[hh] - sl.x), 0.f)) *
                sd.x;
            const float e1 =
                exp2_neg(fminf((th[hh] - sh.y) + (tl[hh] - sl.y), 0.f)) *
                sd.y;
            split2(s0 <= t ? sv[q][u][2 * hh] * e0 : 0.f,
                   s0 + 1 <= t ? sv[q][u][2 * hh + 1] * e1 : 0.f,
                   wh[q][2 * u + hh], wl[q][2 * u + hh]);
          }
        }
      }
      // W . x over the two slices (x rows s are k)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b4[4];
          hopper::ldmatrix_x4_trans(
              b4, xc + swz(16 * (kp + q) + 8 * (mi & 1) + mr,
                           px + 8 * (j + (mi >> 1))));
          hopper::mma_16816(ya[j], wh[q], b4[0], b4[1]);
          hopper::mma_16816(ya[j + 1], wh[q], b4[2], b4[3]);
          hopper::mma_16816(ya[j], wl[q], b4[0], b4[1]);
          hopper::mma_16816(ya[j + 1], wl[q], b4[2], b4[3]);
        }
      }
    }
    {
      const int t0 = c * kQ;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + t_lo + 8 * hh;
        if (t < L) {
          bf16* yr = y + ((static_cast<size_t>(b) * L + t) * H + h) * P + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<uint32_t*>(yr + 8 * j + 2 * tq) =
                hopper::pack_bf16(ya[j][2 * hh], ya[j][2 * hh + 1]);
          }
        }
      }
    }
    // warps 0 and 1, whose shares of the intra-chunk term are the
    // smallest: this chunk's x w (for the state below), and the next
    // chunk's scalars once its dt is in (warp 0)
    if (warp < 2) build_xw(xc, sc, (kQ / 2) * warp);
    if (warp == 0 && c + 1 < n_chunks) {
      hopper::cp_async_wait<0>();
      __syncwarp();
      chunk_scalars(dts + (st ^ 1) * kQ, A, scs[st ^ 1], lane);
    }
    __syncthreads();  // xw is complete

    // ---- state' = exp(cum_Q) state + B^T (x w), rows n of this warp
    const float et = sc.etot[0];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] *= et;
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      uint32_t xh[4][2], xl[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = 16 * ks + 8 * (mi & 1) + mr;
        const int col = 8 * (j + (mi >> 1));
        uint32_t b4[4];
        hopper::ldmatrix_x4_trans(b4, xw + r * kXS + col);
        xh[j][0] = b4[0];
        xh[j][1] = b4[1];
        xh[j + 1][0] = b4[2];
        xh[j + 1][1] = b4[3];
        hopper::ldmatrix_x4_trans(b4, xw + (kQ + r) * kXS + col);
        xl[j][0] = b4[0];
        xl[j][1] = b4[1];
        xl[j + 1][0] = b4[2];
        xl[j + 1][1] = b4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // B^T rows n as the A operand (k = s): transposed from B's rows s
        const int n0 = (N / 4) * warp + 16 * mt;
        uint32_t a4[4];
        hopper::ldmatrix_x4_trans(
            a4, bc + swz(16 * ks + 8 * (mi >> 1) + mr, n0 + 8 * (mi & 1)));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hopper::mma_16816(acc[mt][j], a4, xh[j][0], xh[j][1]);
          hopper::mma_16816(acc[mt][j], a4, xl[j][0], xl[j][1]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int n = (N / 4) * warp + 16 * mt + g;
    float* sr = state + (static_cast<size_t>(bh) * N + n) * P + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(sr + p) =
          make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(sr + 8 * P + p) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
}

// (inner, rows, L, B) of a (B, L, rows, inner) bf16 tensor, boxes of 64
// columns x 1 row x kQ positions x 1 batch.
bool encode(CUtensorMap* map, const void* base, int B, int L, int rows,
            int inner) {
  const uint64_t dims[4] = {uint64_t(inner), uint64_t(rows), uint64_t(L),
                            uint64_t(B)};
  const uint64_t row = uint64_t(inner) * sizeof(bf16);
  const uint64_t strides[3] = {row, row * rows, row * rows * L};
  const uint32_t box[4] = {64, 1, uint32_t(kQ), 1};
  return hopper::encode_bf16(map, base, 4, dims, strides, box);
}

template <int N>
cudaError_t launch_chunk_n(const void* x, const float* dt, const float* a_neg,
                           const void* bm, const void* cm, void* y,
                           float* state, int B, int L, int H, int P, int G,
                           cudaStream_t stream) {
  constexpr int bytes = chunk_bytes<N>();
  // above 48 KB only as opted-in dynamic shared memory (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(B) * H * (P / kPP);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap xmap, bmap, cmap;
  if (!encode(&xmap, x, B, L, H, P) || !encode(&bmap, bm, B, L, G, N) ||
      !encode(&cmap, cm, B, L, G, N)) {
    return cudaErrorInvalidValue;
  }
  ssd_chunk_kernel<N><<<static_cast<unsigned>(blocks), kCThreads, bytes,
                        stream>>>(xmap, bmap, cmap, dt, a_neg,
                                  static_cast<bf16*>(y), state, L, H, P, G);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes.  dtype (of x, bm, cm, y): 0 = float32,
// 1 = bfloat16.  Writes the path it launched to *path (0 = step, 1 =
// chunked) and returns the CUDA error of the launch (0 = cudaSuccess).
// The chunked path takes bf16 with N 64 or 128, P a multiple of 64, L
// over kStepMaxL and 16-byte aligned x, bm, cm and y (TMA takes no
// other); every other input takes the step path.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_neg, const void* bm,
                               const void* cm, void* y, void* state, int B,
                               int L, int H, int P, int G, int N, int dtype,
                               void* stream, int* path) {
  *path = -1;
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      B * H > 0x7fffffff / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_neg);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (N == 64 || N == 128) && P % 64 == 0 && L > kStepMaxL &&
      aligned16(x) && aligned16(bm) && aligned16(cm) && aligned16(y)) {
    *path = 1;
    return static_cast<int>(
        N == 64 ? launch_chunk_n<64>(x, dtf, af, bm, cm, y, sf, B, L, H, P, G,
                                     st)
                : launch_chunk_n<128>(x, dtf, af, bm, cm, y, sf, B, L, H, P,
                                      G, st));
  }
  if (dtype == 0) {
    *path = 0;
    return static_cast<int>(launch_step<float>(x, dtf, af, bm, cm, y, sf, B,
                                               L, H, P, G, N, st));
  }
  if (dtype == 1) {
    *path = 0;
    return static_cast<int>(launch_step<bf16>(x, dtf, af, bm, cm, y, sf, B,
                                              L, H, P, G, N, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
