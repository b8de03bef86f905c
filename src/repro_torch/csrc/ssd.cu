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
// y_t = C_t . h_t.  The TPU kernel evaluates it chunk by chunk, the
// quadratic "attention-like" form inside a chunk of Q = 256 steps on the
// MXU and the state across chunks, because its grid runs in order on one
// core and its matrix unit wants big products.  This kernel runs the
// recurrence itself, step by step:
//   * it does the least arithmetic: 4 N P flops a step and head, against
//     the chunked form's ~2 Q (N + P) + 4 N P (at Q 256, N 64, P 64: 16 K
//     flops against 82 K);
//   * it never forms exp(cum[t] - cum[s]) for s > t, which overflows over a
//     long chunk (inf * 0 is NaN): each decay is exp(dt A) <= 1;
//   * L needs no padding to a chunk multiple: the scan stops at L, which is
//     what the reference's zero-dt padding amounts to;
//   * dt * x is formed in f32 and B, C are read in their source dtype and
//     widened exactly, as ssd_chunked does.
// The state is independent per column p: a block owns PPB columns of one
// (b, h), kNPT = 8 state rows (n) a thread, N / 8 lanes a column.  Every
// kT steps the block stages B_t, C_t, exp(dt_t A) and dt_t x_t in shared
// memory (f32: 34 KB at N 128).  Inside a tile the only dependence from
// one step to the next is the state update, one FMA per state element:
// each thread leaves its partial dot C_t . h_t in shared memory, and the
// partials of the tile are summed and written back, coalesced, after its
// last step, so no reduction sits on the sequential path.  Every column
// of the block reads the same B_t and C_t, so the loop is held by shared
// memory bandwidth, not by FMAs: a thread reads its 8 rows of each as two
// 16-byte loads, from rows padded to 12 floats so that the 8 lane groups
// of a warp hit distinct banks.
//
// What bounds it: operations.  A step reads P elements of x and writes P
// of y per head, reads 2 N of B and C per group, and does 4 N P flops per
// head: at zamba2-7b's P 64, N 64 in bf16 about 62 flops a byte, above the
// ~20 at which the H100's f32 pipes (67 TFLOP/s over 3.35 TB/s) stop
// waiting on memory, and the state is f32 as in the reference.  The steps
// are sequential, one FMA per state element from one to the next; a grid
// of B * H * ceil(P / PPB) blocks (448 at B 1 for zamba2-7b) keeps ~14
// warps on each SM.  A tensor-core chunked form is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 16;     // time steps staged in shared memory at once
constexpr int kNPT = 8;    // state rows a thread holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_neg,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    T* __restrict__ y, float* __restrict__ state, int L,
                    int H, int P, int G) {
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

template <typename T, int N>
cudaError_t launch_n(const void* x, const float* dt, const float* a_neg,
                     const void* bm, const void* cm, void* y, float* state,
                     int B, int L, int H, int P, int G, cudaStream_t stream) {
  constexpr int PPB = kThreads / (N / kNPT);
  const dim3 grid(B * H, (P + PPB - 1) / PPB);
  ssd_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a_neg, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, L, H, P, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const float* dt, const float* a_neg,
                     const void* bm, const void* cm, void* y, float* state,
                     int B, int L, int H, int P, int G, int N,
                     cudaStream_t st) {
  switch (N) {
    case 8:
      return launch_n<T, 8>(x, dt, a_neg, bm, cm, y, state, B, L, H, P, G,
                            st);
    case 16:
      return launch_n<T, 16>(x, dt, a_neg, bm, cm, y, state, B, L, H, P, G,
                             st);
    case 32:
      return launch_n<T, 32>(x, dt, a_neg, bm, cm, y, state, B, L, H, P, G,
                             st);
    case 64:
      return launch_n<T, 64>(x, dt, a_neg, bm, cm, y, state, B, L, H, P, G,
                             st);
    case 128:
      return launch_n<T, 128>(x, dt, a_neg, bm, cm, y, state, B, L, H, P, G,
                              st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  dtype (of x, bm, cm, y): 0 = float32,
// 1 = bfloat16.  Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_neg, const void* bm,
                               const void* cm, void* y, void* state, int B,
                               int L, int H, int P, int G, int N, int dtype,
                               void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      B * H > 0x7fffffff / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_neg);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_t<float>(x, dtf, af, bm, cm, y, sf, B,
                                            L, H, P, G, N, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_t<__nv_bfloat16>(
        x, dtf, af, bm, cm, y, sf, B, L, H, P, G, N, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
