// Fused depthwise-separable 1D convolution + bias + optional ReLU for
// Hopper (sm_90a): HALF's layer, channels last.
//
// Replaces the TPU kernel
//   src/repro/kernels/conv1d/kernel.py:58 dwsep_conv1d_pallas
//     (pallas_call at :73, body _kernel at :29-55).
// The TPU version walks a sequential grid (record, block of 128 output
// channels), computes the depthwise result once per record at j == 0 into
// VMEM scratch and reuses it for the later channel blocks, and pads C_out to
// a multiple of 128 for the MXU.  Blocks on this card run in no order and
// C_out is at most a few dozen on the ECG path, so neither carries over: a
// block owns a tile of output positions of one record and every output
// channel of them, and nothing is padded.
//
//   x    (B, L, C_in)      f32 or bf16, channels last, contiguous
//   dw   (K, C_in)         x's dtype
//   pw   (C_in, C_out)     x's dtype
//   b    (C_out,)          x's dtype
//   out  (B, L_out, C_out) x's dtype; L_out = (L - K) / stride + 1 (VALID)
//
// Everything is accumulated in f32.  The depthwise taps are multiplied and
// added in tap order with separate roundings (__fmul_rn, __fadd_rn), which
// is the plain version's arithmetic (kernels/conv1d/ref.py) step for step
// (its pointwise product accumulates in f64, as an oracle without a
// summation order of its own);
// the pointwise sum runs over C_in with FMAs into four partial sums
// (channel c into sum c % 4, combined pairwise), then adds the bias: its
// rounding error is about half that of one running sum, and the four
// chains are independent.
//
// What bounds it: memory.  A call reads x once and writes out once; per
// output position it does 2*K*C_in + 2*C_in*C_out + C_out flops, at most
// ~2,500 for C_in = C_out = 32, against (C_in + C_out) * 4 bytes moved:
// ~10 flops per byte in f32, far below the ~20 flops/byte at which the
// H100's 67 TFLOP/s of f32 FMA meets its 3.35 TB/s.  The widest layer of
// the ECG path at batch 256, (256, 3744, 32) -> (256, 3738, 32) in f32,
// moves ~245 MB: ~0.073 ms at 3.35 TB/s.
//
// Design (simple first): one block per (record, tile of kTile output
// positions).  The block copies the tile's input window, kTile*stride +
// K - 1 rows x C_in (one contiguous, coalesced run of device memory), and
// dw, pw, b into shared memory as f32; forms the (kTile, C_in) depthwise
// tile in shared memory; then each thread produces (position, out channel)
// outputs, out channel fastest, so a warp's stores are contiguous.  The
// depthwise tile's rows are padded to an odd stride so that threads of one
// warp on different positions hit different banks.  Each output depends
// only on its own record: no atomics, and a row's result does not depend
// on the rest of the batch.
//
// Known limits: every block re-reads dw/pw/b (from L2); the integer
// divisions by C_in and C_out and the scalar loads are not tuned; no
// cp.async/TMA pipelining of the next window.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // output positions per block
constexpr int kMaxCin = 32;      // MAX_C_IN in kernels/conv1d/ops.py
constexpr int kMaxCout = 1024;   // MAX_C_OUT in kernels/conv1d/ops.py
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

struct Args {
  const void* x;
  const void* dw;
  const void* pw;
  const void* b;
  void* out;
  int batch;
  int length;
  int c_in;
  int c_out;
  int l_out;
  int relu;
};

__host__ __device__ constexpr int window_rows(int k, int s) {
  return kTile * s + k - 1;
}

// Shared memory, all f32:
//   xw   [window_rows * c_in]   the tile's input window
//   dwt  [kTile * ldt]          depthwise tile, ldt = c_in | 1 (odd)
//   wdw  [K * c_in]
//   wpw  [c_in * c_out]
//   bias [c_out]
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
    dwsep_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                        const T* __restrict__ pw, const T* __restrict__ b,
                        T* __restrict__ out, int length, int c_in, int c_out,
                        int l_out, int n_tiles, int relu) {
  extern __shared__ float smem[];
  const int ldt = c_in | 1;
  float* xw = smem;
  float* dwt = xw + window_rows(K, S) * c_in;
  float* wdw = dwt + kTile * ldt;
  float* wpw = wdw + K * c_in;
  float* bias = wpw + c_in * c_out;

  const int rec = blockIdx.x / n_tiles;
  const int p0 = (blockIdx.x - rec * n_tiles) * kTile;
  const int n_pos = min(kTile, l_out - p0);
  // rows the tile's positions read: (n_pos - 1) * S + K <= length - p0*S
  const int n_in = ((n_pos - 1) * S + K) * c_in;

  const T* xs = x + ((size_t)rec * length + (size_t)p0 * S) * c_in;
  for (int i = threadIdx.x; i < n_in; i += kThreads) xw[i] = to_f32(xs[i]);
  for (int i = threadIdx.x; i < K * c_in; i += kThreads)
    wdw[i] = to_f32(dw[i]);
  for (int i = threadIdx.x; i < c_in * c_out; i += kThreads)
    wpw[i] = to_f32(pw[i]);
  for (int i = threadIdx.x; i < c_out; i += kThreads) bias[i] = to_f32(b[i]);
  __syncthreads();

  // depthwise stage: K taps in order, each product and sum rounded
  for (int i = threadIdx.x; i < n_pos * c_in; i += kThreads) {
    const int p = i / c_in;
    const int c = i - p * c_in;
    const float* xp = xw + p * S * c_in + c;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(xp[k * c_in], wdw[k * c_in + c]));
    dwt[p * ldt + c] = acc;
  }
  __syncthreads();

  // pointwise stage: out channel fastest; the tile's outputs are one
  // contiguous run of n_pos * c_out elements
  T* os = out + ((size_t)rec * l_out + p0) * c_out;
  for (int i = threadIdx.x; i < n_pos * c_out; i += kThreads) {
    const int p = i / c_out;
    const int o = i - p * c_out;
    const float* d = dwt + p * ldt;
    const float* w = wpw + o;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;   // channel c -> a[c % 4]
    int c = 0;
    for (; c + 4 <= c_in; c += 4) {
      a0 = fmaf(d[c], w[c * c_out], a0);
      a1 = fmaf(d[c + 1], w[(c + 1) * c_out], a1);
      a2 = fmaf(d[c + 2], w[(c + 2) * c_out], a2);
      a3 = fmaf(d[c + 3], w[(c + 3) * c_out], a3);
    }
    if (c < c_in) a0 = fmaf(d[c], w[c * c_out], a0);
    if (c + 1 < c_in) a1 = fmaf(d[c + 1], w[(c + 1) * c_out], a1);
    if (c + 2 < c_in) a2 = fmaf(d[c + 2], w[(c + 2) * c_out], a2);
    float y = ((a0 + a1) + (a2 + a3)) + bias[o];
    if (relu) y = fmaxf(y, 0.f);
    store(os + i, y);
  }
}

template <typename T, int K, int S>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)window_rows(K, S) * a.c_in +
                       (size_t)kTile * (a.c_in | 1) + (size_t)K * a.c_in +
                       (size_t)a.c_in * a.c_out + a.c_out);
  if (smem > kDefaultSmem) {
    // above 48 KB only as opted-in dynamic shared memory (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        dwsep_conv1d_kernel<T, K, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_tiles = (a.l_out + kTile - 1) / kTile;
  const long long blocks = (long long)n_tiles * a.batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dwsep_conv1d_kernel<T, K, S><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dw),
      static_cast<const T*>(a.pw), static_cast<const T*>(a.b),
      static_cast<T*>(a.out), a.length, a.c_in, a.c_out, a.l_out, n_tiles,
      a.relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int k, int s, cudaStream_t stream) {
  switch (k * 10 + s) {
    case 11: return launch_t<T, 1, 1>(a, stream);
    case 12: return launch_t<T, 1, 2>(a, stream);
    case 14: return launch_t<T, 1, 4>(a, stream);
    case 31: return launch_t<T, 3, 1>(a, stream);
    case 32: return launch_t<T, 3, 2>(a, stream);
    case 34: return launch_t<T, 3, 4>(a, stream);
    case 51: return launch_t<T, 5, 1>(a, stream);
    case 52: return launch_t<T, 5, 2>(a, stream);
    case 54: return launch_t<T, 5, 4>(a, stream);
    case 71: return launch_t<T, 7, 1>(a, stream);
    case 72: return launch_t<T, 7, 2>(a, stream);
    case 74: return launch_t<T, 7, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success); a shape
// the kernel does not take returns cudaErrorInvalidValue and launches
// nothing.  Launches on `stream` and does not synchronise.
extern "C" int dwsep_conv1d_launch(const void* x, const void* dw,
                                   const void* pw, const void* b, void* out,
                                   int batch, int length, int c_in, int c_out,
                                   int k, int stride, int relu, int dtype,
                                   int l_out, void* stream) {
  if (batch < 0 || c_in < 1 || c_in > kMaxCin || c_out < 1 ||
      c_out > kMaxCout || length < k || l_out != (length - k) / stride + 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Args a{x, dw, pw, b, out, batch, length, c_in, c_out, l_out, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, k, stride, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, k, stride, s);
  return (int)cudaErrorInvalidValue;
}
