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
// tile is kTile output positions of one record and every output channel of
// them, and nothing is padded in device memory.
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
// summation order of its own); the pointwise sum runs over C_in with FMAs
// into four partial sums (channel c into sum c % 4, combined pairwise),
// then adds the bias: its rounding error is about half that of one
// running sum, and the four chains are independent.
//
// What bounds it: memory, closely followed by f32 issue.  A call reads x
// once and writes out once; per output position it does K C_in multiplies
// and as many adds (not fused: the plain version rounds each) and C_in
// C_out FMAs, ~1,500 f32 instructions for C_in = C_out = 32 at K 7,
// against (C_in + C_out) * 4 = 256 bytes moved.  The widest layer of the
// ECG path at batch 256, (256, 3744, 32) -> (256, 3738, 32) in f32, moves
// ~245 MB: 0.073 ms at 3.35 TB/s, and its ~1.4 G instructions take ~0.05
// ms at the full f32 rate; reaching half the byte bound needs both at
// once.  The port's first kernel (one output a thread, both operands of
// every FMA from shared memory, plain loads) was held by shared-memory
// loads at 5x that bound (0.36 ms on an H100).
//
// Design.  A persistent grid (as many blocks as fit on the card at once)
// walks the (record, tile) pairs; each block copies dw, pw and b into
// shared memory once, as f32.  For each tile:
//   * the input window, (kTile - 1) * stride + K rows x C_in (one
//     contiguous run of device memory), arrives by cp.async into a
//     two-stage ring: the next tile's window is in flight while the block
//     computes this one (one stage where two do not fit in shared memory;
//     the copy then overlaps the pointwise stage only).  The copies are 16
//     bytes where every record's rows start on 16 bytes, else 4 bytes
//     where they start on 4 (bf16 C_in 2 at L 3750), else plain loads;
//   * depthwise: a thread takes one channel and a run of kRun = 8
//     positions, holds the (kRun - 1) * stride + K input values it needs
//     in registers (each read from shared memory once, a warp's 32
//     channels from one row: no bank conflicts) and writes its 8 results
//     as two 16-byte stores into a channel-major tile (rows of kTile + 4
//     floats, so the 8 threads of a store phase hit distinct banks);
//   * pointwise: a thread makes a 4 position x 4 channel micro-tile, four
//     partial sums each, in registers: per input channel one 16-byte load
//     of 4 depthwise values and one of 4 pw values feed 16 FMAs (a warp's
//     lanes share both, so the loads are broadcasts), and each position's
//     4 channels leave as one 16-byte store (8 for bf16) into the tile's
//     contiguous run of device memory.  Where the grid has fewer tiles
//     than the card has SMs, a thread makes one output instead (the same
//     sums): such a call is held by latency, not by issue.
// Each output depends only on its own record and tile: no atomics, and a
// row's result does not depend on the rest of the batch or on which block
// computed it.
//
// Known limits: at the widest ECG layer the kernel is ~1.7x its byte bound
// and near the f32 issue rate (clock64 marks on an H100: the pointwise
// stage takes ~70% of a tile); the depthwise taps, multiplied and added
// with separate roundings, are ~45% as many instructions again as the
// pointwise FMAs.  Tensor cores would need a 3xTF32 or bf16x3 split to
// keep the 1e-5 gate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;       // output positions a tile
constexpr int kRun = 8;          // positions a thread's depthwise run
constexpr int kLdt = kTile + 4;  // depthwise tile row stride (floats)
constexpr int kMaxCin = 32;      // MAX_C_IN in kernels/conv1d/ops.py
constexpr int kMaxCout = 1024;   // MAX_C_OUT in kernels/conv1d/ops.py
static_assert(kTile % kRun == 0 && kTile % 4 == 0, "tile shape");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// Four outputs of one position, channels o..o+3, to consecutive addresses
// (16 bytes for f32, 8 for bf16; `vec` says they are aligned and whole).
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) p[j] = v[j];
    }
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4],
                                       int n, bool vec) {
  if (vec) {
    // round to nearest even, as torch's .to()
    const uint32_t lo = hopper::pack_bf16(v[0], v[1]);
    const uint32_t hi = hopper::pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) p[j] = __float2bfloat16(v[j]);
    }
  }
}

// 16-byte cp.async reading only the first `n` (<= 16) bytes of the source;
// the rest of the 16 destination bytes are written as zeros.
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}

// The same, 4 bytes (cp.async.ca).
__device__ __forceinline__ void cp_async4_n(void* smem, const void* gmem,
                                            int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}

__host__ __device__ constexpr int window_rows(int k, int s) {
  return (kTile - 1) * s + k;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared memory, in this order:
//   win  [stages][stage_bytes]  the tiles' input windows, x's dtype
//   dwt  [c_in][kLdt]           depthwise tile, f32, channel-major
//   wdw  [round4(K c_in)]       f32
//   wpw  [c_in][co4]            f32, C_out padded to co4 with zeros
//   bias [co4]                  f32
struct Layout {
  int stage_bytes, stages, co4;
  size_t bytes;
};

template <typename T, int K, int S>
__host__ __device__ Layout layout(int c_in, int c_out, int stages) {
  Layout l;
  l.stage_bytes = (window_rows(K, S) * c_in * (int)sizeof(T) + 15) / 16 * 16;
  l.stages = stages;
  l.co4 = round4(c_out);
  l.bytes = (size_t)stages * l.stage_bytes +
            sizeof(float) * ((size_t)c_in * kLdt + round4(K * c_in) +
                             (size_t)c_in * l.co4 + l.co4);
  return l;
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
    dwsep_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                        const T* __restrict__ pw, const T* __restrict__ b,
                        T* __restrict__ out, int length, int c_in, int c_out,
                        int l_out, int n_tiles, int total, int stages,
                        int unit, int fine, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<T, K, S>(c_in, c_out, stages);
  const int co4 = lay.co4;
  float* dwt = reinterpret_cast<float*>(smem + stages * lay.stage_bytes);
  float* wdw = dwt + c_in * kLdt;
  float* wpw = wdw + round4(K * c_in);
  float* bias = wpw + c_in * co4;

  // the window of `tile` into stage `buf`: rows p0*S .. (n_pos-1)*S + K
  auto copy = [&](int tile, int buf) {
    const int rec = tile / n_tiles;
    const int p0 = (tile - rec * n_tiles) * kTile;
    const int n_pos = min(kTile, l_out - p0);
    const int elems = ((n_pos - 1) * S + K) * c_in;
    const T* src = x + ((size_t)rec * length + (size_t)p0 * S) * c_in;
    T* dst = reinterpret_cast<T*>(smem + buf * lay.stage_bytes);
    const int bytes = elems * (int)sizeof(T);
    const char* s8 = reinterpret_cast<const char*>(src);
    char* d8 = reinterpret_cast<char*>(dst);
    if (unit == 16) {
      for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
        cp_async16_n(d8 + i, s8 + i, min(16, bytes - i));
    } else if (unit == 4) {
      for (int i = threadIdx.x * 4; i < bytes; i += kThreads * 4)
        cp_async4_n(d8 + i, s8 + i, min(4, bytes - i));
    } else {
      for (int i = threadIdx.x; i < elems; i += kThreads) dst[i] = src[i];
    }
    hopper::cp_async_commit();
  };

  int tile = blockIdx.x;
  copy(tile, 0);   // in flight while the weights load
  for (int i = threadIdx.x; i < K * c_in; i += kThreads)
    wdw[i] = to_f32(dw[i]);
  for (int i = threadIdx.x; i < c_in * co4; i += kThreads) {
    const int c = i / co4, o = i - c * co4;
    wpw[i] = o < c_out ? to_f32(pw[c * c_out + o]) : 0.f;
  }
  for (int i = threadIdx.x; i < co4; i += kThreads)
    bias[i] = i < c_out ? to_f32(b[i]) : 0.f;
  for (int it = 0; tile < total; ++it) {
    const int next = tile + gridDim.x;
    const int buf = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && next < total) {
      copy(next, buf ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // this window is in; the last tile's readers are done

    const int rec = tile / n_tiles;
    const int p0 = (tile - rec * n_tiles) * kTile;
    const int n_pos = min(kTile, l_out - p0);

    // depthwise: channel c, positions q0 .. q0 + kRun - 1 of the tile
    const T* win = reinterpret_cast<const T*>(smem + buf * lay.stage_bytes);
    constexpr int R = (kRun - 1) * S + K;
    for (int i = threadIdx.x; i < c_in * (kTile / kRun); i += kThreads) {
      const int run = i / c_in;
      const int c = i - run * c_in;
      const int q0 = run * kRun;
      if (q0 >= n_pos) continue;
      float w[K], xr[R];
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = wdw[k * c_in + c];
      const T* xp = win + q0 * S * c_in + c;
#pragma unroll
      for (int m = 0; m < R; ++m) xr[m] = to_f32(xp[m * c_in]);
      float d[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, __fmul_rn(xr[j * S + k], w[k]));
        d[j] = acc;
      }
      float4* dst = reinterpret_cast<float4*>(dwt + c * kLdt + q0);
      dst[0] = make_float4(d[0], d[1], d[2], d[3]);
      dst[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
    __syncthreads();  // dwt is complete; the window's stage is free
    if (stages == 1 && next < total) copy(next, 0);

    T* os = out + ((size_t)rec * l_out + p0) * c_out;
    if (fine) {
      // a grid too small to fill the card: one output a thread, the
      // shortest chain, the same sums (channel c into sum c % 4)
      for (int i = threadIdx.x; i < n_pos * c_out; i += kThreads) {
        const int p = i / c_out;
        const int o = i - p * c_out;
        const float* d = dwt + p;
        const float* w = wpw + o;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int c = 0;
        for (; c + 4 <= c_in; c += 4) {
          a0 = fmaf(d[c * kLdt], w[c * co4], a0);
          a1 = fmaf(d[(c + 1) * kLdt], w[(c + 1) * co4], a1);
          a2 = fmaf(d[(c + 2) * kLdt], w[(c + 2) * co4], a2);
          a3 = fmaf(d[(c + 3) * kLdt], w[(c + 3) * co4], a3);
        }
        if (c < c_in) a0 = fmaf(d[c * kLdt], w[c * co4], a0);
        if (c + 1 < c_in) a1 = fmaf(d[(c + 1) * kLdt], w[(c + 1) * co4], a1);
        if (c + 2 < c_in) a2 = fmaf(d[(c + 2) * kLdt], w[(c + 2) * co4], a2);
        const float yv = ((a0 + a1) + (a2 + a3)) + bias[o];
        store1(os + i, relu ? fmaxf(yv, 0.f) : yv);
      }
      tile = next;
      continue;
    }
    // pointwise: positions q0..q0+3, channels 4 cg..4 cg+3
    const int n_cg = co4 / 4;
    const bool vec_out = co4 == c_out;
    for (int i = threadIdx.x; i < (kTile / 4) * n_cg; i += kThreads) {
      const int pg = i / n_cg;
      const int cg = i - pg * n_cg;
      const int q0 = 4 * pg;
      if (q0 >= n_pos) continue;
      float a[4][4][4];   // [partial sum c % 4][position][channel]
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[u][p][j] = 0.f;
      const float* dp = dwt + q0;
      const float* wp = wpw + 4 * cg;
      int c = 0;
      for (; c + 4 <= c_in; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dp + (c + u) * kLdt);
          const float4 wv =
              *reinterpret_cast<const float4*>(wp + (c + u) * co4);
          const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
          const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[u][p][j] = fmaf(dd[p], ww[j], a[u][p][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (c + u < c_in) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dp + (c + u) * kLdt);
          const float4 wv =
              *reinterpret_cast<const float4*>(wp + (c + u) * co4);
          const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
          const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[u][p][j] = fmaf(dd[p], ww[j], a[u][p][j]);
        }
      }
      const float4 bv = *reinterpret_cast<const float4*>(bias + 4 * cg);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      const int n_ch = min(4, c_out - 4 * cg);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (q0 + p >= n_pos) break;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float yv = ((a[0][p][j] + a[1][p][j]) + (a[2][p][j] + a[3][p][j])) +
                     bb[j];
          v[j] = relu ? fmaxf(yv, 0.f) : yv;
        }
        store4(os + (size_t)(q0 + p) * c_out + 4 * cg, v, n_ch, vec_out);
      }
    }
    tile = next;
  }
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

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

template <typename T, int K, int S>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  Layout lay = layout<T, K, S>(a.c_in, a.c_out, 2);
  if (lay.bytes > (size_t)optin) lay = layout<T, K, S>(a.c_in, a.c_out, 1);
  if (lay.bytes > (size_t)optin) return cudaErrorInvalidValue;
  auto kernel = dwsep_conv1d_kernel<T, K, S>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)lay.bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, lay.bytes);
  if (e != cudaSuccess) return e;
  const int n_tiles = (a.l_out + kTile - 1) / kTile;
  const long long total = (long long)n_tiles * a.batch;
  if (total > 0x7fffffffLL || per_sm < 1) return cudaErrorInvalidValue;
  const long long grid =
      total < (long long)per_sm * sm_count() ? total
                                             : (long long)per_sm * sm_count();
  // the windows go by cp.async in the largest unit on which every
  // record's rows start (16 or 4 bytes), else by plain loads
  const size_t rec_bytes = (size_t)a.length * a.c_in * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.x);
  const int unit = base % 16 == 0 && rec_bytes % 16 == 0  ? 16
                   : base % 4 == 0 && rec_bytes % 4 == 0 ? 4
                                                         : 0;
  kernel<<<(unsigned)grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dw),
      static_cast<const T*>(a.pw), static_cast<const T*>(a.b),
      static_cast<T*>(a.out), a.length, a.c_in, a.c_out, a.l_out, n_tiles,
      (int)total, lay.stages, unit, total < sm_count(), a.relu);
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
