// Causal GQA flash attention (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:71 flash_attention_pallas
//   (pallas_call at :95, body _kernel at :28-68),
// used with causal=True over a full sequence, the product
// attention_prefill needs (src/repro/models/attention.py runs it as
// chunked_attention).
//
//   q    (B, S, H, hd)    f32 or bf16
//   k, v (B, S, KVH, hd)  q's dtype; head h reads KV head h / (H / KVH)
//   out  (B, S, H, hd)    q's dtype
// Query i attends to keys 0..i.  q is scaled by 1/sqrt(hd) in f32 before
// the dot, as chunked_attention does; scores, the online softmax and the
// sums are f32.
//
// The TPU kernel walks a sequential grid axis over KV blocks with the
// running max, denominator and accumulator in VMEM scratch, and skips the
// blocks above the diagonal with pl.when.  Blocks on this card run in no
// order, so one thread block owns kBQ = 64 query rows of one (b, h) and
// loops over the KV tiles itself, only up to its last row (the causal
// skip); the ragged last tile of queries and keys is masked here, so S
// needs no padding.  The blocks with the longest row ranges start first.
//
// Per KV tile of kBK = 32 keys: K goes to shared memory, each thread forms
// a 4 x 2 block of scores (rows ty + 16 i, keys tx + 16 j) from the f32 Q
// tile in shared memory, the 16 lanes of a row reduce max and sum with
// shuffles, the probabilities go to shared memory, V replaces K, and each
// thread accumulates 4 rows x hd/16 output dims (tx + 16 k) in registers.
// Rows are padded by one float so column reads hit distinct banks.  Shared
// memory: (64 + 32) (hd + 1) + 64 * 33 floats, 58 KB at hd 128, so the
// kernel asks for dynamic shared memory above 48 KB once per device.
//
// What bounds it: operations.  A call does 4 hd flops per (query, key)
// pair on or below the diagonal, about 2 S^2 hd H in all, against
// 2 S hd (H + 2 KVH) elements moved: at S 700, hd 128 hundreds of flops a
// byte.  This first kernel runs them as f32 FMAs on the CUDA cores (the
// reference computes in f32 too); a tensor-core (wgmma) version, and
// sharing K/V tiles between the heads of a KV group, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows a block owns
constexpr int kBK = 32;         // keys a tile
constexpr int kRows = kBQ / 16; // rows a thread owns
constexpr int kKeys = kBK / 16; // scores a thread forms per row and tile
constexpr int kLP = kBK + 1;    // padded probability row
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (HD + 1) + kBQ * kLP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int H, int KVH, float scale) {
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
  const T* qb = q + static_cast<size_t>(b) * S * q_row + h * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + g * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + g * HD;

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int qi = q0 + r;
    sq[r * LD + d] = qi < S ? to_float(qb[qi * q_row + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], o[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] = 0.f;
  }

  const int kv_end = min(q0 + kBQ, S);  // keys any row of the tile sees
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q stored; the previous tile's V reads done
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i % HD;
      const int kj = k0 + c;
      skv[c * LD + d] = kj < S ? to_float(kb[kj * kv_row + d]) : 0.f;
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
        if (kj >= S || kj > qi) s[i][j] = -INFINITY;
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
      skv[c * LD + d] = kj < S ? to_float(vb[kj * kv_row + d]) : 0.f;
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

  T* ob = out + static_cast<size_t>(b) * S * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        store(ob + qi * q_row + tx + 16 * dd, o[i][dd] / den);
      }
    }
  }
}

// Lets the kernel use more than 48 KB of dynamic shared memory; set once
// per device (a graph capture then replays launches without it).
template <typename T, int HD>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<HD>()));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KVH, cudaStream_t stream) {
  const cudaError_t err = configure<T, HD>();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KVH, int hd,
                     cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, out, B, S, H, KVH, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, B, S, H, KVH, stream);
    case 112:
      return launch_hd<T, 112>(q, k, v, out, B, S, H, KVH, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, B, S, H, KVH, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KVH, int hd, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch_t<float>(q, k, v, out, B, S, H, KVH, hd, st));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch_t<__nv_bfloat16>(q, k, v, out, B, S, H, KVH, hd, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
