// The decoder layer's glue for Hopper (sm_90a): the elementwise work
// between its products, fused into three kernels.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses a layer's norms, rotary
// embedding and activation into the products around them; PyTorch runs
// each op as a kernel of its own, about 76 a layer (an RMSNorm alone is 8:
// cast, square, mean, add, rsqrt, two products, cast).  These three
// kernels do the same arithmetic in one launch each, every intermediate in
// registers:
//
//   glue_add_rmsnorm  h = bf16(x + a) (x where there is no a), and
//                     y = bf16(f32(h) * rsqrt(mean(f32(h)^2) + eps) * scale)
//                     x, a, h, y (rows, d) bf16; scale (d,) f32 or bf16
//   glue_rope         q and k rotated at their positions (half-split, as
//                     models/common.py: apply_rope), q to q_out; k to k_out
//                     or, with v, into a paged pool at (blk, off) per row
//                     q (T, H, hd), k, v (T, KVH, hd) bf16, T = B * S
//                     positions (B, S) int32 or int64 by strides, plus
//                     pos_add, or none (position s); inv_freq (hd/2,) f32,
//                     rope_freqs'
//                     pools (P, BS, KVH, hd); blk, off (B,) int64, blk < 0
//                     writes nothing
//   glue_swiglu       out = bf16(bf16(silu(g)) * u), g, u, out (n,) bf16
//
// Every rounding of the PyTorch ops they replace is kept: each product,
// sum and difference is one __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// does not contract them into FMAs (PyTorch's kernels round each op), and
// the transcendentals are the precise cosf, sinf, expf and rsqrtf that
// PyTorch's own kernels call (angles reach 2047 rad: no __sinf).  RoPE,
// SwiGLU and the add therefore equal the PyTorch ops bit for bit.  The
// norm's sum of squares is taken in another order than torch.mean's, so
// its output may differ from PyTorch's by one bf16 ulp.
//
// What bounds them: memory, and at decode the launch itself.  Each reads
// its inputs once and writes its outputs once; at mistral-large-123b's
// decode step (64 rows, d 12288) a norm moves 6.3 MB, ~2 us at 3.35
// TB/s, about one launch's cost, where PyTorch's eight launches moved the
// row five times more.  Design:
// * One block a row for the norm (the reduction stays in the block: warp
//   shuffles, then one word a warp in shared memory), up to 1024 threads,
//   so that the decode step's 64 rows still keep many loads in flight.
//   The first pass writes h and sums its squares; the second reads back
//   the h this thread wrote (L1/L2) and scales it.
// * One block a token for RoPE: its hd/2 angles' cosines and sines are
//   computed once into shared memory and serve all H + KVH heads.  The
//   decode step's form also copies the row's v beside its rotated k into
//   the pool, which replaces two index_put_ launches.
// * 16-byte loads and stores (8 bf16) wherever the widths and pointers
//   allow it, single elements otherwise.
// No host sync and no allocation, so a CUDA graph can capture them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// N consecutive bf16 elements (16-byte aligned where N is 8) as f32.
template <int N>
__device__ __forceinline__ void load(const bf16* p, float (&o)[N]) {
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load(const float* p, float (&o)[N]) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// N f32 values rounded to bf16 (round to nearest even) and stored.
template <int N>
__device__ __forceinline__ void store(bf16* p, const float (&o)[N]) {
  if constexpr (N == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(o[i]);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum of every thread's v, in every thread (blockDim.x a multiple of
// 32, at most 1024).  A fixed order: the result does not vary by run.
__device__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

// ---------------------------------------------------------------------------
// Residual add + RMSNorm: one block a row
// ---------------------------------------------------------------------------

template <int N, bool kAdd, typename S>
__global__ void glue_add_rmsnorm(const bf16* __restrict__ x,
                                 const bf16* __restrict__ a,
                                 const S* __restrict__ scale,
                                 bf16* __restrict__ h, bf16* __restrict__ y,
                                 int d, float eps) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * d;
  const bf16* hr = kAdd ? h + at : x + at;
  const int nv = d / N;
  float ss = 0.f;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    float v[N];
    load<N>(x + at + j * N, v);
    if constexpr (kAdd) {
      float w[N];
      load<N>(a + at + j * N, w);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = round_bf16(__fadd_rn(v[e], w[e]));
      store<N>(h + at + j * N, v);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
  }
  ss = block_sum(ss);
  // torch.mean multiplies the sum by 1/d; torch.rsqrt is rsqrtf
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / d), eps));
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    float v[N], s[N];
    load<N>(hr + j * N, v);
    load<N>(scale + j * N, s);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = __fmul_rn(__fmul_rn(v[e], r), s[e]);
    store<N>(y + at + j * N, v);
  }
}

template <int N, typename S>
cudaError_t launch_norm(const void* x, const void* a, const void* scale,
                        void* h, void* y, int rows, int d, float eps,
                        cudaStream_t stream) {
  const int nv = d / N;
  int threads = ((nv + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > 1024 ? 1024 : threads;
  const bf16* xb = static_cast<const bf16*>(x);
  const S* sc = static_cast<const S*>(scale);
  bf16* yb = static_cast<bf16*>(y);
  if (a != nullptr) {
    glue_add_rmsnorm<N, true, S><<<rows, threads, 0, stream>>>(
        xb, static_cast<const bf16*>(a), sc, static_cast<bf16*>(h), yb, d,
        eps);
  } else {
    glue_add_rmsnorm<N, false, S><<<rows, threads, 0, stream>>>(
        xb, nullptr, sc, nullptr, yb, d, eps);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// RoPE on q and k (and the paged K/V write): one block a token
// ---------------------------------------------------------------------------

struct Rope {
  const bf16* q;
  const bf16* k;
  const bf16* v;          // pool write only
  const void* pos;        // (B, S) by strides, plus pos_add; null: s
  int pos_i64;
  int64_t pos_sb, pos_ss;
  int pos_add;
  const float* inv_freq;  // (hd/2,)
  bf16* q_out;
  bf16* k_out;            // null in the pool write
  bf16* k_pool;           // (P, BS, KVH, hd), null but in the pool write
  bf16* v_pool;
  const int64_t* blk;     // (B,)
  const int64_t* off;
  int S, H, KVH, hd, bs;
};

template <int N>
__global__ void glue_rope(Rope p) {
  extern __shared__ float cs[];   // cos (hd/2), then sin (hd/2)
  const int64_t t = blockIdx.x;
  const int64_t b = t / p.S, s = t % p.S;
  const int half = p.hd / 2;
  int64_t pos = s;
  if (p.pos != nullptr) {
    const int64_t i = b * p.pos_sb + s * p.pos_ss;
    pos = (p.pos_i64 ? static_cast<const int64_t*>(p.pos)[i]
                     : static_cast<const int*>(p.pos)[i]) + p.pos_add;
  }
  // torch: positions.to(float32) * freqs, then cos and sin of that
  const float fpos = static_cast<float>(pos);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float ang = __fmul_rn(fpos, p.inv_freq[i]);
    cs[i] = cosf(ang);
    cs[half + i] = sinf(ang);
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(p.KVH) * p.hd;
  bf16* kd = nullptr;
  bf16* vd = nullptr;
  if (p.k_pool == nullptr) {
    kd = p.k_out + t * row;
  } else if (p.blk[b] >= 0) {
    const int64_t slot = p.blk[b] * p.bs + p.off[b];
    kd = p.k_pool + slot * row;
    vd = p.v_pool + slot * row;
  }
  const int nvh = half / N;
  const int work = (p.H + (kd != nullptr ? p.KVH : 0)) * nvh;
  for (int w = threadIdx.x; w < work; w += blockDim.x) {
    const int head = w / nvh, j = (w - head * nvh) * N;
    const bf16* src;
    bf16* dst;
    if (head < p.H) {
      src = p.q + (t * p.H + head) * p.hd;
      dst = p.q_out + (t * p.H + head) * p.hd;
    } else {
      src = p.k + t * row + static_cast<int64_t>(head - p.H) * p.hd;
      dst = kd + static_cast<int64_t>(head - p.H) * p.hd;
    }
    float x1[N], x2[N], o1[N], o2[N];
    load<N>(src + j, x1);
    load<N>(src + half + j, x2);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float c = cs[j + e], sn = cs[half + j + e];
      o1[e] = __fsub_rn(__fmul_rn(x1[e], c), __fmul_rn(x2[e], sn));
      o2[e] = __fadd_rn(__fmul_rn(x2[e], c), __fmul_rn(x1[e], sn));
    }
    store<N>(dst + j, o1);
    store<N>(dst + half + j, o2);
  }
  if (vd != nullptr) {
    const bf16* vs = p.v + t * row;
    for (int64_t j = threadIdx.x * N; j < row; j += blockDim.x * N) {
      float v[N];
      load<N>(vs + j, v);
      store<N>(vd + j, v);
    }
  }
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// SwiGLU: a grid-stride loop over the elements
// ---------------------------------------------------------------------------

template <int N>
__global__ void glue_swiglu(const bf16* __restrict__ g,
                            const bf16* __restrict__ u,
                            bf16* __restrict__ out, int64_t nv) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nv; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float gv[N], uv[N];
    load<N>(g + i * N, gv);
    load<N>(u + i * N, uv);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      // F.silu in f32 (x / (1 + exp(-x))), rounded to bf16; then the
      // bf16 product's f32 multiply
      const float sl = round_bf16(__fdiv_rn(gv[e], __fadd_rn(1.f, expf(-gv[e]))));
      gv[e] = __fmul_rn(sl, uv[e]);
    }
    store<N>(out + i * N, gv);
  }
}

}  // namespace

// x, a (rows, d) bf16, a null for the norm alone (h is then not written);
// scale (d,) f32 (scale_dtype 0) or bf16 (1); h, y (rows, d) bf16
extern "C" int glue_add_rmsnorm_launch(const void* x, const void* a,
                                       const void* scale, void* h, void* y,
                                       int rows, int d, float eps,
                                       int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0 || scale_dtype < 0 || scale_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 8 == 0 && aligned(x) && aligned(a) && aligned(h) &&
                   aligned(y) && aligned(scale);
  if (scale_dtype == 0) {
    return static_cast<int>(
        vec ? launch_norm<8, float>(x, a, scale, h, y, rows, d, eps, st)
            : launch_norm<1, float>(x, a, scale, h, y, rows, d, eps, st));
  }
  return static_cast<int>(
      vec ? launch_norm<8, bf16>(x, a, scale, h, y, rows, d, eps, st)
          : launch_norm<1, bf16>(x, a, scale, h, y, rows, d, eps, st));
}

// q (B*S, H, hd), k (B*S, KVH, hd) bf16; pos (B, S) int32 (pos_i64 0) or
// int64 (1) at strides (pos_sb, pos_ss), each plus pos_add (the decode
// step's kv_len - 1), or null; inv_freq (hd/2,) f32.
// k_pool null: rotated k to k_out (B*S, KVH, hd).  Else (S 1): rotated k
// and v to the pools (P, BS, KVH, hd) at row (blk[b], off[b]), none where
// blk[b] < 0; k_out unused.
extern "C" int glue_rope_launch(const void* q, const void* k, const void* v,
                                const void* pos, int pos_i64,
                                long long pos_sb, long long pos_ss,
                                int pos_add, const void* inv_freq,
                                void* q_out, void* k_out, void* k_pool,
                                void* v_pool,
                                const void* blk, const void* off, int B,
                                int S, int H, int KVH, int hd, int bs,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || hd <= 0 || hd % 2 ||
      (k_pool != nullptr && (S != 1 || bs <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rope p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), pos, pos_i64, pos_sb, pos_ss, pos_add,
         static_cast<const float*>(inv_freq), static_cast<bf16*>(q_out),
         static_cast<bf16*>(k_out), static_cast<bf16*>(k_pool),
         static_cast<bf16*>(v_pool), static_cast<const int64_t*>(blk),
         static_cast<const int64_t*>(off), S, H, KVH, hd, bs};
  const bool vec = (hd / 2) % 8 == 0 && aligned(q) && aligned(k) &&
                   aligned(v) && aligned(q_out) && aligned(k_out) &&
                   aligned(k_pool) && aligned(v_pool);
  const size_t smem = sizeof(float) * hd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = B * S;
  if (vec) {
    glue_rope<8><<<grid, 128, smem, st>>>(p);
  } else {
    glue_rope<1><<<grid, 128, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// g, u, out (n,) bf16
extern "C" int glue_swiglu_launch(const void* g, const void* u, void* out,
                                  long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 8 == 0 && aligned(g) && aligned(u) && aligned(out);
  const long long nv = vec ? n / 8 : n;
  long long blocks = (nv + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* ub = static_cast<const bf16*>(u);
  bf16* ob = static_cast<bf16*>(out);
  if (vec) {
    glue_swiglu<8><<<static_cast<int>(blocks), 256, 0, st>>>(gb, ub, ob, nv);
  } else {
    glue_swiglu<1><<<static_cast<int>(blocks), 256, 0, st>>>(gb, ub, ob, nv);
  }
  return static_cast<int>(cudaGetLastError());
}
