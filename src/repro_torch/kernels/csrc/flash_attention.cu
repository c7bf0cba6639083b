// Blocked online-softmax attention (forward) for Hopper (sm_90a).
//
//   q [B, H, Sq, d], k/v [B, H, Skv, d] (f32, bf16 or f16, all three alike)
//   -> out [B, H, Sq, d] in q's dtype,
//   out = softmax(q k^T * scale [+ causal fill]) v,  scale = f32(1/sqrt(d)),
//
// computed in f32 throughout (inputs converted on load), one rounding at
// the store. Causal: key position > query position (absolute positions,
// top-left aligned also when Sq != Skv) scores -1e30, a finite fill, so
// exp(m_prev - m_cur) never sees -inf - (-inf); the denominator is clamped
// at 1e-30. Any d <= 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (pl.pallas_call at :87), whose sequential kv grid
// axis carries the running max, denominator and accumulator in VMEM
// scratch, so the [Sq, Skv] score matrix never exists.
//
// What bounds it on the H100: operations. One layer of qwen1.5-32b at
// S = 4,096 (B 1, H 40, d 128, bf16, causal) is 85.9 GFLOP of q k^T, on
// bf16 values (0.087 ms at the 989 TFLOP/s bf16 tensor rate: each product
// of two bf16 values is exact in f32), and 85.9 GFLOP of P V with f32 P
// (1.28 ms at the 67 TFLOP/s f32 rate): 1.37 ms, against 0.05 ms for its
// 168 MB of q/k/v/out. In f32 all 171.8 GFLOP run at the f32 rate.
//
// Design: one block (256 threads, a 16 x 16 grid) per (b*h, 64-row query
// tile); the heaviest causal tiles start first. The block stages its query
// tile in shared memory, then walks the 64-key tiles in order, up to the
// last one that holds a key at or before its last query (tiles wholly
// above the diagonal are skipped). Per key tile: K and V are staged in
// shared memory (rows padded so different rows fall in different banks);
// each thread computes a 4 x 4 tile of scores (rows ty + 16 i, keys
// tx + 16 c) from shared memory; the 16 threads of a row reduce its max
// and sum with warp shuffles; the running max, denominator and a 4 x d/16
// slice of the output accumulator stay in f32 registers; P goes to shared
// memory (over the spent K tile) and each thread adds P V into its slice.
// Tensor cores (mma/wgmma, TMA) are later work: the reference computes in
// f32, and so does this kernel, on the CUDA cores.
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_convert.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr float kNegFill = -1e30f;       // the causal fill and the initial max

// reduce over the 16 lanes of a half warp (one row's threads)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [kBQ][D+1], K [kBK][D+1] (later P [kBQ][kBK+1]), V [kBK][D]
  return (static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int skv, int dim, int causal, float scale) {
  static_assert(kBQ * (kBK + 1) <= kBK * (D + 1), "P must fit over K");
  constexpr int NC = D / 16;             // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * (D + 1);
  float* sP = sK;
  float* sV = sK + kBK * (D + 1);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy tiles first
  const int q_rows = min(kBQ, sq - q0);
  const T* qb = q + (bh * sq + q0) * dim;
  const T* kb = k + bh * skv * dim;
  const T* vb = v + bh * skv * dim;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[r * (D + 1) + c] =
        (r < q_rows && c < dim) ? to_f32(qb[r * dim + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegFill;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // keys up to the last query row's position (causal), else all
  const int kv_end = causal ? min(skv, q0 + q_rows) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int k_rows = min(kBK, skv - k0);
    __syncthreads();                     // the last tile's P and V are spent
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = r < k_rows && c < dim;
      const int64_t g = static_cast<int64_t>(k0 + r) * dim + c;
      sK[r * (D + 1) + c] = in ? to_f32(kb[g]) : 0.0f;
      sV[r * D + c] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < dim; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * (D + 1) + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sK[(tx + 16 * c) * (D + 1) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float val = s[i][c] * scale;
        if (kpos >= skv) val = -INFINITY;            // no such key: weight 0
        else if (causal && kpos > qpos) val = kNegFill;
        s[i][c] = val;
        mx = fmaxf(mx, val);
      }
      const float m_cur = fmaxf(m[i], row_max(mx));  // finite: key k0 exists
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_cur);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_cur;
    }
    __syncthreads();                     // every read of this K tile is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sP[(ty + 16 * i) * (kBK + 1) + tx + 16 * c] = s[i][c];
    __syncthreads();

    for (int j = 0; j < k_rows; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * sq + q0 + r) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dim) o[col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int sq, int skv, int dim, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, dim, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out,
               int64_t bh, int sq, int skv, int dim, int causal, float scale,
               cudaStream_t stream) {
  if (dim <= 64)
    return launch<T, 64>(q, k, v, out, bh, sq, skv, dim, causal, scale,
                         stream);
  if (dim <= 128)
    return launch<T, 128>(q, k, v, out, bh, sq, skv, dim, causal, scale,
                          stream);
  if (dim <= 256)
    return launch<T, 256>(q, k, v, out, bh, sq, skv, dim, causal, scale,
                          stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t bh,
                                      int sq, int skv, int dim, int causal,
                                      float scale, int dtype,
                                      cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || dim <= 0)
    return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, out, bh, sq, skv, dim, causal, scale,
                               stream);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, out, bh, sq, skv, dim, causal,
                                       scale, stream);
    case 2:
      return launch_dim<__half>(q, k, v, out, bh, sq, skv, dim, causal, scale,
                                stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
