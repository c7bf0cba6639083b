// Blocked online-softmax attention (forward) for Hopper (sm_90a).
//
//   q [B, H, Sq, d], k/v [B, H, Skv, d] (f32, bf16 or f16, all three alike)
//   -> out [B, H, Sq, d] in q's dtype,
//   out = softmax(q k^T * scale [+ causal fill]) v,  scale = f32(1/sqrt(d)),
//
// with f32 scores, softmax and sums, one rounding at the store. Causal: key
// position > query position (absolute positions, top-left aligned also when
// Sq != Skv) scores -1e30, a finite fill, so exp(m_prev - m_cur) never sees
// -inf - (-inf); the denominator is clamped at 1e-30.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (pl.pallas_call at :87), whose sequential kv grid
// axis carries the running max, denominator and accumulator in VMEM
// scratch, so the [Sq, Skv] score matrix never exists. Here a loop over key
// tiles inside the block takes that axis's place; the heaviest causal query
// tiles start first, and key tiles wholly above the diagonal are skipped.
//
// Two routes, chosen by the caller from dtype and d before the launch:
//
// * Tensor cores (flash_attention_tc_launch): bf16 or f16 inputs, d <= 128.
//   The FlashAttention-2 shape on Hopper's warpgroup MMA: one block of 2
//   warpgroups per (b*h, 128-query tile), each warpgroup owning 64 query
//   rows. 64-key K and V tiles stream through shared memory,
//   double-buffered with cp.async, stored in wgmma's 128-byte swizzle
//   (1024-byte aligned tiles). q k^T runs as wgmma m64n64k16 with Q and K
//   both read from shared memory through descriptors, f32 accumulators (a
//   product of two 16-bit values is exact in f32, so only the summation
//   order differs from the f32 reference). The running max and sum live on
//   the accumulator fragments, reduced over the 4 threads that share a
//   row; the exponentials are expf, as on the CUDA-core route. The
//   accumulator fragment of S becomes P's A fragment in registers (no
//   round trip through shared memory), and P V runs as wgmma
//   m64nDk16 with V read MN-major from shared memory (no transpose pass).
//   P is f32 in the reference, so it is split as P_hi = T(P), P_lo =
//   T(P - P_hi) in the input type T and P V is two MMAs, accurate to about
//   2^-17 of P: a single rounding of P does not hold one rounding step of
//   the output type against the f32 reference (the CPU emulation in
//   tests/test_torch_dot_flash.py shows it at causal shapes). Each group
//   of MMAs is waited for before its result is read (no overlap of
//   softmax and MMAs within a warpgroup; the block's other warpgroup and
//   the SM's other block fill the gaps). A warpgroup skips a causal key
//   tile that lies wholly after its rows (its weights there are exactly
//   0). d < 64 pads to 64, 64 < d < 128 to 128, with zeros on load. Shared
//   memory: Q plus two K/V stages, 96 KB at d = 128, two blocks per SM.
//   What bounds it: operations. One qwen1.5-32b layer at S = 4,096 (B 1,
//   H 40, d 128, causal) is 171.8 GFLOP of products of 16-bit values, 0.174
//   ms at the 989 TFLOP/s dense bf16 rate (the split P adds a third MMA
//   pass, 257.7 GFLOP issued); its 168 MB of q/k/v/out take 0.050 ms.
//
// * CUDA cores (flash_attention_launch): f32 inputs at any d <= 256, and
//   bf16/f16 inputs with 128 < d <= 256. One block (256 threads, a 16 x 16
//   grid) per (b*h, 64-row query tile); the query tile and each 64-key K
//   and V tile are staged in f32 shared memory (rows padded so different
//   rows fall in different banks); each thread computes a 4 x 4 tile of
//   scores; the 16 threads of a row reduce its max and sum with warp
//   shuffles; the running max, denominator and a 4 x d/16 slice of the
//   output accumulator stay in f32 registers; P goes to shared memory (over
//   the spent K tile) and each thread adds P V into its slice. d pads to
//   64, 128 or 256. Bound: operations at the 67 TFLOP/s f32 rate (the bench
//   shape B 2, H 8, S 2,048, d 128, causal: 17.2 GFLOP, 0.257 ms).
//
// C interface (loaded with ctypes): each launch runs on the caller's
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

// ---------------------------------------------------------------------------
// tensor-core route: bf16/f16, d <= 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarpgroups = 2;           // 64 query rows each
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQt = 64 * kWarpgroups;   // query rows per block

// Shared-memory tiles of 64 rows of 16-bit values in wgmma's 128-byte
// swizzle: a [64][D] tile is D/64 column blocks of [64 rows][128 bytes],
// and the 16-byte chunks of a row are XOR-swizzled with row % 8. Byte
// offset of chunk c of row r of a stack of such tiles:
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((r >> 6) * (64 * D * 2) + (c >> 3) * 8192 +
                               (r & 63) * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor of a tile in that layout: start address,
// leading and stride byte offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// cp.async writes through the generic proxy; wgmma reads through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// One warpgroup MMA, m64 x n x k16, f32 accumulators d (per warp and n8
// block the m16n8 fragment layout); accumulate == 0 overwrites d. ss: A and
// B from shared memory, both K-major. rs: A from registers (the m16n8k16 A
// fragment per warp), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_ss_n64_bf16(float (&d)[32], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64_bf16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128_bf16(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64_f16(float (&d)[32], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64_f16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128_f16(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// the 16-bit type's MMAs and its split of two f32 values
template <typename T> struct Ops;
template <> struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
    wgmma_ss_n64_bf16(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    wgmma_rs_n64_bf16(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
    wgmma_rs_n128_bf16(d, a, b, acc);
  }
  // (hi, lo) of the pair (x, y): hi = T(x), lo = T(x - hi), the first
  // element in the low half
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};
template <> struct Ops<__half> {
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
    wgmma_ss_n64_f16(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    wgmma_rs_n64_f16(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
    wgmma_rs_n128_f16(d, a, b, acc);
  }
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const __half2 l = __floats2half2_rn(x - __low2float(h),
                                        y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};

// Stage rows [0, rows) of a [*, dim] 16-bit matrix (rows beyond and
// columns past dim as zeros) into R rows of swizzled tiles. vec: dim % 8
// == 0 and 16-byte aligned rows, so each chunk is one cp.async (a
// zero-filling one past the edge); otherwise elements are gathered and
// stored directly.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const uint16_t* __restrict__ g,
                                          int rows, int dim, bool vec,
                                          int tid) {
  constexpr int kChunks = D / 8;
  for (int e = tid; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int col = c * 8;
    const uint32_t dst = tile + swz<D>(r, c);
    if (vec) {
      const bool in = r < rows && col < dim;
      cp_async16(dst, in ? g + static_cast<int64_t>(r) * dim + col : g,
                 in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t lo = 0, hi = 0;
        const int c0 = col + 2 * j;
        if (r < rows && c0 < dim) lo = g[static_cast<int64_t>(r) * dim + c0];
        if (r < rows && c0 + 1 < dim)
          hi = g[static_cast<int64_t>(r) * dim + c0 + 1];
        w[j] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q (kBQt rows) + 2 x (K, V) 64-row tiles, and room to align to 1024
  return static_cast<size_t>(kBQt + 4 * kBK) * D * 2 + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_tc_kernel(const uint16_t* __restrict__ q,
                              const uint16_t* __restrict__ k,
                              const uint16_t* __restrict__ v,
                              T* __restrict__ out, int sq, int skv, int dim,
                              int causal, float scale, int vec) {
  constexpr int NK = D / 16;             // k16 steps of q k^T
  constexpr int NO = D / 8;              // n8 blocks of the output
  constexpr uint32_t kTile = 64 * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t s_q =
      (static_cast<uint32_t>(__cvta_generic_to_shared(tc_smem)) + 1023u) &
      ~1023u;
  const uint32_t s_kv = s_q + kWarpgroups * kTile;  // stage s at 2s kTile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQt;  // heavy tiles first
  const int q_rows = min(kBQt, sq - q0);
  const int w0 = q0 + warp * 16;         // this warp's first row
  const int wg0 = q0 + wg * 64;          // this warpgroup's first row
  const uint16_t* qb = q + (bh * sq + q0) * dim;
  const uint16_t* kb = k + bh * skv * dim;
  const uint16_t* vb = v + bh * skv * dim;
  const int kv_end = causal ? min(skv, q0 + q_rows) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  load_tile<D, kBQt>(s_q, qb, q_rows, dim, vec, tid);
  if (n_tiles > 0) {
    load_tile<D, kBK>(s_kv, kb, min(kBK, skv), dim, vec, tid);
    load_tile<D, kBK>(s_kv + kTile, vb, min(kBK, skv), dim, vec, tid);
  }
  cp_async_commit();

  // rows r0 (elements 0, 1 of each n8 block's fragment) and r0 + 8 (2, 3)
  float o[NO * 4];
#pragma unroll
  for (int e = 0; e < NO * 4; ++e) o[e] = 0.0f;
  const int r0 = w0 + g;
  float m[2] = {kNegFill, kNegFill}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    if (i + 1 < n_tiles) {
      const uint32_t nxt = s_kv + 2 * ((i + 1) & 1) * kTile;
      const int64_t off = static_cast<int64_t>(k0 + kBK) * dim;
      const int rows = min(kBK, skv - k0 - kBK);
      load_tile<D, kBK>(nxt, kb + off, rows, dim, vec, tid);
      load_tile<D, kBK>(nxt + kTile, vb + off, rows, dim, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // Q and tile i have landed
    fence_proxy_async();
    __syncthreads();
    if (causal && k0 > wg0 + 63) {       // every key after every row of
      __syncthreads();                   // this warpgroup: weights all 0
      continue;
    }
    const uint32_t s_k = s_kv + 2 * (i & 1) * kTile;
    const uint32_t s_v = s_k + kTile;

    // S = Q K^T, 64 rows x 64 keys per warpgroup: k16 steps are 32 bytes
    // within a 128-byte column block, 8-row groups 1024 bytes apart
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t ko = (kk >> 2) * 8192 + (kk & 3) * 32;
      Ops<T>::ss64(s, desc(s_q + wg * kTile + ko, 16, 1024),
                   desc(s_k + ko, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait();

    // scale, mask where the tile crosses the diagonal or the last key
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > w0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * scale;
      if (edge) {
        const int key = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
        if (key >= skv) x = -INFINITY;            // no such key: weight 0
        else if (causal && key > r0 + 8 * ((e >> 1) & 1)) x = kNegFill;
      }
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_cur = fmaxf(m[r], mx[r]);   // finite: key k0 exists
      alpha[r] = expf(m[r] - m_cur);
      m[r] = m_cur;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = expf(s[e] - m[(e >> 1) & 1]);
      s[e] = p;
      l[(e >> 1) & 1] += p;
    }
#pragma unroll
    for (int e = 0; e < NO * 4; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V: P from S's fragments split in two; V (keys x D) MN-major,
    // k16 steps of two 8-row groups, its 64-column blocks 8192 bytes apart
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        Ops<T>::split(s[8 * j + 2 * h], s[8 * j + 2 * h + 1], ph[j][h],
                      pl[j][h]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = desc(s_v + j * 2048, 8192, 1024);
      if constexpr (D == 128) {
        Ops<T>::rs128(o, ph[j], dv, 1);
        Ops<T>::rs128(o, pl[j], dv, 1);
      } else {
        Ops<T>::rs64(o, ph[j], dv, 1);
        Ops<T>::rs64(o, pl[j], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    __syncthreads();                     // stage i & 1 is free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = r0 + 8 * r;
    if (row - q0 >= q_rows) continue;
    T* orow = out + (bh * sq + row) * dim;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int col = c * 8 + 2 * t;
      if (col < dim) orow[col] = from_f32<T>(o[4 * c + 2 * r] / den);
      if (col + 1 < dim)
        orow[col + 1] = from_f32<T>(o[4 * c + 2 * r + 1] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int sq, int skv, int dim, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v);
  const int vec = dim % 8 == 0 && any % 16 == 0;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBQt - 1) / kBQt));
  flash_attention_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<T*>(out), sq, skv, dim,
      causal, scale, vec);
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
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// The CUDA-core route. dtype: 0 f32, 1 bf16, 2 f16; dim <= 256.
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

// The tensor-core route: dtype 1 bf16, 2 f16; dim <= 128.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int64_t bh,
                                         int sq, int skv, int dim, int causal,
                                         float scale, int dtype,
                                         cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || dim <= 0)
    return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case 1:
      return tc::launch_dim<__nv_bfloat16>(q, k, v, out, bh, sq, skv, dim,
                                           causal, scale, stream);
    case 2:
      return tc::launch_dim<__half>(q, k, v, out, bh, sq, skv, dim, causal,
                                    scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
