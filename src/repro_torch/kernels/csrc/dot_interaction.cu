// DLRM dot interaction for Hopper (sm_90a): per example, the strictly-lower
// triangle of X X^T, compacted.
//
//   x [B, F, d] (f32, bf16 or f16)  ->  out [B, F(F-1)/2] in x's dtype,
//   out[b, i(i-1)/2 + j] = sum_k x[b, i, k] * x[b, j, k]   for 0 <= j < i < F,
//
// the order of np.tril_indices(F, -1). Products and sums in f32, one
// rounding at the store.
//
// Replaces the TPU kernel src/repro/kernels/dot_interaction.py::
// dot_interaction_pallas (pl.pallas_call at :45), which runs the [F, d] x
// [d, F] product on the MXU and gathers the triangle in VMEM, so the
// [B, F, F] interaction tensor never reaches HBM.
//
// What bounds it on the H100: bytes. At the dlrm-mlperf shape (B = 65,536,
// F = 27, d = 128, f32) it reads 906 MB of features and writes 92 MB of
// interactions, ~0.30 ms at 3.35 TB/s, against 5.9 GFLOP of triangle
// (0.088 ms at the f32 rate); in bf16 the bytes halve and the products,
// of two bf16 values, count at the 989 TFLOP/s bf16 tensor rate.
//
// Design: a block stages E whole examples ([F, d] each, converted to f32)
// in shared memory, rows padded to d + 1 floats so that lanes reading
// different rows at the same k hit different banks. Each thread then
// computes one (example, pair) at a time: a d-long f32 dot of two staged
// rows, added in k order with fmaf, written straight to its compacted lane
// (consecutive threads, consecutive lanes: coalesced stores). The [F, F]
// product never exists, not even in shared memory. E is chosen so a block
// stages about 48 KB; a tile that does not fit the 227 KB a block may use
// is refused by the wrapper. Tensor cores and register tiling are later
// work: this kernel is bound by its shared-memory reads (two per FMA).
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 48 * 1024;   // aim per block
constexpr int kMaxExamples = 8;

// row i of the compacted lane p: the largest i with i(i-1)/2 <= p
__device__ __forceinline__ int tri_row(int p) {
  int i = static_cast<int>((1.0f + sqrtf(8.0f * p + 1.0f)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  return i;
}

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ x,
                                       T* __restrict__ out, int64_t batch,
                                       int nf, int dim, int per_block) {
  extern __shared__ float tile[];          // [per_block * nf][dim + 1]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int n_ex = batch - b0 < per_block ? static_cast<int>(batch - b0)
                                          : per_block;
  const int stride = dim + 1;
  const int n_in = n_ex * nf * dim;       // fits: it is staged in smem
  const T* src = x + b0 * nf * dim;
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    const int row = e / dim;
    tile[row * stride + (e - row * dim)] = to_f32(src[e]);
  }
  __syncthreads();

  const int pairs = nf * (nf - 1) / 2;
  T* dst = out + b0 * pairs;
  const int n_out = n_ex * pairs;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    const int ex = t / pairs;
    const int p = t - ex * pairs;
    const int i = tri_row(p);
    const int j = p - i * (i - 1) / 2;
    const float* xi = tile + (ex * nf + i) * stride;
    const float* xj = tile + (ex * nf + j) * stride;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < dim; ++k) acc = fmaf(xi[k], xj[k], acc);
    dst[t] = from_f32<T>(acc);
  }
}

int examples_per_block(int nf, int dim) {
  const int per_ex = nf * (dim + 1) * static_cast<int>(sizeof(float));
  int e = kStageBytes / per_ex;
  return e < 1 ? 1 : (e > kMaxExamples ? kMaxExamples : e);
}

template <typename T>
int launch(const void* x, void* out, int64_t batch, int nf, int dim,
           cudaStream_t stream) {
  if (batch <= 0 || nf < 2) return static_cast<int>(cudaGetLastError());
  const int per_block = examples_per_block(nf, dim);
  const size_t smem = static_cast<size_t>(per_block) * nf * (dim + 1) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dot_interaction_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (batch + per_block - 1) / per_block;
  dot_interaction_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(static_cast<const T*>(x),
                                        static_cast<T*>(out), batch, nf, dim,
                                        per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16
extern "C" int dot_interaction_launch(const void* x, void* out, int64_t batch,
                                      int nf, int dim, int dtype,
                                      cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float>(x, out, batch, nf, dim, stream);
    case 1: return launch<__nv_bfloat16>(x, out, batch, nf, dim, stream);
    case 2: return launch<__half>(x, out, batch, nf, dim, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
