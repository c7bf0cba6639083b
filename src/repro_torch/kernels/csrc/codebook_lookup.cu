// Multi-hot codebook lookup for Hopper (sm_90a):  out[b] = sum_h Z[idx[b, h]].
//
// Replaces the TPU kernel src/repro/kernels/codebook_lookup.py::
// codebook_lookup_pallas (pl.pallas_call at :98). With binary != 0 a
// repeated index within a row counts once (first occurrence wins: the
// paper's binary Y, SCU falling back to the primary cluster).
//
// What bounds it on the H100: bytes. Per output element it does H adds
// on one gathered float; at the serving shapes (users: B = 52,643,
// H = 2, K ~ 8.9k; items: B = 91,599, H = 1, K ~ 17.1k; d = 64) it moves
// ~16 MB (users) and ~28 MB (items) — the index rows, the codebook and
// the output — i.e. some 5-8 us at 3.35 TB/s, against a few MFLOP.
//
// Design: one warp per output row. The warp reads the row's H indices
// (broadcast loads), applies the first-occurrence rule, and its lanes
// walk the d columns, so each gathered codebook row and each output row
// is one coalesced 256-byte access at d = 64. Every output element is
// written once; nothing is staged in shared memory (a gather has no
// reuse to stage). The H contributions are added in h order starting
// from +0.0f, the order of the plain version (kernels/ref.py), so the
// result equals it bit for bit.
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void codebook_lookup_kernel(const float* __restrict__ codebook,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int64_t rows,
                                       int n_hot, int dim, int binary) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int32_t* r = idx + row * n_hot;
  float* o = out + row * dim;
  for (int c = lane; c < dim; c += 32) {
    float acc = 0.0f;
    for (int h = 0; h < n_hot; ++h) {
      const int32_t cur = r[h];
      bool dup = false;
      if (binary) {
        for (int j = 0; j < h; ++j) dup = dup || (r[j] == cur);
      }
      if (!dup) acc = __fadd_rn(acc, codebook[static_cast<int64_t>(cur) * dim + c]);
    }
    o[c] = acc;
  }
}

}  // namespace

extern "C" int codebook_lookup_launch(const float* codebook,
                                      const int32_t* idx, float* out,
                                      int64_t rows, int n_hot, int dim,
                                      int binary, cudaStream_t stream) {
  if (rows > 0 && dim > 0) {
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    codebook_lookup_kernel<<<static_cast<unsigned>(blocks),
                             kWarpsPerBlock * 32, 0, stream>>>(
        codebook, idx, out, rows, n_hot, dim, binary);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
