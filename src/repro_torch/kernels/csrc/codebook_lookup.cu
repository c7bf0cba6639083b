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
// the output — i.e. some 5-8 us at 3.35 TB/s, against a few MFLOP. The
// first port (one warp per row, two 4-byte column passes, each
// reloading the row's indices; ~6 waves of 8-warp blocks) took 0.021 /
// 0.025 ms (users / items) on an H100 80GB HBM3 at 700 W, timed as
// PERF.md says.
//
// Design: every output column is one __fadd_rn fold in h order from
// +0.0f, a duplicate skipped under binary, the order of the plain version
// (kernels/ref.py), so the result equals it bit for bit.
// - A warp takes a strip of kStripElems / H rows (at least one) and
//   loads their B x H indices in one coalesced load; the first-occurrence
//   rule is applied from registers (__shfl_up_sync; only rows of more
//   than 32 indices look back through memory).
// - A lane owns V consecutive columns (float4 / float2 / float,
//   gather::vec_width; at d = 64 one warp-wide load reads a whole
//   codebook row). Every codebook row of the strip is loaded before the
//   strip is folded in h order; duplicates are not loaded.
// - The grid is sized to the card (SMs x resident blocks), and warps
//   stride over the strips: at the serving shapes a warp has one or two.
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace {

using gather::kFull;
using gather::lesser;
using gather::vadd;
using gather::vzero;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStripElems = 16;   // indices a strip holds, <= 32
static_assert(kStripElems >= 1 && kStripElems <= 32, "strip of 1..32 indices");

template <int V>
__global__ void __launch_bounds__(kThreads)
    codebook_lookup_kernel(const float* __restrict__ codebook,
                           const int32_t* __restrict__ idx,
                           float* __restrict__ out, int64_t rows, int n_hot,
                           int dim, int binary, int strip_rows) {
  using vec = typename gather::Vec<V>::T;
  constexpr int kStep = gather::kStepFloats / V;   // row loads per step
  const int lane = threadIdx.x % 32;
  const int cols = dim / V;
  const vec* z = reinterpret_cast<const vec*>(codebook);
  vec* o = reinterpret_cast<vec*>(out);
  const int64_t strips = (rows + strip_rows - 1) / strip_rows;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t strip = static_cast<int64_t>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
       strip < strips; strip += warps) {
    const int64_t r0 = strip * strip_rows;
    const int nr = static_cast<int>(lesser<int64_t>(strip_rows, rows - r0));
    const int32_t* ix_row0 = idx + r0 * n_hot;
    const int n_el = nr * n_hot;
    for (int c0 = 0; c0 < cols; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < cols;
      vec acc = vzero(vec());
      int row = 0;
      int h = 0;
      for (int e0 = 0; e0 < n_el; e0 += 32) {
        const int n = lesser(32, n_el - e0);
        const int e = e0 + lane;
        const int32_t ix = lane < n ? ix_row0[e] : 0;
        bool dup = false;
        if (binary && n_hot > 1) {
          const int my_h = e % n_hot;
          for (int k = 1; k < n_hot; ++k) {
            const int32_t up = __shfl_up_sync(kFull, ix, lesser(k, 31));
            if (lane < n && k <= my_h) {
              dup = dup || (lane >= k ? up : ix_row0[e - k]) == ix;
            }
          }
        }
        const unsigned skip = __ballot_sync(kFull, dup);
        for (int t0 = 0; t0 < n; t0 += kStep) {
          vec buf[kStep];
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            const int t = t0 + u;
            const int32_t r = __shfl_sync(kFull, ix, t & 31);
            buf[u] = (active && t < n && !((skip >> (t & 31)) & 1u))
                         ? z[static_cast<int64_t>(r) * cols + c]
                         : vzero(vec());
          }
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            const int t = t0 + u;
            if (t < n) {
              if (!((skip >> t) & 1u)) acc = vadd(acc, buf[u]);
              if (++h == n_hot) {
                if (active) o[(r0 + row) * cols + c] = acc;
                acc = vzero(vec());
                h = 0;
                ++row;
              }
            }
          }
        }
      }
      if (n_hot == 0 && active) {
        for (int r = 0; r < nr; ++r) o[(r0 + r) * cols + c] = vzero(vec());
      }
    }
  }
}

template <int V>
void launch(const float* codebook, const int32_t* idx, float* out,
            int64_t rows, int n_hot, int dim, int binary,
            cudaStream_t stream) {
  static int resident[64] = {0};   // blocks per SM, by device
  int dev = 0;
  cudaGetDevice(&dev);
  int& per_sm = resident[dev & 63];
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, codebook_lookup_kernel<V>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int strip_rows =
      n_hot == 0 ? kStripElems
                 : (n_hot < kStripElems ? kStripElems / n_hot : 1);
  const int64_t strips = (rows + strip_rows - 1) / strip_rows;
  const int64_t blocks = lesser<int64_t>(
      (strips + kWarps - 1) / kWarps, static_cast<int64_t>(sms) * per_sm);
  codebook_lookup_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(codebook, idx, out, rows, n_hot, dim,
                                        binary, strip_rows);
}

}  // namespace

extern "C" int codebook_lookup_launch(const float* codebook,
                                      const int32_t* idx, float* out,
                                      int64_t rows, int n_hot, int dim,
                                      int binary, cudaStream_t stream) {
  if (rows > 0 && dim > 0) {
    switch (gather::vec_width(dim, reinterpret_cast<uintptr_t>(codebook) |
                                       reinterpret_cast<uintptr_t>(out))) {
      case 4:
        launch<4>(codebook, idx, out, rows, n_hot, dim, binary, stream);
        break;
      case 2:
        launch<2>(codebook, idx, out, rows, n_hot, dim, binary, stream);
        break;
      default:
        launch<1>(codebook, idx, out, rows, n_hot, dim, binary, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
