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
// Design: every output column is one fold in h order from zero, a
// duplicate skipped under binary, the order of the plain version
// (kernels/ref.py), so the result equals it bit for bit.
// - A warp takes one item: a strip of kStripElems / H rows (at least
//   one) and one 32-lane pass over its columns. It loads the strip's
//   B x H indices in one coalesced load; the first-occurrence rule is
//   applied from registers (__shfl_up_sync; only rows of more than 32
//   indices look back through memory).
// - A lane owns V consecutive columns: for f32, float4 / float2 / float
//   (gather::vec_width; at d = 64 one warp-wide load reads a whole
//   codebook row, and a strip is one pass). Every codebook row of the
//   item is loaded before it is folded in h order; duplicates are not
//   loaded.
// - The grid is sized to the card (SMs x resident blocks), and warps
//   stride over the items: at the serving shapes a warp has one or two.
//
// 16-bit codebooks (bf16, f16; the LM token embedding, 256,000 x 3,584
// bf16 for gemma2-9b, read at H = 1) run the same kernel with another
// lane policy (Lane16): the output has the codebook's type and every
// partial sum is rounded to the type once (the reference's
// `out_ref[r, :] += contrib` in the output dtype). Each add widens both
// operands to f32 exactly, adds with __fadd_rn and rounds to nearest even:
// f32 holds more than twice the 16-bit significand plus two bits, so that
// is the correctly rounded 16-bit sum, what the plain version's
// `out + rows` gives. A lane owns 8, 4, 2 or 1 consecutive elements (16,
// 8, 4 or 2 bytes, vec_width16); at d = 3,584 one 16-byte load a lane, and
// decode's few rows spread over 14 passes, so 14 warps. (A first build
// whose one warp walked all 14 passes of a strip took 0.0328 ms for 4
// rows, chip_smoke.py's lm phase on an H100 80GB HBM3 at 700 W; PERF.md
// has this build's time.)
//
// C interface (loaded with ctypes): each launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_convert.cuh"
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

// A lane's V consecutive f32 columns, summed with __fadd_rn.
template <int V> struct LaneF32 {
  using vec = typename gather::Vec<V>::T;
  static constexpr int kV = V;
  static constexpr int kStep = gather::kStepFloats / V;   // row loads a step
  static __device__ __forceinline__ vec zero() { return vzero(vec()); }
  static __device__ __forceinline__ vec add(vec a, vec b) {
    return vadd(a, b);
  }
};

// A lane's V consecutive 16-bit columns of type E (__nv_bfloat16 or
// __half), loaded as one V x 2-byte word; each element adds in f32 and
// rounds back to E.
template <typename E, int V> struct Lane16 {
  using vec = typename gather::Bits16<V>::T;
  static constexpr int kV = V;
  static constexpr int kStep = V == 1 ? 32 : 64 / V;   // 128 B in flight
  static __device__ __forceinline__ vec zero() {
    vec z;
    unsigned short* p = reinterpret_cast<unsigned short*>(&z);
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = 0;   // +0 in bf16 and f16
    return z;
  }
  static __device__ __forceinline__ vec add(vec a, vec b) {
    E* pa = reinterpret_cast<E*>(&a);
    const E* pb = reinterpret_cast<const E*>(&b);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      pa[i] = from_f32<E>(__fadd_rn(to_f32(pa[i]), to_f32(pb[i])));
    }
    return a;
  }
};

template <typename L>
__global__ void __launch_bounds__(kThreads)
    codebook_lookup_kernel(const void* __restrict__ codebook,
                           const int32_t* __restrict__ idx,
                           void* __restrict__ out, int64_t rows, int n_hot,
                           int dim, int binary, int strip_rows) {
  using vec = typename L::vec;
  constexpr int kStep = L::kStep;
  const int lane = threadIdx.x % 32;
  const int cols = dim / L::kV;
  const int passes = (cols + 31) / 32;
  const vec* z = static_cast<const vec*>(codebook);
  vec* o = static_cast<vec*>(out);
  const int64_t strips = (rows + strip_rows - 1) / strip_rows;
  const int64_t items = strips * passes;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
       item < items; item += warps) {
    const int64_t r0 = (item / passes) * strip_rows;
    const int c = static_cast<int>(item % passes) * 32 + lane;
    const bool active = c < cols;
    const int nr = static_cast<int>(lesser<int64_t>(strip_rows, rows - r0));
    const int32_t* ix_row0 = idx + r0 * n_hot;
    const int n_el = nr * n_hot;
    vec acc = L::zero();
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
                       : L::zero();
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int t = t0 + u;
          if (t < n) {
            if (!((skip >> t) & 1u)) acc = L::add(acc, buf[u]);
            if (++h == n_hot) {
              if (active) o[(r0 + row) * cols + c] = acc;
              acc = L::zero();
              h = 0;
              ++row;
            }
          }
        }
      }
    }
    if (n_hot == 0 && active) {
      for (int r = 0; r < nr; ++r) o[(r0 + r) * cols + c] = L::zero();
    }
  }
}

template <typename L>
void launch(const void* codebook, const int32_t* idx, void* out,
            int64_t rows, int n_hot, int dim, int binary,
            cudaStream_t stream) {
  static int resident[64] = {0};   // blocks per SM, by device
  int dev = 0;
  cudaGetDevice(&dev);
  int& per_sm = resident[dev & 63];
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, codebook_lookup_kernel<L>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int strip_rows =
      n_hot == 0 ? kStripElems
                 : (n_hot < kStripElems ? kStripElems / n_hot : 1);
  const int64_t items = (rows + strip_rows - 1) / strip_rows *
                        ((dim / L::kV + 31) / 32);
  const int64_t blocks = lesser<int64_t>(
      (items + kWarps - 1) / kWarps, static_cast<int64_t>(sms) * per_sm);
  codebook_lookup_kernel<L><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(codebook, idx, out, rows, n_hot, dim,
                                        binary, strip_rows);
}

template <typename E>
void dispatch16(const void* codebook, const int32_t* idx, void* out,
                int64_t rows, int n_hot, int dim, int binary,
                cudaStream_t stream) {
  switch (gather::vec_width16(dim, reinterpret_cast<uintptr_t>(codebook) |
                               reinterpret_cast<uintptr_t>(out))) {
    case 8:
      launch<Lane16<E, 8>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
      break;
    case 4:
      launch<Lane16<E, 4>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
      break;
    case 2:
      launch<Lane16<E, 2>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
      break;
    default:
      launch<Lane16<E, 1>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
  }
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
        launch<LaneF32<4>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
        break;
      case 2:
        launch<LaneF32<2>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
        break;
      default:
        launch<LaneF32<1>>(codebook, idx, out, rows, n_hot, dim, binary,
                           stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 1 bf16, 2 f16 (platform.DTYPES); the codebook and the output
// have that type.
extern "C" int codebook_lookup16_launch(const void* codebook,
                                        const int32_t* idx, void* out,
                                        int64_t rows, int n_hot, int dim,
                                        int binary, int dtype,
                                        cudaStream_t stream) {
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && dim > 0) {
    if (dtype == 1) {
      dispatch16<__nv_bfloat16>(codebook, idx, out, rows, n_hot, dim, binary,
                                stream);
    } else {
      dispatch16<__half>(codebook, idx, out, rows, n_hot, dim, binary,
                         stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
