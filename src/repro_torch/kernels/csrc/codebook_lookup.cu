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
// bf16 for gemma2-9b, read at H = 1) have a kernel of their own,
// lookup16_kernel: the output has the codebook's type and every partial
// sum is rounded to the type once (the reference's `out_ref[r, :] +=
// contrib` in the output dtype). Each add widens both operands to f32
// exactly, adds with __fadd_rn and rounds to nearest even: f32 holds more
// than twice the 16-bit significand plus two bits, so that is the
// correctly rounded 16-bit sum, what the plain version's `out + rows`
// gives (also at H = 1: +0 + -0 is +0, and a NaN comes out canonical).
// What bounds it: bytes, B x d x 2 written and the distinct rows read
// (gemma2-9b's prefill, B 32,768: ~456 MB, 0.136 ms at 3.35 TB/s); a
// decode's few rows (B 2-64) take one trip for the indices and one for the
// rows, so latency. Its schedule is sized to the call:
// - A unit is one (row, V-element column word), V = 8, 4, 2 or 1 (16, 8,
//   4 or 2 bytes, gather::copy_width16: the widest that divides d and the
//   pointers' alignment). A grid of T threads deals units t, t + T, ... to
//   thread t: neighbouring lanes read neighbouring words of a row.
// - While the units fit on the card at once (decode: B 4 x 448 words at d
//   3,584 is 1,792 threads, 14 blocks of 128 on 14 SMs), one a thread:
//   each row load in one round, right after its index. Beyond that
//   (prefill, train: 14.7M and 2.0M units), kWide16 = 4 a thread, T a
//   quarter of the units: the four index loads, then the four row loads
//   in flight at once, then streaming stores (st.global.cs: the output is
//   not read back here). The row and column of a thread's next unit follow
//   from the last by adding T / cols and T % cols, computed on the host.
//   (A grid of the card's resident threads striding 4 units a round, with
//   no partial last wave, was slower at the prefills side by side.)
// - H > 1 (tests, multi-hot 16-bit tables) folds the H rows of a unit in h
//   order, a duplicate under binary skipped (the first occurrence wins).
// Times (chip_smoke.py's kernels line, the LM cells' first lookups, H100
// 80GB HBM3, 700.00 W): gemma2-9b prefill B 32,768 0.1695 ms, 0.80 of its
// bound (`table[ids]` 0.1731); decode B 4 0.00630 ms, kimi-k2 B 64
// 0.00742 (`table[ids]` 0.00614, 0.00717; the timer's floor ~0.0054);
// gemma3-12b's train microbatch B 4,096 0.0338 ms (0.0334), 0.55 of its
// bound: the timer's L2 flush leaves dirty lines that this call writes
// back (with the L2 flushed by reads, a seeded draw takes 0.0232 ms, 0.81
// of its bound, as `table[ids]`: tools/gather_parity.py).
// The first 16-bit route ran the f32 kernel's warp-a-strip schedule with
// 16-bit lanes: 0.1836, 0.00762, 0.0120 and 0.0349 ms at those shapes,
// slower than `table[ids]` at each.
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

// A thread's V consecutive 16-bit columns of type E (__nv_bfloat16 or
// __half), loaded as one V x 2-byte word; each element adds in f32 and
// rounds back to E.
template <typename E, int V> struct Lane16 {
  using vec = typename gather::Bits16<V>::T;
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

// The f32 route: a lane owns V consecutive columns (a vector of V floats),
// summed with __fadd_rn.
template <int V>
__global__ void __launch_bounds__(kThreads)
    codebook_lookup_kernel(const float* __restrict__ codebook,
                           const int32_t* __restrict__ idx,
                           float* __restrict__ out, int64_t rows, int n_hot,
                           int dim, int binary, int strip_rows) {
  using vec = typename gather::Vec<V>::T;
  constexpr int kStep = gather::kStepFloats / V;   // row loads a step
  const int lane = threadIdx.x % 32;
  const int cols = dim / V;
  const int passes = (cols + 31) / 32;
  const vec* z = reinterpret_cast<const vec*>(codebook);
  vec* o = reinterpret_cast<vec*>(out);
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

// Blocks of a kernel one multiprocessor holds and the card's
// multiprocessors, asked once per device: each launch function keeps its
// kernel's in a static array by device.
struct Card {
  int per_sm = 0;
  int sms = 0;
};

template <typename Kernel>
const Card& card(Card (&cards)[64], Kernel kernel, int threads) {
  int dev = 0;
  cudaGetDevice(&dev);
  Card& c = cards[dev & 63];
  if (c.sms == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, threads,
                                                  0);
    if (c.per_sm < 1) c.per_sm = 1;
    int sms = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    c.sms = sms;
  }
  return c;
}

template <int V>
void launch(const float* codebook, const int32_t* idx, float* out,
            int64_t rows, int n_hot, int dim, int binary,
            cudaStream_t stream) {
  static Card cards[64];
  const Card& c = card(cards, codebook_lookup_kernel<V>, kThreads);
  const int strip_rows =
      n_hot == 0 ? kStripElems
                 : (n_hot < kStripElems ? kStripElems / n_hot : 1);
  const int64_t items = (rows + strip_rows - 1) / strip_rows *
                        ((dim / V + 31) / 32);
  const int64_t blocks = lesser<int64_t>(
      (items + kWarps - 1) / kWarps, static_cast<int64_t>(c.sms) * c.per_sm);
  codebook_lookup_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(codebook, idx, out, rows, n_hot, dim,
                                        binary, strip_rows);
}

// The 16-bit route (see the head of the file): units of one (row, word),
// U a thread, kThreads16 threads a block.
constexpr int kThreads16 = 128;

template <typename E, int V, int U>
__global__ void __launch_bounds__(kThreads16)
    lookup16_kernel(const typename Lane16<E, V>::vec* __restrict__ z,
                    const int32_t* __restrict__ idx,
                    typename Lane16<E, V>::vec* __restrict__ o, int64_t rows,
                    int n_hot, int cols, int binary, int64_t step_rows,
                    int step_cols, int narrow) {
  using L = Lane16<E, V>;
  using vec = typename L::vec;
  // this thread's units: its first, then T on (T the grid's threads:
  // step_rows = T / cols rows and step_cols = T % cols columns); narrow:
  // the first fits in 32 bits (a cheap division)
  int64_t r[U];
  int c[U];
  if (narrow) {
    const unsigned first = blockIdx.x * kThreads16 + threadIdx.x;
    r[0] = first / static_cast<unsigned>(cols);
    c[0] = static_cast<int>(first % static_cast<unsigned>(cols));
  } else {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads16 +
                          threadIdx.x;
    r[0] = first / cols;
    c[0] = static_cast<int>(first % cols);
  }
#pragma unroll
  for (int u = 1; u < U; ++u) {
    c[u] = c[u - 1] + step_cols;
    r[u] = r[u - 1] + step_rows;
    if (c[u] >= cols) {
      c[u] -= cols;
      ++r[u];
    }
  }
  vec acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = L::zero();
  for (int h = 0; h < n_hot; ++h) {
    int32_t ix[U];
    bool take[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      take[u] = r[u] < rows;
      ix[u] = take[u] ? __ldg(idx + r[u] * n_hot + h) : 0;
    }
    if (binary && h > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        for (int j = 0; j < h && take[u]; ++j)
          take[u] = __ldg(idx + r[u] * n_hot + j) != ix[u];
    }
    vec buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      buf[u] = take[u] ? __ldg(z + static_cast<int64_t>(ix[u]) * cols + c[u])
                       : L::zero();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (take[u]) acc[u] = L::add(acc[u], buf[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r[u] < rows) __stcs(o + r[u] * cols + c[u], acc[u]);
}

// Units a thread of a call with more units than the card holds threads at
// once: kWide16 apart, their row loads in flight together.
constexpr int kWide16 = 4;

template <typename E, int V, int U>
void launch16_u(const void* codebook, const int32_t* idx, void* out,
                int64_t rows, int n_hot, int cols, int binary,
                cudaStream_t stream) {
  using vec = typename Lane16<E, V>::vec;
  const int64_t units = rows * cols;
  const int64_t blocks =
      (units + int64_t{kThreads16} * U - 1) / (int64_t{kThreads16} * U);
  const int64_t total = blocks * kThreads16;
  lookup16_kernel<E, V, U><<<static_cast<unsigned>(blocks), kThreads16, 0,
                             stream>>>(
      static_cast<const vec*>(codebook), idx, static_cast<vec*>(out), rows,
      n_hot, cols, binary, total / cols, static_cast<int>(total % cols),
      total <= 0xffffffffll);
}

template <typename E, int V>
void launch16(const void* codebook, const int32_t* idx, void* out,
              int64_t rows, int n_hot, int dim, int binary,
              cudaStream_t stream) {
  static Card cards[64];
  const Card& c = card(cards, lookup16_kernel<E, V, 1>, kThreads16);
  const int cols = dim / V;
  if (rows * cols <= int64_t{c.sms} * c.per_sm * kThreads16) {
    launch16_u<E, V, 1>(codebook, idx, out, rows, n_hot, cols, binary,
                        stream);
  } else {
    launch16_u<E, V, kWide16>(codebook, idx, out, rows, n_hot, cols, binary,
                              stream);
  }
}

template <typename E>
void dispatch16(const void* codebook, const int32_t* idx, void* out,
                int64_t rows, int n_hot, int dim, int binary,
                cudaStream_t stream) {
  switch (gather::copy_width16(dim, reinterpret_cast<uintptr_t>(codebook) |
                                        reinterpret_cast<uintptr_t>(out))) {
    case 8:
      launch16<E, 8>(codebook, idx, out, rows, n_hot, dim, binary, stream);
      break;
    case 4:
      launch16<E, 4>(codebook, idx, out, rows, n_hot, dim, binary, stream);
      break;
    case 2:
      launch16<E, 2>(codebook, idx, out, rows, n_hot, dim, binary, stream);
      break;
    default:
      launch16<E, 1>(codebook, idx, out, rows, n_hot, dim, binary, stream);
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
