// CSR gather-sum for Hopper (sm_90a), plain and weighted:
//   out[s] = sum_{j in [ptr[s], ptr[s+1])} src[idx[j]]          (rows of d floats)
//   out[s] = sum_{j in [ptr[s], ptr[s+1])} w[j] * src[idx[j]]   (weighted)
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// embedding_bag_pallas (pl.pallas_call at :56): the EmbeddingBag forward
// (src = the table, idx = the bag values, ptr = the bag boundaries of the
// sorted segment ids). The same kernel computes both backward passes of
// the embedding layer, whose reference is jnp (src/repro/kernels/ops.py
// :96-119 and :145-168): the cotangent rows are gathered (src = g) and
// summed into each table row, the entries having been stably sorted by
// table row, so that no float atomics are needed and two runs are
// bitwise equal. The weighted instantiation is the LightGCN propagation
// (src/repro/models/lightgcn.py:154-183, jnp): one layer of one side is
// out = segment sum over the sorted edges of edge_norm[j] * rows[idx[j]],
// forward and backward (the adjoint is the same sum under the other
// side's edge order), 12 calls a training step at 3 layers. Each product
// is one __fmul_rn, each sum one __fadd_rn (no FMA contraction), so the
// weighted result equals (src[idx] * w[:, None]) folded in j order bit
// for bit.
//
// The Pallas kernel walks the sorted values as a sequential grid and keeps
// revisiting one output block until its segment id changes. Hopper has no
// sequential grid, so the boundaries arrive as a CSR pointer array
// (built by the wrapper with searchsorted) and every output row is
// independent.
//
// What bounds it on the H100: bytes, and the latency of dependent loads.
// Each value moves one d-float row (256 bytes at d = 64) for d adds. At
// the amazonbook bags (547,067 values in 52,643 bags over a [91,599, 64]
// table) the inputs and the output are ~40 MB, ~12 us at 3.35 TB/s; the
// 140 MB of gathered rows mostly come from L2, which holds the 23 MB
// table. The bags are power-law: median 1 value, longest 1,812, and the
// 2,048 bags of more than 32 values hold 76% of the values (the backward
// rows, items, reach 3,541). The propagation has the same shapes: the
// user side sums 547,067 weighted edges into 52,643 rows (longest 1,812),
// the item side into 91,599 rows (longest 3,541); its bound adds the
// 2.2 MB of weights, ~0.012 ms for each side at d = 64. A warp that walks one bag value by value is
// a chain of dependent loads as long as the bag, and the longest such
// chain was the whole time of the first port (0.32 ms on an H100 80GB
// HBM3 at 700 W).
//
// Design: every output column is one __fadd_rn fold in j order from
// +0.0f (no contraction, no atomics), the order of the plain version
// (kernels/ref.py), so the result equals it bit for bit; only the loads
// and the scheduling are free. One grid, no host sync, no sort:
// - Short rows (at most kLongRow values): a warp takes a strip of
//   kRowsPerWarp consecutive rows and one column tile of them (32 lane
//   words): a wide row's tiles are dealt to as many warps
//   (column_split), so a few wide rows spread over the card (the MoE
//   decode combine, 8 tokens of 4 bf16 rows of d 6,144, runs 48 warps,
//   where one warp walking a strip's 24 tiles in turn left 2). It reads
//   the strip's pointers in one load, then walks the strip's values in
//   batches of 32: one coalesced index
//   load, broadcast with __shfl_sync, then gathered rows in steps of
//   kStepFloats / V per lane, all of a step's loads in flight before
//   they are folded. A lane owns V consecutive columns (float4 / float2 /
//   float, gather::vec_width; d = 64 reads a whole row per warp-wide
//   load). Row boundaries inside a batch close one sum and open the next;
//   empty rows write zeros. Long rows in the strip are skipped.
// - Long rows: the first kLongBlocksPerSm x SMs blocks of the grid (so
//   they start first) each take every row r = b mod (their count) with
//   more than kLongRow values. A block streams all its long rows through
//   two rings in shared memory as one sequence of stages (a stage: up to
//   kStageFloats / d values of one row): the stage's indices are copied
//   kStages - 1 stages ahead of its gathered rows, and those kStages - 1
//   stages ahead of their fold, all with cp.async (4 bytes for an index,
//   16 / 8 / 4 for a row piece, gather::copy_width), one wait and one
//   barrier per stage, so one row's tail overlaps the next row's head.
//   Threads that each own one column fold the staged rows in j order.
//   The weighted kernel copies a stage's weights with its gathered rows
//   (4 bytes a value, into a third ring of kStages x kMaxPer floats,
//   4 KB), so they land and are freed with the rows; the short rows load
//   a batch's 32 weights beside its 32 indices and broadcast both.
//   A whole block's memory parallelism goes to its long rows while each
//   column's fold stays serial, as parity requires.
// Rows wider than 512 floats are done in column tiles. The strip, the
// threshold, the ring's depth and size and the long-row blocks per SM
// were chosen by sweeps on an H100 80GB HBM3 at 700 W (PERF.md). What
// holds it back now (the same card): a few wide rows are one gather
// batch a warp, so the dbrx-132b decode combine (8 tokens of 4 bf16 rows
// of 6,144) takes ~0.010 ms, under index_add_'s ~0.016 but far above its
// 0.00015 ms of bytes and near the timer's 0.005 ms floor; the LM token
// gradient (256,000 rows of 3,584 bf16, 4,096 of them summed) is 1.1x
// its bytes, most of them the zero rows written.
//
// 16-bit rows (bf16, f16: the LM token embedding's gradient, a bf16
// cotangent [B x S, 3,584] summed into 256,000 rows) run the same kernel
// under another lane policy (Lane16): a lane loads up to 8 elements as
// one 16-byte word and widens each exactly to f32, every column is the
// same __fadd_rn fold in j order in f32 registers, and the sum is
// rounded to the 16-bit type once, at the store. The long rows' rings
// hold the raw 16-bit rows (twice the values a stage) and widen them as
// they fold. So a 16-bit result is the f32 sum of the plain version
// (kernels/ref.py) rounded once, bit for bit. (XLA's CPU segment_sum of a
// bf16 cotangent rounds after every add instead; this is the more
// accurate of the two, ROADMAP Queue 3 #9.) The weighted kernel is f32
// only.
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>
#include <type_traits>

#include "f32_convert.cuh"
#include "gather.cuh"

namespace {

using gather::kFull;
using gather::lesser;
using gather::vadd;
using gather::vzero;

constexpr int kWarps = 8;                          // short-row blocks
constexpr int kThreads = kWarps * 32;
constexpr int kLongThreads = kThreads;             // long-row blocks
constexpr int kRowsPerWarp = 4;                    // at most 31
constexpr int64_t kLongRow = 32;                   // values
constexpr int kStages = 4;
constexpr int kLongBlocksPerSm = 8;
constexpr int kStageFloats = 4096;                 // floats a stage
constexpr int kStageBytes = kStageFloats * 4;
constexpr int kMaxTile = 512;                      // elements of a column tile
constexpr int kMaxPer = kLongThreads;              // values a stage
// the rows' and the indices' rings, and the weighted kernel's weights
template <bool W>
constexpr int kSmemBytes = kStages * (kStageFloats + (W ? 2 : 1) * kMaxPer) * 4;

static_assert(kRowsPerWarp >= 1 && kRowsPerWarp <= 31, "strip of 1..31 rows");
static_assert(kStages >= 2, "a ring of at least two stages");
static_assert(kMaxTile % kLongThreads == 0 && kMaxTile <= kStageFloats,
              "a column tile of whole columns per thread that fits a stage");
static_assert(kStageBytes % (16 * kLongThreads) == 0,
              "whole copies per thread");

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  if constexpr (BYTES == 2) {     // below cp.async's 4 bytes: a plain copy
    *static_cast<unsigned short*>(smem) =
        *static_cast<const unsigned short*>(gmem);
    return;
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (BYTES == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(gmem));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(gmem), "n"(BYTES));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the weighted product, rounded on its own (never contracted into an FMA)
__device__ __forceinline__ float vscale(float a, float s) {
  return __fmul_rn(a, s);
}
__device__ __forceinline__ float2 vscale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}
__device__ __forceinline__ float4 vscale(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                     __fmul_rn(a.z, s), __fmul_rn(a.w, s));
}

// Lane policies of the short rows: a lane loads V consecutive elements
// of type E as one `raw` word and folds them into an f32 accumulator.
// f32: the accumulator is the loaded vector itself.
template <int V> struct LaneF32 {
  using E = float;
  using raw = typename gather::Vec<V>::T;
  using acc = raw;
  static constexpr int kV = V;
  static __device__ __forceinline__ raw zero_raw() { return vzero(raw()); }
  static __device__ __forceinline__ acc zero() { return vzero(acc()); }
  static __device__ __forceinline__ acc add(acc a, raw b) {
    return vadd(a, b);
  }
  static __device__ __forceinline__ acc add_scaled(acc a, raw b, float w) {
    return vadd(a, vscale(b, w));
  }
  static __device__ __forceinline__ raw store(acc a) { return a; }
};

// 16-bit (E = __nv_bfloat16 or __half): each element widens exactly to
// f32 and adds with __fadd_rn; the store rounds each sum to E once (no
// add_scaled: the weighted kernel is f32 only).
template <typename E_, int V> struct Lane16 {
  using E = E_;
  using raw = typename gather::Bits16<V>::T;
  struct acc { float v[V]; };
  static constexpr int kV = V;
  static __device__ __forceinline__ raw zero_raw() {
    raw z;
    unsigned short* p = reinterpret_cast<unsigned short*>(&z);
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = 0;   // +0 in bf16 and f16
    return z;
  }
  static __device__ __forceinline__ acc zero() {
    acc a;
#pragma unroll
    for (int i = 0; i < V; ++i) a.v[i] = 0.0f;
    return a;
  }
  static __device__ __forceinline__ acc add(acc a, raw b) {
    const E* pb = reinterpret_cast<const E*>(&b);
#pragma unroll
    for (int i = 0; i < V; ++i) a.v[i] = __fadd_rn(a.v[i], to_f32(pb[i]));
    return a;
  }
  static __device__ __forceinline__ raw store(acc a) {
    raw r;
    E* pr = reinterpret_cast<E*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) pr[i] = from_f32<E>(a.v[i]);
    return r;
  }
};

// One warp: the short rows of the strip [r0, r0 + kRowsPerWarp), column
// tiles g, g + split, g + 2 split, ... of 32 lane vectors each (split 1:
// every tile). Each tile is the same fold, so how the tiles are dealt
// to warps does not change a bit of the result.
template <typename L, bool W>
__device__ void warp_strip(const void* __restrict__ src,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ wt,
                           const int64_t* __restrict__ ptr,
                           void* __restrict__ out, int64_t rows, int dim,
                           int64_t r0, int g, int split, int lane) {
  using raw = typename L::raw;
  using acc_t = typename L::acc;
  // row loads a lane keeps in flight: 128 bytes (at most 32 loads)
  constexpr int kStep = lesser(
      32, gather::kStepFloats * 4 / static_cast<int>(sizeof(raw)));
  const int nr = static_cast<int>(
      lesser<int64_t>(kRowsPerWarp, rows - r0));
  // lane k holds [p, pn) = the values of row r0 + k (k < nr)
  const int64_t p = ptr[r0 + lesser(lane, nr)];
  const int64_t pn = __shfl_down_sync(kFull, p, 1);
  const bool is_long = lane < nr && pn - p > kLongRow;
  const unsigned long_rows = __ballot_sync(kFull, is_long);
  const int64_t beg = __shfl_sync(kFull, p, 0);
  const int64_t end = __shfl_sync(kFull, p, nr);
  const int cols = dim / L::kV;
  const raw* s = static_cast<const raw*>(src);
  raw* o = static_cast<raw*>(out);
  for (int c0 = 32 * g; c0 < cols; c0 += 32 * split) {
    const int c = c0 + lane;
    const bool active = c < cols;
    acc_t acc = L::zero();
    int cur = 0;                                  // the row acc sums
    int64_t cur_end = __shfl_sync(kFull, pn, 0);
    // close every row that ends at or before value j (warp-uniform):
    // write its sum (zeros for an empty row; a long row is a block's)
    auto close_to = [&](int64_t j) {
      while (cur < nr && cur_end <= j) {
        if (active && !((long_rows >> cur) & 1u)) {
          o[(r0 + cur) * cols + c] = L::store(acc);
        }
        acc = L::zero();
        ++cur;
        cur_end = __shfl_sync(kFull, pn, cur & 31);
      }
    };
    int64_t j0 = beg;
    while (j0 < end) {
      const unsigned in_long =
          __ballot_sync(kFull, is_long && p <= j0 && j0 < pn);
      if (in_long) {                              // a block sums this row
        j0 = __shfl_sync(kFull, pn, __ffs(in_long) - 1);
        continue;
      }
      const unsigned ahead = __ballot_sync(kFull, is_long && p > j0);
      const int64_t stop =
          ahead ? __shfl_sync(kFull, p, __ffs(ahead) - 1) : end;
      const int n = static_cast<int>(lesser<int64_t>(32, stop - j0));
      const int32_t ix = lane < n ? idx[j0 + lane] : 0;
      float wl = 0.0f;
      if constexpr (W) wl = lane < n ? wt[j0 + lane] : 0.0f;
      for (int t0 = 0; t0 < n; t0 += kStep) {
        raw buf[kStep];
        float wb[W ? kStep : 1];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int32_t r = __shfl_sync(kFull, ix, (t0 + u) & 31);
          if constexpr (W) wb[u] = __shfl_sync(kFull, wl, (t0 + u) & 31);
          buf[u] = (active && t0 + u < n)
                       ? s[static_cast<int64_t>(r) * cols + c]
                       : L::zero_raw();
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          if (t0 + u < n) {
            close_to(j0 + t0 + u);
            if constexpr (W) {
              acc = L::add_scaled(acc, buf[u], wb[u]);
            } else {
              acc = L::add(acc, buf[u]);
            }
          }
        }
      }
      j0 += n;
    }
    close_to(end);
  }
}

// A block's long rows, as one stream of stages: stage s holds up to
// `per` consecutive values of one row. Each thread walks the stream with
// its own copy of a cursor (all copies agree); a cursor keeps its row's
// first value and length in registers.
struct Cursor {
  int k = 0;          // row in the block's list
  int64_t off = 0;    // first value of the stage within the row
  int64_t lo = 0;     // the row's first value in idx
  int64_t len = 0;    // the row's length
  __device__ void start(const int64_t* row_lo, const int64_t* row_len) {
    lo = row_lo[0];
    len = row_len[0];
  }
  __device__ int count(int per) const {
    return static_cast<int>(lesser<int64_t>(per, len - off));
  }
  __device__ void next(const int64_t* row_lo, const int64_t* row_len,
                       int n, int per) {
    off += per;
    if (off >= len) {
      off = 0;
      if (++k < n) {
        lo = row_lo[k];
        len = row_len[k];
      }
    }
  }
};

// The whole block: columns [col0, col0 + w) of the n long rows listed in
// shared memory (row ids, first values, lengths). Three stages are in
// flight at once for each stage folded: the indices of stage it are
// copied A = kStages - 1 iterations before its gathered rows, and those
// A iterations before they are folded, so one cp.async.wait_group and
// one barrier per stage serve both rings, and one row's tail overlaps
// the next row's head. E: the element type of src and out (the ring
// holds raw E; the fold widens to f32).
template <typename E, int VL, bool W>
__device__ void block_stream(const E* __restrict__ src,
                             const int32_t* __restrict__ idx,
                             const float* __restrict__ wt,
                             E* __restrict__ out, int dim,
                             const int64_t* row_id, const int64_t* row_lo,
                             const int64_t* row_len, int n, int col0, int w) {
  constexpr int V = VL;
  constexpr int A = kStages - 1;
  constexpr int kStageElems = kStageBytes / static_cast<int>(sizeof(E));
  constexpr int kEpt = kStageElems / V / kLongThreads;    // copies a thread
  constexpr int kCpt = kMaxTile / kLongThreads;           // its columns
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);
  int32_t* iring = reinterpret_cast<int32_t*>(smem + kStages * kStageFloats);
  // the weighted kernel's weights: stage d's in slot d mod kStages,
  // copied with its rows
  float* wring = smem + kStages * (kStageFloats + kMaxPer);
  const int tid = threadIdx.x;
  const int wv = w / V;                               // w is a multiple of V
  const int per = lesser(kStageElems / w, kMaxPer);   // values a stage
  int64_t stages = 0;
  for (int k = 0; k < n; ++k) stages += (row_len[k] + per - 1) / per;
  // this thread's copies of a stage: value val[i], vector vk[i]
  int val[kEpt];
  int vk[kEpt];
#pragma unroll
  for (int i = 0; i < kEpt; ++i) {
    const int e = tid + i * kLongThreads;
    val[i] = e < per * wv ? e / wv : -1;
    vk[i] = e % wv;
  }
  float acc[kCpt];
#pragma unroll
  for (int c = 0; c < kCpt; ++c) acc[c] = 0.0f;
  Cursor ci, cd, cf;          // index copies, row copies, fold
  ci.start(row_lo, row_len);
  cd.start(row_lo, row_len);
  cf.start(row_lo, row_len);
  for (int64_t it = 0; it < stages + 2 * A; ++it) {
    if (it >= A) {
      cp_async_wait<A - 1>();
      __syncthreads();        // stage it - A's indices and stage it - 2A's
    }                         // rows landed; the slots they reuse are free
    if (it < stages) {        // indices of stage it
      if (tid < ci.count(per)) {
        cp_async<4>(iring + (it % kStages) * kMaxPer + tid,
                    idx + ci.lo + ci.off + tid);
      }
      ci.next(row_lo, row_len, n, per);
    }
    const int64_t d = it - A;
    if (d >= 0 && d < stages) {   // gathered rows of stage d
      const int cnt = cd.count(per);
      const int32_t* si = iring + (d % kStages) * kMaxPer;
      E* slot = ring + (d % kStages) * kStageElems;
      if constexpr (W) {
        if (tid < cnt) {
          cp_async<4>(wring + (d % kStages) * kMaxPer + tid,
                      wt + cd.lo + cd.off + tid);
        }
      }
#pragma unroll
      for (int i = 0; i < kEpt; ++i) {
        if (val[i] >= 0 && val[i] < cnt) {
          cp_async<static_cast<int>(sizeof(E)) * V>(
              slot + val[i] * w + vk[i] * V,
              src + static_cast<int64_t>(si[val[i]]) * dim + col0 +
                  vk[i] * V);
        }
      }
      cd.next(row_lo, row_len, n, per);
    }
    cp_async_commit();
    const int64_t f = it - 2 * A;
    if (f >= 0) {                 // fold stage f, in value order
      const int cnt = cf.count(per);
      const E* fs = ring + (f % kStages) * kStageElems;
      const float* ws = wring + (f % kStages) * kMaxPer;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const int col = tid + c * kLongThreads;
        if (col < w) {
          float a = acc[c];
          if constexpr (W) {
#pragma unroll 16
            for (int v = 0; v < cnt; ++v) {
              a = __fadd_rn(a, __fmul_rn(fs[v * w + col], ws[v]));
            }
          } else {
#pragma unroll 16
            for (int v = 0; v < cnt; ++v) {
              a = __fadd_rn(a, to_f32(fs[v * w + col]));
            }
          }
          acc[c] = a;
        }
      }
      if (cf.off + per >= cf.len) {   // the row's last stage
#pragma unroll
        for (int c = 0; c < kCpt; ++c) {
          const int col = tid + c * kLongThreads;
          if (col < w) {
            out[row_id[cf.k] * dim + col0 + col] = from_f32<E>(acc[c]);
          }
          acc[c] = 0.0f;
        }
      }
      cf.next(row_lo, row_len, n, per);
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the rings are free again
}

// Long-row block b of nb: the rows r = b mod nb with more than kLongRow
// values, listed kLongThreads candidates at a time and streamed through
// the block's rings, a column tile of up to kMaxTile elements at a time.
template <typename E, int VL, bool W>
__device__ void long_rows(const E* __restrict__ src,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ wt,
                          const int64_t* __restrict__ ptr,
                          E* __restrict__ out, int64_t rows, int dim,
                          int nb) {
  __shared__ int64_t row_id[kLongThreads];
  __shared__ int64_t row_lo[kLongThreads];
  __shared__ int64_t row_len[kLongThreads];
  __shared__ int count;
  const int64_t stride = static_cast<int64_t>(kLongThreads) * nb;
  for (int64_t base = blockIdx.x; base < rows; base += stride) {
    const int64_t r = base + static_cast<int64_t>(threadIdx.x) * nb;
    int64_t lo = 0;
    int64_t len = 0;
    if (r < rows) {
      lo = ptr[r];
      len = ptr[r + 1] - lo;
    }
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    if (len > kLongRow) {
      const int k = atomicAdd(&count, 1);
      row_id[k] = r;
      row_lo[k] = lo;
      row_len[k] = len;
    }
    __syncthreads();
    const int n = count;
    if (n > 0) {
      for (int col0 = 0; col0 < dim; col0 += kMaxTile) {
        block_stream<E, VL, W>(src, idx, wt, out, dim, row_id, row_lo,
                               row_len, n, col0, lesser(kMaxTile, dim - col0));
      }
    }
    __syncthreads();              // the list is rewritten next
  }
}

// One grid: the first long_blocks blocks take the long rows (so they
// start first), the rest give each warp a strip of kRowsPerWarp rows.
// L: the short rows' lane policy (L::kV elements a lane); VL: elements
// per cp.async of the long rows' copies; W: each value scaled by its
// weight wt[j] (wt is not read when W is false; f32 only).
template <typename L, int VL, bool W>
__global__ void __launch_bounds__(kThreads)
    csr_gather_sum_kernel(const typename L::E* __restrict__ src,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ wt,
                          const int64_t* __restrict__ ptr,
                          typename L::E* __restrict__ out, int64_t rows,
                          int dim, int long_blocks, int split) {
  static_assert(!W || std::is_same<typename L::E, float>::value,
                "the weighted kernel is f32 only");
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    long_rows<typename L::E, VL, W>(src, idx, wt, ptr, out, rows, dim,
                                    long_blocks);
    return;
  }
  const int64_t w =
      static_cast<int64_t>(blockIdx.x - long_blocks) * kWarps +
      threadIdx.x / 32;
  // split > 1 only while the warps fit 32 bits (column_split)
  int64_t strip = w;
  int g = 0;
  if (split > 1) {
    strip = static_cast<int>(w) / split;
    g = static_cast<int>(w) % split;
  }
  const int64_t r0 = strip * kRowsPerWarp;
  if (r0 < rows) {
    warp_strip<L, W>(src, idx, wt, ptr, out, rows, dim, r0, g, split,
                     threadIdx.x % 32);
  }
}

// Warps a strip's column tiles are dealt to: one a tile (so 8 tokens of
// a d 6,144 MoE combine run 48 warps, not 2), while the warps fit a
// 32-bit index. Measured on the H100 against dealing them only while the
// strips leave the card idle: as fast on the decode combines and faster
// where the strips already fill it (the LM token gradient, the prefill
// and train combines; PERF.md).
int column_split(int64_t strips, int cols) {
  const int64_t tiles = (cols + 31) / 32;
  return tiles > 1 && strips * tiles <= INT32_MAX ? static_cast<int>(tiles)
                                                  : 1;
}

template <typename L, int VL, bool W>
void launch(const void* src, const int32_t* idx, const float* wt,
            const int64_t* ptr, void* out, int64_t rows, int dim, int sms,
            int dev, cudaStream_t stream) {
  using E = typename L::E;
  static bool sized[64] = {false};   // the shared-memory limit, by device
  if (!sized[dev & 63]) {
    cudaFuncSetAttribute(csr_gather_sum_kernel<L, VL, W>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes<W>);
    sized[dev & 63] = true;
  }
  const int long_blocks = static_cast<int>(
      lesser<int64_t>(rows, static_cast<int64_t>(kLongBlocksPerSm) * sms));
  const int64_t strips = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int split = column_split(strips, dim / L::kV);
  const int64_t warps = strips * split;
  const int64_t blocks = long_blocks + (warps + kWarps - 1) / kWarps;
  csr_gather_sum_kernel<L, VL, W>
      <<<static_cast<unsigned>(blocks), kThreads, kSmemBytes<W>, stream>>>(
          static_cast<const E*>(src), idx, wt, ptr, static_cast<E*>(out),
          rows, dim, long_blocks, split);
}

int sm_count(int dev) {
  static int cached[64] = {0};
  int& n = cached[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// The short rows' lane policy for element type E, V elements a lane.
template <typename E, int V> struct LaneFor { using T = Lane16<E, V>; };
template <int V> struct LaneFor<float, V> { using T = LaneF32<V>; };

// One (VL, V) pair of dispatch's switch. An f32 row never takes 8
// elements a vector (copy_width stops at 4), so those are not built.
template <typename E, int VL, int V, bool W>
void launch_at(const void* src, const int32_t* idx, const float* wt,
               const int64_t* ptr, void* out, int64_t rows, int dim, int sms,
               int dev, cudaStream_t stream) {
  if constexpr (sizeof(E) == 2 || VL <= 4) {
    launch<typename LaneFor<E, V>::T, VL, W>(src, idx, wt, ptr, out, rows,
                                             dim, sms, dev, stream);
  }
}

// A row of `dim` elements of E: the long rows' copies take VL elements
// (copy_width), the short rows' lanes V (vec_width); V <= VL.
template <typename E, bool W>
void dispatch(const void* src, const int32_t* idx, const float* wt,
              const int64_t* ptr, void* out, int64_t rows, int dim,
              cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = sm_count(dev);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out);
  constexpr bool kF32 = sizeof(E) == 4;
  const int vl = kF32 ? gather::copy_width(dim, bits)
                      : gather::copy_width16(dim, bits);
  const int v = kF32 ? gather::vec_width(dim, bits)
                     : gather::vec_width16(dim, bits);
  const auto a = std::make_tuple(src, idx, wt, ptr, out, rows, dim, sms, dev,
                                 stream);
  switch (vl * 10 + v) {
    case 88: std::apply(launch_at<E, 8, 8, W>, a); break;
    case 84: std::apply(launch_at<E, 8, 4, W>, a); break;
    case 82: std::apply(launch_at<E, 8, 2, W>, a); break;
    case 81: std::apply(launch_at<E, 8, 1, W>, a); break;
    case 44: std::apply(launch_at<E, 4, 4, W>, a); break;
    case 42: std::apply(launch_at<E, 4, 2, W>, a); break;
    case 41: std::apply(launch_at<E, 4, 1, W>, a); break;
    case 22: std::apply(launch_at<E, 2, 2, W>, a); break;
    case 21: std::apply(launch_at<E, 2, 1, W>, a); break;
    default: std::apply(launch_at<E, 1, 1, W>, a);
  }
}

}  // namespace

// src f32 [*, dim]; idx int32 [nnz] (rows of src); ptr int64 [rows + 1]
// ascending from ptr[0] = 0 (values past ptr[rows] are not read); out f32
// [rows, dim].
extern "C" int csr_gather_sum_launch(const float* src, const int32_t* idx,
                                     const int64_t* ptr, float* out,
                                     int64_t rows, int dim,
                                     cudaStream_t stream) {
  if (rows > 0 && dim > 0) {
    dispatch<float, false>(src, idx, nullptr, ptr, out, rows, dim, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with weights: wt f32 [nnz], value j scaled by wt[j].
extern "C" int csr_gather_sum_weighted_launch(const float* src,
                                              const int32_t* idx,
                                              const float* wt,
                                              const int64_t* ptr, float* out,
                                              int64_t rows, int dim,
                                              cudaStream_t stream) {
  if (rows > 0 && dim > 0) {
    dispatch<float, true>(src, idx, wt, ptr, out, rows, dim, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// 16-bit rows: dtype 1 bf16, 2 f16 (platform.DTYPES); src and out have
// that type, the sums are f32 rounded once.
extern "C" int csr_gather_sum16_launch(const void* src, const int32_t* idx,
                                       const int64_t* ptr, void* out,
                                       int64_t rows, int dim, int dtype,
                                       cudaStream_t stream) {
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && dim > 0) {
    if (dtype == 1) {
      dispatch<__nv_bfloat16, false>(src, idx, nullptr, ptr, out, rows, dim,
                                      stream);
    } else {
      dispatch<__half, false>(src, idx, nullptr, ptr, out, rows, dim, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
