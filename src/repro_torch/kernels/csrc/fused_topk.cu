// Fused score -> top-k for Hopper (sm_90a): the top-k of u . items^T + mask
// per query row, without the [B, N] score matrix in device memory.
//
// Replaces two TPU kernels of src/repro/kernels/fused_topk.py:
//  * fused_topk_pallas (pl.pallas_call at :229): items are an [N, d] matrix;
//  * fused_topk_codebook_pallas (pl.pallas_call at :347): items are implicit,
//    v_i = sum_h keep_h * dequant(Z[sketch[i, h]]) with the binary-Y rule (a
//    repeated index in a sketch row counts once), so the expanded [N, d]
//    table never exists.
// Both variants share the scoring, selection and merge below; only the
// item-row loader (a template parameter) differs. The contract: values f32
// [B, k] and ids int32 [B, k], highest value first and the LOWEST id among
// equal values (lax.top_k's order), excluded and masked items score -inf and
// remain candidates (a row with fewer than k finite scores fills with the
// lowest-id -inf items), int8 rows dequantize in the kernel as
// float(q) * scale[r] (r the item, or the codebook row in the codebook
// variant, which dequantizes each row before the h sum, adding in h order
// from +0.0 without contraction, the order of the plain version), and
// equal values compare by IEEE equality (so -0.0 ties +0.0, the
// reference's carve-out). NaN ranks above every number, lowest id first
// among NaNs (lax.top_k's order for a NaN with a clear sign bit).
// k <= kMaxK (128) and d <= kMaxDim, compile-time caps. Each score is
// fmaf(u[c], v[c], s) over c = 0..d-1 from +0.0, then + mask: the same
// chain in every version of this kernel, so values repeat bit for bit.
//
// What bounds it on the H100: operations. At the serving shapes (N = 91,599
// items, d = 64, B up to 512) the scores cost 2*B*N*d f32 operations
// (6.0 GFLOP at B = 512, ~90 us at 67 TFLOP/s). They stay on the CUDA
// cores: TF32 would round u and v to 10 bits and move scores far outside
// the near-tie band. The bytes are the item table once (23 MB, ~7 us at
// 3.35 TB/s), which bounds B = 1 and 8. The codebook variant reads the
// codebook (4.4 MB for K = 17,136 at f32) and the sketch instead.
//
// Times (chip_smoke.py's kernels line, H100 80GB HBM3, 700.00 W): B 512,
// k 20: 0.3940 ms; k 64 / 100 / 128 (lists of 64 and 128 keys): 0.4167 /
// 0.4806 / 0.4815 ms, against 1.296 ms at k 100 before the long lists'
// redesign and torch.topk(u @ v.T + mask, k) at 1.08 ms. The k 100 score
// kernel was two waves of 136 blocks on 132 slots at one block an SM, each
// chunk admitting ~500 keys a row: 1.26 of its 1.29 ms
// (tools/fused_topk_parity.py's profile split; now 0.45 of 0.48).
//
// Design:
//  * score_chunks_kernel: grid (item chunks, groups of 64 query rows, 48 at
//    R = 4), 256 threads. The block's query rows sit in shared memory; the
//    chunk's items are staged kItems = 64 at a time, kSlice = 32 columns
//    per step, double-buffered (cp.async for dense f32 rows; the int8 and
//    codebook loaders dequantize and expand on the way in). Each thread
//    holds a 4 rows x 4 items register tile (3 x 4 at R = 4): per 4 columns
//    it reads 4 + 4 float4 from shared memory for 64 FMAs.
//    Selection: a candidate is an order key, value and id in one 64-bit
//    integer whose integer order is the total order below. Each row keeps
//    its best 32 R keys, sorted (R = 1, 2 or 4 keys a lane: the smallest
//    that holds k, a template parameter), and its k-th key as a
//    threshold. A score
//    below the threshold's value is dropped with one float compare, one
//    whose key does not beat the threshold with one more; a survivor goes
//    to the row's candidate buffer (a shared-memory atomic counter). Once a
//    row holds more than merge_at(R) candidates, and at the chunk's end,
//    a warp merges the buffer into the row's list, R keys per lane (key i
//    of the list in register i / 32 of lane i % 32): up to insert_max(R)
//    survivors of a batch of 32 one at a time (ballots find the slot,
//    shuffles shift the tail), more as a bitonic sort of the 32 on
//    registers, a max of the reversed batch against the list's last 32 and
//    a bitonic merge of all 32 R (across registers, then across lanes).
//    No runtime-indexed local arrays. The chunk's top-k goes to scratch.
//  * Long lists (R = 2, 4: k 33-128) share a bound across a row's chunks.
//    A chunk's own threshold rises only once k of its items have arrived,
//    so each chunk admits about k (1 + ln(chunk / k)) keys: ~500 a row at
//    k 100, each merged at R = 4. Every chunk c of a row publishes its
//    list's pub-th key, pub = ceil(k / n_chunks), into bounds[row][c]
//    (atomicMax: a list's keys only rise) after each merge. Each chunk
//    holds pub keys at or above its published key, so the n_chunks chunks
//    hold at least k keys at or above the least published key: the least
//    never exceeds the row's final k-th key, and unpublished chunks (0)
//    keep it at 0 until every chunk has one. After tiles 1, 2, 4, 8, ...
//    a warp reads the least for each of its rows (one L2 trip, past L1)
//    and the row's filter becomes max(own k-th, least): after its first
//    tile a chunk then admits about pub keys a row for each doubling of
//    its tiles. A key equal to the least is that of the item that set it,
//    which already sits in its chunk's list, so the filter stays strict
//    ("beats") and the result is the same set, bitwise: the bound only
//    drops keys that cannot be in the top-k. It is used where the caller
//    passes the bounds scratch (kernels/fused_topk.py::shares_bounds:
//    where rows x R reaches 256): for a few rows its memset and L2 trips
//    cost more than the merges they save (PERF.md, section 6, from
//    tools/fused_topk_parity.py's sweep).
//  * Occupancy: at R = 2 and 4 the candidate buffer keeps 88 slots a row
//    (cap), and an R = 4 block holds 48 query rows, so two blocks share a
//    multiprocessor at d <= 64, as at R = 1.
//  * merge_chunks_kernel: one block per row; each warp filters and merges a
//    share of the chunks' lists the same way, then warp 0 merges the
//    warps' lists. At R > 1 the row's final least bound drops every chunk
//    key below it at once (keys equal to it are kept: its item is here).
//  Candidates are ordered by (NaN first, value desc, id asc), a total order
//  on distinct ids, so the result does not depend on arrival order or block
//  scheduling: it is deterministic.
//  Exclusions arrive as a per-row sorted id list (CSR); a thread tests its
//  item with a binary search.
//  The caller picks the chunk size (kernels/fused_topk.py::plan_chunk)
//  from the tiling and occupancy that fused_topk_tiling reports.
//
// C interface (loaded with ctypes): the launch runs on the caller's stream,
// allocates nothing (the caller passes the chunk scratch and, at k > 32,
// the bounds scratch or null; the launch zeroes the bounds with
// cudaMemsetAsync), and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 128;          // 32 keys a lane x R = 4
constexpr int kMaxDim = 256;
constexpr int kItems = 64;          // items per tile
constexpr int kSlice = 32;          // columns staged per step
constexpr int kThreads = 256;       // 16 x 16, tile_rows x 4 items each
constexpr int kVLd = kSlice + 4;    // staged item row stride (floats)
constexpr int32_t kNoId = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// The total order as one integer: a larger key ranks first. NaN above every
// number, then the value (IEEE equality: -0.0 ties +0.0), then the lower
// id. kNone is (-inf, kNoId): below every item.
__device__ __forceinline__ uint64_t key_of(float v, int32_t id) {
  uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  b = isnan(v) ? 0xffffffffu : (b >> 31 ? ~b : b | 0x80000000u);
  return (static_cast<uint64_t>(b) << 32) | static_cast<uint32_t>(~id);
}
__device__ __forceinline__ float value_of(uint64_t key) {
  const uint32_t b = static_cast<uint32_t>(key >> 32);
  if (b == 0xffffffffu) return __uint_as_float(0x7fffffffu);
  return __uint_as_float(b >> 31 ? b & 0x7fffffffu : ~b);
}
__device__ __forceinline__ int32_t id_of(uint64_t key) {
  return ~static_cast<int32_t>(static_cast<uint32_t>(key));
}
constexpr uint64_t kNone = (static_cast<uint64_t>(0x007fffffu) << 32) |
                           static_cast<uint32_t>(~kNoId);

// Compare-exchange with the lane at distance j: keep the larger key when
// keep_larger, else the smaller. Keys of distinct ids differ; equal keys
// are both kNone.
__device__ __forceinline__ void cas(uint64_t& x, int j, bool keep_larger) {
  const uint64_t o = __shfl_xor_sync(kFull, x, j);
  if ((o > x) == keep_larger) x = o;
}

// Sort the warp's 32 keys, one per lane, largest first.
__device__ __forceinline__ void bitonic_sort(uint64_t& x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1)
      cas(x, j, ((lane & size) == 0) == ((lane & j) == 0));
}

// Survivors of a batch inserted one at a time before a full merge pays:
// an insert costs about 3 R shuffles, a merge about 16 + 5 R.
template <int R>
__host__ __device__ constexpr int insert_max() {
  return R == 1 ? 12 : (R == 2 ? 6 : 4);
}

// The list: 32 R keys sorted largest first, key i in register i / 32 of
// lane i % 32. Its k-th key (the same in every lane).
template <int R>
__device__ __forceinline__ uint64_t kth(const uint64_t (&list)[R], int k) {
  const int reg = (k - 1) >> 5;
  uint64_t t = list[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (reg == r) t = list[r];
  return __shfl_sync(kFull, t, (k - 1) & 31);
}

// Merge the 32 keys c into the list, keeping the largest 32 R of the
// union, sorted: the sorted batch reversed against the list's last 32 (a
// max gives the largest 32 R as one bitonic sequence), then a bitonic merge
// across registers and across lanes.
template <int R>
__device__ __forceinline__ void merge_into(uint64_t (&list)[R], uint64_t c,
                                           int lane) {
  bitonic_sort(c, lane);
  const uint64_t o = __shfl_sync(kFull, c, 31 - lane);
  if (o > list[R - 1]) list[R - 1] = o;
#pragma unroll
  for (int s = R / 2; s > 0; s >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((r & s) == 0 && r + s < R) {
        const uint64_t a = list[r], b = list[r + s];
        list[r] = a > b ? a : b;
        list[r + s] = a > b ? b : a;
      }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) cas(list[r], j, (lane & j) == 0);
}

// Insert the key x (the same in every lane) into the sorted list.
template <int R>
__device__ __forceinline__ void insert(uint64_t (&list)[R], uint64_t x,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) pos += __popc(__ballot_sync(kFull, list[r] > x));
  uint64_t prev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    prev[r] = __shfl_up_sync(kFull, list[r], 1);
    if (r > 0) {                      // lane 0 takes the previous register's
      const uint64_t carry = __shfl_sync(kFull, list[r > 0 ? r - 1 : 0], 31);
      if (lane == 0) prev[r] = carry; // last key
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    if (i > pos) list[r] = prev[r];
    else if (i == pos) list[r] = x;
  }
}

// Take the keys c (one per lane, kNone where absent) that beat thr into
// the list: one by one when few survive, else as one bitonic merge. thr
// follows the list: its k-th key, or floor where that is higher (a key no
// candidate that matters can be at or below; 0 when there is none).
template <int R>
__device__ __forceinline__ void absorb(uint64_t (&list)[R], uint64_t& thr,
                                       uint64_t c, int k, int lane,
                                       uint64_t floor) {
  unsigned m = __ballot_sync(kFull, c > thr);
  if (m == 0) return;
  if (__popc(m) <= insert_max<R>()) {
    while (m != 0) {
      const uint64_t x = __shfl_sync(kFull, c, __ffs(m) - 1);
      m &= m - 1;
      if (x > thr) {
        insert(list, x, lane);
        const uint64_t t = kth(list, k);
        thr = t > floor ? t : floor;
      }
    }
  } else {
    merge_into(list, c > thr ? c : kNone, lane);
    const uint64_t t = kth(list, k);
    thr = t > floor ? t : floor;
  }
}

__device__ __forceinline__ bool excluded(const int32_t* ids, int lo, int hi,
                                         int32_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t y = ids[mid];
    if (y == x) return true;
    if (y < x) lo = mid + 1; else hi = mid;
  }
  return false;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Item-row loaders: columns col..col+3 of item it of the f32 item matrix
// (zero past d). kAsync: the rows are f32 in device memory and may be
// copied with cp.async when vec (d % 4 == 0, 16-byte aligned).
struct DenseRows {
  static constexpr bool kAsync = true;
  const float* items;
  int vec;
  __device__ __forceinline__ void load4(int it, int col, int d,
                                        float (&o)[4]) const {
    const float* r = items + static_cast<int64_t>(it) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = col + j < d ? r[col + j] : 0.0f;
  }
};

struct DenseRowsInt8 {
  static constexpr bool kAsync = false;
  const int8_t* items;
  const float* scale;                  // [N]
  __device__ __forceinline__ void load4(int it, int col, int d,
                                        float (&o)[4]) const {
    const int8_t* r = items + static_cast<int64_t>(it) * d;
    const float s = scale[it];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = col + j < d ? static_cast<float>(r[col + j]) * s : 0.0f;
  }
};

template <bool kQuant>
struct CodebookRows {
  static constexpr bool kAsync = false;
  const void* codebook;                // f32 or int8 [K, d]
  const float* scale;                  // [K] when kQuant
  const int32_t* sketch;               // [N, n_hot]
  int n_hot;
  __device__ __forceinline__ void load4(int it, int col, int d,
                                        float (&o)[4]) const {
    const int32_t* r = sketch + static_cast<int64_t>(it) * n_hot;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = 0.0f;
    for (int h = 0; h < n_hot; ++h) {
      const int32_t cur = r[h];
      bool dup = false;
      for (int j = 0; j < h; ++j) dup = dup || (r[j] == cur);
      if (dup) continue;
      const int64_t at = static_cast<int64_t>(cur) * d;
      const float s = kQuant ? scale[cur] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j >= d) continue;
        const float x =
            kQuant ? __fmul_rn(static_cast<float>(
                                   static_cast<const int8_t*>(codebook)[at +
                                                                        col +
                                                                        j]),
                               s)
                   : static_cast<const float*>(codebook)[at + col + j];
        o[j] = __fadd_rn(o[j], x);
      }
    }
  }
};

// Stage columns [c0, c0 + kSlice) of items [base, base + kItems) (zeros
// past hi and past d) into vs [kItems][kVLd].
template <class Rows>
__device__ __forceinline__ void stage(const Rows& load, float* vs, int base,
                                      int hi, int c0, int d, int tid) {
  constexpr int kGroups = kItems * (kSlice / 4);
#pragma unroll
  for (int e = tid; e < kGroups; e += kThreads) {
    const int j = e / (kSlice / 4);
    const int col = c0 + 4 * (e % (kSlice / 4));
    float* dst = vs + j * kVLd + (col - c0);
    const int it = base + j;
    if constexpr (Rows::kAsync) {
      if (load.vec) {
        const bool in = it < hi && col < d;
        cp_async16(dst, in ? load.items + static_cast<int64_t>(it) * d + col
                           : load.items,
                   in ? 16 : 0);
        continue;
      }
    }
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (it < hi && col < d) load.load4(it, col, d, o);
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// One warp merges a row's candidate buffer into its list (32 R keys in
// shared memory, in list order) and refreshes its threshold (the list's k-th
// key, or floor where that is higher). Returns the list's pub-th key.
template <int R>
__device__ __forceinline__ uint64_t merge_row(uint64_t* list,
                                              const uint64_t* cand, int cnt,
                                              int k, uint64_t* thr,
                                              uint64_t floor, int pub,
                                              int lane) {
  uint64_t l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = list[r * 32 + lane];
  uint64_t t = *thr;
  for (int base = 0; base < cnt; base += 32)
    absorb(l, t, base + lane < cnt ? cand[base + lane] : kNone, k, lane,
           floor);
#pragma unroll
  for (int r = 0; r < R; ++r) list[r * 32 + lane] = l[r];
  if (lane == 0) *thr = t;
  if constexpr (R > 1) return kth(l, pub);
  return 0;
}

// Raise floor[r] to the least of row (row0 + r)'s published chunk keys
// (bounds[row][0, n_chunks)) for the warp's rows r = warp + 8 i, i < N (8
// warps a block): no greater than the row's k-th key (see the head of the
// file), 0 while a chunk has published nothing. Read past L1 (other
// blocks write them), every row's loads in flight at once.
template <int N>
__device__ __forceinline__ void raise_floors(uint64_t* floor,
                                             const uint64_t* bounds,
                                             int row0, int rows, int n_chunks,
                                             int warp, int lane) {
  uint64_t m[N];
#pragma unroll
  for (int i = 0; i < N; ++i) m[i] = ~0ull;
#pragma unroll 4
  for (int c = lane; c < n_chunks; c += 32)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = row0 + warp + (kThreads / 32) * i;
      if (row < rows) {
        const uint64_t b = *reinterpret_cast<const volatile uint64_t*>(
            bounds + static_cast<int64_t>(row) * n_chunks + c);
        m[i] = b < m[i] ? b : m[i];
      }
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, m[i], j);
      m[i] = o < m[i] ? o : m[i];
    }
    const int r = warp + (kThreads / 32) * i;
    if (lane == 0 && row0 + r < rows && m[i] > floor[r]) floor[r] = m[i];
  }
}

// A block's query rows: kRows = block_rows(R) (see below)
struct Smem {
  float* us;        // [kRows][ud]
  float* vs;        // [2][kItems][kVLd]
  uint64_t* cand;   // [kRows][cap(R)]
  uint64_t* list;   // [kRows][32 R]
  uint64_t* thr;    // [kRows]
  uint64_t* floor;  // [kRows] when R > 1: the rows' least bounds
  int* cnt;         // [kRows]
};

__host__ __device__ constexpr int padded_dim(int d) {
  return (d + kSlice - 1) / kSlice * kSlice;
}

// The keys a lane holds for a list of k: 1, 2 or 4.
__host__ __device__ constexpr int lane_keys(int k) {
  return k <= 32 ? 1 : (k <= 64 ? 2 : 4);
}

// The query rows a thread scores (its register tile's height) and a
// block's rows at R keys a lane: 4 and 64, or 3 and 48 at R = 4.
__host__ __device__ constexpr int tile_rows(int r) { return r == 4 ? 3 : 4; }
__host__ __device__ constexpr int block_rows(int r) {
  return 16 * tile_rows(r);
}

// Candidate slots a row at R keys a lane: a tile's kItems beside the
// merge_at(R) a row may hold before it merges. 88 at R > 1 (and 48 rows at
// R = 4) lets two blocks share a multiprocessor at d <= 64: 114,944 bytes
// each at R = 2, 115,392 at R = 4.
__host__ __device__ constexpr int cap(int r) { return r == 1 ? 96 : 88; }
__host__ __device__ constexpr int merge_at(int r) { return cap(r) - kItems; }

__host__ __device__ inline size_t smem_bytes(int d, int r) {
  const int ud = padded_dim(d) + 4;
  const size_t rows = block_rows(r);
  return sizeof(float) * (rows * ud + 2 * kItems * kVLd) +
         sizeof(uint64_t) * rows * (cap(r) + 32 * r + (r > 1 ? 2 : 1)) +
         sizeof(int) * rows;
}

template <class Rows, int R>
__global__ void __launch_bounds__(kThreads, 2)
score_chunks_kernel(const float* __restrict__ u, const Rows load,
                    const float* __restrict__ mask,
                    const int32_t* __restrict__ ex_ptr,
                    const int32_t* __restrict__ ex_ids, int rows, int n, int d,
                    int k, int chunk, int n_chunks, float* __restrict__ part_v,
                    int32_t* __restrict__ part_i, uint64_t* bounds) {
  constexpr int kCap = cap(R);
  constexpr int TR = tile_rows(R);
  constexpr int kRows = block_rows(R);
  constexpr bool kShare = R > 1;       // chunks may share the rows' bounds
  const bool share = kShare && bounds != nullptr;
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_dim(d);
  const int ud = dp + 4;
  Smem sm;
  sm.us = smem;
  sm.vs = sm.us + kRows * ud;
  sm.cand = reinterpret_cast<uint64_t*>(sm.vs + 2 * kItems * kVLd);
  sm.list = sm.cand + kRows * kCap;
  sm.thr = sm.list + kRows * 32 * R;
  sm.floor = sm.thr + kRows;
  sm.cnt = reinterpret_cast<int*>(sm.floor + (kShare ? kRows : 0));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * kRows;
  const int c = blockIdx.x;
  const int lo = c * chunk;
  const int hi = min(n, lo + chunk);
  const int n_slices = dp / kSlice;
  const int n_steps = (hi - lo + kItems - 1) / kItems * n_slices;
  // the rank of the key a chunk publishes: n_chunks chunks x pub keys >= k
  const int pub = (k + n_chunks - 1) / n_chunks;

  for (int t = tid; t < kRows * ud; t += kThreads) {
    const int r = t / ud, col = t % ud;
    sm.us[t] = (row0 + r < rows && col < d)
                   ? u[static_cast<int64_t>(row0 + r) * d + col]
                   : 0.0f;
  }
  for (int t = tid; t < kRows * 32 * R; t += kThreads) sm.list[t] = kNone;
  if (tid < kRows) {
    sm.thr[tid] = kNone;
    sm.cnt[tid] = 0;
    if constexpr (kShare) sm.floor[tid] = 0;   // raised only when share
  }
  // this thread's rows ty + 16 i and items tx + 16 j of each tile; each
  // row's threshold as a key and as a value (for a one-compare reject)
  uint64_t tk[TR];
  float tv[TR];
  int ex_lo[TR], ex_hi[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    tk[i] = kNone;
    tv[i] = -INFINITY;
    const int row = row0 + ty + 16 * i;
    ex_lo[i] = ex_hi[i] = 0;
    if (ex_ptr != nullptr && row < rows) {
      ex_lo[i] = ex_ptr[row];
      ex_hi[i] = ex_ptr[row + 1];
    }
  }

  float acc[TR][4];
  if (n_steps > 0) stage(load, sm.vs, lo, hi, 0, d, tid);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_slices, slice = step % n_slices;
    const int base = lo + tile * kItems;
    if (step + 1 < n_steps) {
      const int nt = (step + 1) / n_slices, ns = (step + 1) % n_slices;
      stage(load, sm.vs + ((step + 1) & 1) * kItems * kVLd,
            lo + nt * kItems, hi, ns * kSlice, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (slice == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    const float* vs = sm.vs + (step & 1) * kItems * kVLd;
    const float* ur = sm.us + slice * kSlice;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      float4 a[TR], b[4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(ur + (ty + 16 * i) * ud + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * kVLd +
                                                kk);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    const bool last_slice = slice == n_slices - 1;
    if (last_slice) {                  // the tile's scores are complete
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int it = base + tx + 16 * j;
        if (it >= hi) continue;
        const float mk = mask != nullptr ? mask[it] : 0.0f;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = ty + 16 * i;
          if (row0 + r >= rows) continue;
          float s = acc[i][j];
          if (mask != nullptr) s = __fadd_rn(s, mk);
          if (ex_hi[i] > ex_lo[i] && excluded(ex_ids, ex_lo[i], ex_hi[i], it))
            s = -INFINITY;
          if (!(s < tv[i])) {
            const uint64_t key = key_of(s, it);
            if (key > tk[i]) sm.cand[r * kCap + atomicAdd(sm.cnt + r, 1)] = key;
          }
        }
      }
    }
    __syncthreads();                   // the stage is spent; pushes landed
    if (last_slice) {
      const bool final_tile = step == n_steps - 1;
      for (int r = warp; r < kRows; r += kThreads / 32) {
        const int cnt = sm.cnt[r];
        if (cnt > merge_at(R) || (final_tile && cnt > 0)) {
          const uint64_t b = merge_row<R>(
              sm.list + r * 32 * R, sm.cand + r * kCap, cnt, k, sm.thr + r,
              kShare ? sm.floor[r] : 0, pub, lane);
          if (lane == 0) {
            sm.cnt[r] = 0;
            if (share && row0 + r < rows)
              atomicMax(reinterpret_cast<unsigned long long*>(bounds) +
                            static_cast<int64_t>(row0 + r) * n_chunks + c,
                        static_cast<unsigned long long>(b));
          }
        }
      }
      // the rows' least bounds, after tiles 1, 2, 4, 8, ... (one trip to
      // L2 each: the bound rises fastest early)
      if (share && !final_tile && ((tile + 1) & tile) == 0)
        raise_floors<kRows / (kThreads / 32)>(sm.floor, bounds, row0, rows,
                                               n_chunks, warp, lane);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        tk[i] = sm.thr[ty + 16 * i];
        if constexpr (kShare) {
          const uint64_t f = sm.floor[ty + 16 * i];
          if (f > tk[i]) tk[i] = f;
        }
        tv[i] = value_of(tk[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int t = tid; t < kRows * k; t += kThreads) {
    const int r = t / k, j = t % k;
    if (row0 + r >= rows) continue;
    const int64_t off = (static_cast<int64_t>(row0 + r) * n_chunks + c) * k;
    const uint64_t key = sm.list[r * 32 * R + j];
    part_v[off + j] = value_of(key);
    part_i[off + j] = id_of(key);
  }
}

// One block per row: each warp filters and merges a strided share of the
// row's n_chunks x k chunk candidates, then warp 0 merges the warps' lists.
// With the rows' bounds (R > 1) a candidate below the row's least bound is
// dropped by the first compare. (A variant that read only each sorted
// chunk list's keys above the bound was slower side by side.)
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
merge_chunks_kernel(const float* __restrict__ part_v,
                    const int32_t* __restrict__ part_i, int n_chunks, int k,
                    const uint64_t* __restrict__ bounds,
                    float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kAhead = 4;            // batches loaded before filtering
  __shared__ uint64_t lists[kWarps * 32 * R];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x;
  const int n_cand = n_chunks * k;
  const float* pv = part_v + row * n_cand;
  const int32_t* pi = part_i + row * n_cand;
  // keys at or above the least bound: it is the key of a candidate that
  // may be the row's k-th
  uint64_t floor = 0;
  if (R > 1 && bounds != nullptr) {
    uint64_t m = ~0ull;
    for (int c = lane; c < n_chunks; c += 32) {
      const uint64_t b = bounds[row * n_chunks + c];
      m = b < m ? b : m;
    }
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, m, j);
      m = o < m ? o : m;
    }
    floor = m > 0 ? m - 1 : 0;
  }
  uint64_t list[R], thr = kNone > floor ? kNone : floor;
#pragma unroll
  for (int r = 0; r < R; ++r) list[r] = kNone;
  for (int base = warp * 32; base < n_cand; base += kAhead * kThreads) {
    uint64_t c[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int j = base + a * kThreads + lane;
      c[a] = j < n_cand ? key_of(pv[j], pi[j]) : kNone;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) absorb(list, thr, c[a], k, lane, floor);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) lists[(warp * R + r) * 32 + lane] = list[r];
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w)
#pragma unroll
    for (int r = 0; r < R; ++r)
      absorb(list, thr, lists[(w * R + r) * 32 + lane], k, lane, floor);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    if (j < k) {
      out_v[row * k + j] = value_of(list[r]);
      out_i[row * k + j] = id_of(list[r]);
    }
  }
}

// Lets score_chunks_kernel<Rows, R> take its shared memory at width d.
template <class Rows, int R>
cudaError_t allow_smem(int d) {
  return cudaFuncSetAttribute(score_chunks_kernel<Rows, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(d, R)));
}

// The score blocks of loader Rows and R keys a lane one multiprocessor
// holds at width d.
template <class Rows, int R>
int blocks_per_sm(int d, int* blocks) {
  cudaError_t err = allow_smem<Rows, R>(d);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, score_chunks_kernel<Rows, R>, kThreads, smem_bytes(d, R));
  return static_cast<int>(err);
}

template <class Rows>
int blocks_per_sm_k(int d, int k, int* blocks) {
  switch (lane_keys(k)) {
    case 1: return blocks_per_sm<Rows, 1>(d, blocks);
    case 2: return blocks_per_sm<Rows, 2>(d, blocks);
    default: return blocks_per_sm<Rows, 4>(d, blocks);
  }
}

template <class Rows, int R>
int launch_r(const float* u, const Rows& load, const float* mask,
             const int32_t* ex_ptr, const int32_t* ex_ids, int rows, int n,
             int d, int k, int chunk, float* part_v, int32_t* part_i,
             uint64_t* bounds, float* out_v, int32_t* out_i,
             cudaStream_t stream) {
  const int n_chunks = (n + chunk - 1) / chunk;
  const dim3 grid(n_chunks, (rows + block_rows(R) - 1) / block_rows(R));
  cudaError_t err = allow_smem<Rows, R>(d);
  if (err == cudaSuccess && R > 1 && bounds != nullptr)   // 0: unpublished
    err = cudaMemsetAsync(
        bounds, 0, sizeof(uint64_t) * static_cast<size_t>(rows) * n_chunks,
        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_chunks_kernel<Rows, R><<<grid, kThreads, smem_bytes(d, R), stream>>>(
      u, load, mask, ex_ptr, ex_ids, rows, n, d, k, chunk, n_chunks, part_v,
      part_i, bounds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_chunks_kernel<R><<<rows, kThreads, 0, stream>>>(
      part_v, part_i, n_chunks, k, bounds, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch(const float* u, const Rows& load, const float* mask,
           const int32_t* ex_ptr, const int32_t* ex_ids, int rows, int n,
           int d, int k, int chunk, float* part_v, int32_t* part_i,
           uint64_t* bounds, float* out_v, int32_t* out_i,
           cudaStream_t stream) {
  if (k < 1 || k > kMaxK || d < 1 || d > kMaxDim || chunk < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  switch (lane_keys(k)) {
    case 1:
      return launch_r<Rows, 1>(u, load, mask, ex_ptr, ex_ids, rows, n, d, k,
                               chunk, part_v, part_i, bounds, out_v, out_i,
                               stream);
    case 2:
      return launch_r<Rows, 2>(u, load, mask, ex_ptr, ex_ids, rows, n, d, k,
                               chunk, part_v, part_i, bounds, out_v, out_i,
                               stream);
    default:
      return launch_r<Rows, 4>(u, load, mask, ex_ptr, ex_ids, rows, n, d, k,
                               chunk, part_v, part_i, bounds, out_v, out_i,
                               stream);
  }
}

}  // namespace

extern "C" int fused_topk_max_k() { return kMaxK; }
extern "C" int fused_topk_max_dim() { return kMaxDim; }

// What the caller's chunk plan needs (kernels/fused_topk.py::plan_chunk):
// the query rows of one score block (grid.y = ceil(rows / rows_per_block)),
// the items of one tile, and the score blocks one multiprocessor of the
// current device holds at width d and top-k size k (its list's shared
// memory) with the loader of (codebook, quantized).
extern "C" int fused_topk_tiling(int d, int codebook, int quantized, int k,
                                 int* rows_per_block, int* items_per_tile,
                                 int* blocks) {
  if (d < 1 || d > kMaxDim || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  *rows_per_block = block_rows(lane_keys(k));
  *items_per_tile = kItems;
  if (codebook)
    return quantized ? blocks_per_sm_k<CodebookRows<true>>(d, k, blocks)
                     : blocks_per_sm_k<CodebookRows<false>>(d, k, blocks);
  return quantized ? blocks_per_sm_k<DenseRowsInt8>(d, k, blocks)
                   : blocks_per_sm_k<DenseRows>(d, k, blocks);
}

// u f32 [rows, d]; items f32 or int8 [n, d] (quantized != 0: int8 with
// scale f32 [n]); mask f32 [n] or null; ex_ptr int32 [rows + 1] and ex_ids
// (per-row ascending item ids) or null; part_v/part_i scratch
// [rows, n_chunks, k]; bounds scratch of rows x n_chunks 64-bit words, or
// null (no shared bound; unused at k <= 32); out_v/out_i [rows, k].
extern "C" int fused_topk_launch(const float* u, const void* items,
                                 const float* scale, const float* mask,
                                 const int32_t* ex_ptr, const int32_t* ex_ids,
                                 int rows, int n, int d, int k, int chunk,
                                 int quantized, float* part_v,
                                 int32_t* part_i, uint64_t* bounds,
                                 float* out_v, int32_t* out_i,
                                 cudaStream_t stream) {
  if (quantized) {
    const DenseRowsInt8 load{static_cast<const int8_t*>(items), scale};
    return launch(u, load, mask, ex_ptr, ex_ids, rows, n, d, k, chunk,
                  part_v, part_i, bounds, out_v, out_i, stream);
  }
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0;
  const DenseRows load{static_cast<const float*>(items), vec};
  return launch(u, load, mask, ex_ptr, ex_ids, rows, n, d, k, chunk, part_v,
                part_i, bounds, out_v, out_i, stream);
}

// As fused_topk_launch, with items implicit: codebook f32 or int8 [K, d]
// (quantized != 0: int8 with scale f32 [K]) and sketch int32 [n, n_hot];
// item i is sum_h of its sketch rows under the binary-Y rule.
extern "C" int fused_topk_codebook_launch(
    const float* u, const void* codebook, const float* scale,
    const int32_t* sketch, int n_hot, const float* mask,
    const int32_t* ex_ptr, const int32_t* ex_ids, int rows, int n, int d,
    int k, int chunk, int quantized, float* part_v, int32_t* part_i,
    uint64_t* bounds, float* out_v, int32_t* out_i, cudaStream_t stream) {
  if (n_hot < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (quantized) {
    const CodebookRows<true> load{codebook, scale, sketch, n_hot};
    return launch(u, load, mask, ex_ptr, ex_ids, rows, n, d, k, chunk,
                  part_v, part_i, bounds, out_v, out_i, stream);
  }
  const CodebookRows<false> load{codebook, scale, sketch, n_hot};
  return launch(u, load, mask, ex_ptr, ex_ids, rows, n, d, k, chunk, part_v,
                part_i, bounds, out_v, out_i, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
