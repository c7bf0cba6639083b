// Fused score -> top-k for Hopper (sm_90a): the top-k of u . items^T + mask
// per query row, without the [B, N] score matrix in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_topk.py::fused_topk_pallas
// (pl.pallas_call at :229), with the same contract: values f32 [B, k] and
// ids int32 [B, k], highest value first and the LOWEST id among equal
// values (lax.top_k's order), excluded and masked items score -inf and
// remain candidates (a row with fewer than k finite scores fills with the
// lowest-id -inf items), int8 rows dequantize in the kernel as
// float(q) * scale[i], and equal values compare by IEEE equality (so -0.0
// ties +0.0, the reference's carve-out). k <= kMaxK, a compile-time cap.
// NaN scores are not candidates (they lose every comparison).
//
// What bounds it on the H100: operations. At the serving shapes (N = 91,599
// items, d = 64, B up to 512) the scores cost 2*B*N*d f32 operations
// (6.0 GFLOP at B = 512, ~90 us at 67 TFLOP/s without tensor cores), while
// the bytes are the item table once (23 MB, ~7 us at 3.35 TB/s). At B = 1
// neither bound is reached and the time is the launch and the merge.
//
// Design (simple first; wgmma and TMA come later):
//  * score_chunks_kernel: grid (item chunks, row groups of kRows). The
//    block's kRows query rows sit in shared memory; the chunk's items are
//    staged kTile rows at a time (dequantized on the way in, rows padded to
//    d + 1 floats so lane j reading item j hits distinct banks); warp w
//    scores row w against the tile, one item per lane, and keeps a per-lane
//    sorted top-k in registers/local memory. A warp then merges its 32 lane
//    lists by k rounds of a shuffle arg-max and writes the chunk's top-k.
//    The item table is read from device memory about once and from L2 once
//    per row group; the scores never leave the SM.
//  * merge_chunks_kernel: one warp per row merges the chunks' lists.
//  Candidates are ordered by (value desc, id asc), a total order, so the
//  result does not depend on block scheduling: it is deterministic.
//  Exclusions arrive as a per-row sorted id list (CSR); a lane tests its
//  item with a binary search.
//
// C interface (loaded with ctypes): the launch runs on the caller's stream,
// allocates nothing (the caller passes the chunk scratch), and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxDim = 256;
constexpr int kRows = 8;            // query rows per block, one warp each
constexpr int kTile = 32;           // items staged per step, one per lane
constexpr int kThreads = kRows * 32;
constexpr int32_t kNoId = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int32_t ai, float bv,
                                       int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, id) into a lane's list sorted best-first (length k).
__device__ __forceinline__ void insert(float* lv, int32_t* li, int k, float v,
                                       int32_t id) {
  if (!better(v, id, lv[k - 1], li[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(v, id, lv[j - 1], li[j - 1])) {
    lv[j] = lv[j - 1];
    li[j] = li[j - 1];
    --j;
  }
  lv[j] = v;
  li[j] = id;
}

// Merge the warp's 32 sorted lane lists into the k best; lane 0 writes.
// Real candidates have distinct ids, so exactly one lane owns each winner.
__device__ void warp_merge(const float* lv, const int32_t* li, int k,
                           float* out_v, int32_t* out_i, int lane) {
  int head = 0;
  for (int r = 0; r < k; ++r) {
    const float v = head < k ? lv[head] : -INFINITY;
    const int32_t id = head < k ? li[head] : kNoId;
    float bv = v;
    int32_t bi = id;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int32_t oi = __shfl_xor_sync(kFull, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_v[r] = bv;
      out_i[r] = bi;
    }
    if (head < k && id == bi && v == bv) ++head;
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

template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
score_chunks_kernel(const float* __restrict__ u, const void* __restrict__ items,
                    const float* __restrict__ scale,
                    const float* __restrict__ mask,
                    const int32_t* __restrict__ ex_ptr,
                    const int32_t* __restrict__ ex_ids, int rows, int n, int d,
                    int k, int chunk, int n_chunks, float* __restrict__ part_v,
                    int32_t* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* us = smem;                    // [kRows][d]
  float* vs = smem + kRows * d;        // [kTile][d + 1]
  const int ld = d + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.y * kRows + warp;
  const int c = blockIdx.x;
  const int lo = c * chunk;
  const int hi = min(n, lo + chunk);

  for (int t = threadIdx.x; t < kRows * d; t += kThreads) {
    const int r = blockIdx.y * kRows + t / d;
    us[t] = r < rows ? u[static_cast<int64_t>(r) * d + t % d] : 0.0f;
  }
  float lv[kMaxK];
  int32_t li[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    lv[j] = -INFINITY;
    li[j] = kNoId;
  }
  int ex_lo = 0, ex_hi = 0;
  if (ex_ptr != nullptr && row < rows) {
    ex_lo = ex_ptr[row];
    ex_hi = ex_ptr[row + 1];
  }
  const float* ur = us + warp * d;

  for (int base = lo; base < hi; base += kTile) {
    __syncthreads();                   // previous tile consumed
    for (int t = threadIdx.x; t < kTile * d; t += kThreads) {
      const int j = t / d, col = t % d;
      const int it = base + j;
      float x = 0.0f;
      if (it < hi) {
        const int64_t at = static_cast<int64_t>(it) * d + col;
        if (kQuant) {
          x = static_cast<float>(static_cast<const int8_t*>(items)[at]) *
              scale[it];
        } else {
          x = static_cast<const float*>(items)[at];
        }
      }
      vs[j * ld + col] = x;
    }
    __syncthreads();
    const int it = base + lane;
    if (row < rows && it < hi) {
      const float* vr = vs + lane * ld;
      float s = 0.0f;
      for (int col = 0; col < d; ++col) s = fmaf(ur[col], vr[col], s);
      if (mask != nullptr) s = __fadd_rn(s, mask[it]);
      if (ex_hi > ex_lo && excluded(ex_ids, ex_lo, ex_hi, it)) s = -INFINITY;
      insert(lv, li, k, s, it);
    }
  }
  if (row < rows) {                    // warp-uniform
    const int64_t off = (static_cast<int64_t>(row) * n_chunks + c) * k;
    warp_merge(lv, li, k, part_v + off, part_i + off, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
merge_chunks_kernel(const float* __restrict__ part_v,
                    const int32_t* __restrict__ part_i, int rows, int n_cand,
                    int k, float* __restrict__ out_v,
                    int32_t* __restrict__ out_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;
  if (row >= rows) return;             // warp-uniform; no block barrier
  float lv[kMaxK];
  int32_t li[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    lv[j] = -INFINITY;
    li[j] = kNoId;
  }
  const float* pv = part_v + static_cast<int64_t>(row) * n_cand;
  const int32_t* pi = part_i + static_cast<int64_t>(row) * n_cand;
  for (int j = lane; j < n_cand; j += 32) insert(lv, li, k, pv[j], pi[j]);
  warp_merge(lv, li, k, out_v + static_cast<int64_t>(row) * k,
             out_i + static_cast<int64_t>(row) * k, lane);
}

}  // namespace

extern "C" int fused_topk_max_k() { return kMaxK; }
extern "C" int fused_topk_max_dim() { return kMaxDim; }

// u f32 [rows, d]; items f32 or int8 [n, d] (quantized != 0: int8 with
// scale f32 [n]); mask f32 [n] or null; ex_ptr int32 [rows + 1] and ex_ids
// (per-row ascending item ids) or null; part_v/part_i scratch
// [rows, n_chunks, k]; out_v/out_i [rows, k].
extern "C" int fused_topk_launch(const float* u, const void* items,
                                 const float* scale, const float* mask,
                                 const int32_t* ex_ptr, const int32_t* ex_ids,
                                 int rows, int n, int d, int k, int chunk,
                                 int quantized, float* part_v,
                                 int32_t* part_i, float* out_v,
                                 int32_t* out_i, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || d < 1 || d > kMaxDim || chunk < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = (n + chunk - 1) / chunk;
  const dim3 grid(n_chunks, (rows + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * (kRows * d + kTile * (d + 1));
  if (quantized) {
    score_chunks_kernel<true><<<grid, kThreads, smem, stream>>>(
        u, items, scale, mask, ex_ptr, ex_ids, rows, n, d, k, chunk, n_chunks,
        part_v, part_i);
  } else {
    score_chunks_kernel<false><<<grid, kThreads, smem, stream>>>(
        u, items, scale, mask, ex_ptr, ex_ids, rows, n, d, k, chunk, n_chunks,
        part_v, part_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_chunks_kernel<<<(rows + kRows - 1) / kRows, kThreads, 0, stream>>>(
      part_v, part_i, rows, n_chunks * k, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
