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
//   bf16/f16 inputs with 128 < d <= 256, all math in f32. One block of NW
//   warps per (b*h, query tile), the tiles aligned to the last row (the
//   first may start before row 0: under the causal mask the short tile is
//   the cheap one) and dealt heaviest first. The tile's rows are slabs of
//   4 TM rows; a warp owns one slab, or two (SL 2: slabs w and 2 NW - 1 -
//   w, so every warp does about the same causal work). Lane (rg, x) =
//   (lane / 8, lane % 8) owns rows rg + 4 i of its slab, keys x + 8 c of a
//   tile and output columns 4 x + 32 t .. + 3. Q, K and V are staged in
//   f32 shared memory by cp.async (16, 8 or 4 bytes as d and the pointers
//   allow; 16-bit inputs widened in registers), Q and K rows an odd
//   number of 16-byte words apart so a warp's float4 loads along d hit 8
//   different bank groups; with more than one key tile the next tile's K
//   and V are copied while the block computes the current one (one wait
//   and one barrier a tile), with one (a short sequence) a single K and V
//   buffer keeps a block at 47 KB, four to an SM (blocks that walked
//   several sequences, prefetching the next, held two buffers each, ran
//   two to an SM and measured slower). q k^T: TM + 4 float4 loads for
//   16 TM FMAs, over the keys the slab's rows can see, in steps of 16
//   (qk_chunk); the
//   online softmax on the lanes' registers (expf, row max and sum over the
//   8 lanes of a row, l kept a lane's share until the store); P through
//   the warp's 32-key slice of shared memory (one TM-float word a key)
//   into P V, 1 + DP / 32 loads for 4 TM DP / 32 FMAs a key; the store
//   writes 16-, 8- or 4-byte words. Instances (D; TM, NW, keys a tile,
//   SL, blocks an SM asked of the register allocator): 32 (4, 4, 64, 1,
//   4), 52 for SASRec's 50 (2, 4, 64, 2, 4), 64 (2, 4, 64, 2, 4), 128 (4,
//   4, 32, 1, -), 256 (2, 8, 32, 1, -), chosen by timing on an H100 80GB
//   HBM3 at 700 W (PERF.md). Bound: the paths' short sequences
//   are bytes (SASRec train, B 65,536 x S 49 x d 50: 2.57 GB of q, k, v
//   and out, 0.767 ms at 3.35 TB/s), the longer ones operations at the 67
//   TFLOP/s f32 rate (BERT4Rec serve, B 512 x H 2 x S 200 x d 32, full:
//   5.24 GFLOP, 0.078 ms; the bench's B 2 x H 8 x S 2,048 x d 128,
//   causal: 17.2 GFLOP, 0.257 ms). What holds it back now: instructions
//   around the multiply-adds (masking, softmax, staging, the store) and
//   the padding of a short causal tile (49 rows in 64, d 50 in 52 and 64
//   columns), at most 16 warps an SM.
//
// C interface (loaded with ctypes): each launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <tuple>

#include "f32_convert.cuh"

namespace {

constexpr int kBK = 64;                  // keys per tile (tensor-core route)
constexpr float kNegFill = -1e30f;       // the causal fill and the initial max

// ---------------------------------------------------------------------------
// CUDA-core route: f32, and bf16/f16 with 128 < d <= 256
// ---------------------------------------------------------------------------
namespace cc {


// One instance: head width D (d <= D, D % 4 == 0), TM query rows a lane,
// NW warps a block, BK keys a tile (a multiple of 32). Lane (rg, x) =
// (lane / 8, lane % 8) of warp w owns the query rows w * 4 TM + rg + 4 i
// (i < TM), the keys x + 8 c of a tile (c < BK / 8) and the output
// columns 4 x + 32 t .. + 3 (t < DP / 32).
template <int D, int TM, int NW, int BK, int SL>
struct Plan {
  static_assert(D % 4 == 0 && BK % 32 == 0 && (TM == 2 || TM == 4) &&
                    (SL == 1 || SL == 2),
                "plan");
  static_assert(D <= 32 * NW, "a row's copies fit one pass of the threads");
  // Q and K rows: an odd number of 16-byte words, so the 8 consecutive
  // rows of one float4 load fall in 8 different bank groups
  static constexpr int kS = (D / 4) % 2 ? D : D + 4;
  static constexpr int kDP = (D + 31) / 32 * 32;   // P V's columns
  static constexpr int kRows = 4 * TM;             // a slab's query rows
  static constexpr int kBQ = kRows * NW * SL;
  static constexpr int kThreads = 32 * NW;
  static constexpr int kQ = kBQ * kS;              // floats of a Q buffer
  static constexpr int kK = BK * kS;
  static constexpr int kV = BK * kDP;
  static constexpr int kP = 32 * kRows;            // a warp's P, 32 keys
  static constexpr size_t bytes(int kv_bufs) {
    return (static_cast<size_t>(kQ) + kv_bufs * (kK + kV) + NW * kP) * 4;
  }
};

template <int TM> struct RowVec;                 // TM floats, one word
template <> struct RowVec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float4 make(const float (&a)[4]) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <> struct RowVec<2> {
  using T = float2;
  static __device__ __forceinline__ float get(const float2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ float2 make(const float (&a)[2]) {
    return make_float2(a[0], a[1]);
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's share of staging a tile: row `row` of every pass of `rpp`
// rows, elements [col, col + vec) of it (idle where row >= rpp).
struct Copier {
  int row, col, rpp, vec;
  __device__ Copier(int tid, int threads, int dim, int vec_) : vec(vec_) {
    const int chunks = dim / vec;          // <= threads (D <= threads)
    rpp = threads / chunks;
    row = tid / chunks;
    col = tid % chunks * vec;
  }
};

// Rows [r0, r1) of the [*, dim] matrix g into shared rows r - base of
// stride ss: cp.async of vec floats (f32), or loads widened in registers
// (16-bit). Columns past dim are never written.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ss,
                                           const T* __restrict__ g, int dim,
                                           int r0, int r1, int base,
                                           const Copier& cp) {
  if (cp.row >= cp.rpp) return;
  if constexpr (sizeof(T) == 4) {
    const float* gf = reinterpret_cast<const float*>(g);
    if (cp.vec == 4) {
      for (int r = r0 + cp.row; r < r1; r += cp.rpp)
        cp_async<16>(dst + (r - base) * ss + cp.col,
                     gf + static_cast<int64_t>(r) * dim + cp.col);
    } else if (cp.vec == 2) {
      for (int r = r0 + cp.row; r < r1; r += cp.rpp)
        cp_async<8>(dst + (r - base) * ss + cp.col,
                    gf + static_cast<int64_t>(r) * dim + cp.col);
    } else {
      for (int r = r0 + cp.row; r < r1; r += cp.rpp)
        cp_async<4>(dst + (r - base) * ss + cp.col,
                    gf + static_cast<int64_t>(r) * dim + cp.col);
    }
  } else {
#pragma unroll 8
    for (int r = r0 + cp.row; r < r1; r += cp.rpp)
      dst[(r - base) * ss + cp.col] =
          to_f32(g[static_cast<int64_t>(r) * dim + cp.col]);
  }
}

// out[col, col + 4) of one row (columns past dim not written), as one
// 4-element word, two 2-element words or single elements (vec 4, 2, 1).
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ o, int col,
                                       const float (&a)[4], int dim,
                                       int vec) {
  if (vec == 4 && col + 4 <= dim) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(o + col) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      T h[4] = {from_f32<T>(a[0]), from_f32<T>(a[1]), from_f32<T>(a[2]),
                from_f32<T>(a[3])};
      *reinterpret_cast<uint2*>(o + col) = *reinterpret_cast<const uint2*>(h);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    if (vec >= 2 && col + e + 2 <= dim) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(o + col + e) = make_float2(a[e], a[e + 1]);
      } else {
        T h[2] = {from_f32<T>(a[e]), from_f32<T>(a[e + 1])};
        *reinterpret_cast<uint32_t*>(o + col + e) =
            *reinterpret_cast<const uint32_t*>(h);
      }
    } else {
      if (col + e < dim) o[col + e] = from_f32<T>(a[e]);
      if (col + e + 1 < dim) o[col + e + 1] = from_f32<T>(a[e + 1]);
    }
  }
}

// A unit of work: the query tile of one (b, h). Tiles are aligned to the
// last row (the first may start before row 0), so under the causal mask
// the short tile is the cheap one, and units are dealt heaviest first.
struct Unit {
  int64_t bh;
  int q0;          // absolute row of the tile's first row (may be < 0)
  int n_tiles;     // key tiles it reads
};

template <int BQ, int BK>
__device__ __forceinline__ Unit unit_of(int64_t u, int64_t bh_count, int sq,
                                        int skv, int causal) {
  Unit w;
  w.bh = u % bh_count;
  const int rank = static_cast<int>(u / bh_count);   // 0: the last tile
  w.q0 = sq - (rank + 1) * BQ;
  const int kv_end = causal ? min(skv, w.q0 + BQ) : skv;
  w.n_tiles = max(1, (kv_end + BK - 1) / BK);
  return w;
}

// s[i][c0 + c] += q_i . k_(x + 8 c) of a slab's rows, for the keys x + 8 c
// (c < NC) of the chunk at Kt: float4 loads along d, 4 NC TM multiply-adds
// for every TM + NC loads.
template <int D, int TM, int NC, int kS, int kC>
__device__ __forceinline__ void qk_chunk(const float* __restrict__ Qs,
                                         const float* __restrict__ Kt,
                                         float (&s)[TM][kC], int c0) {
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[TM], b[NC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + 4 * i * kS + kk);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      b[c] = *reinterpret_cast<const float4*>(Kt + 8 * c * kS + kk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float& t = s[i][c0 + c];
        t = fmaf(a[i].x, b[c].x, t);
        t = fmaf(a[i].y, b[c].y, t);
        t = fmaf(a[i].z, b[c].z, t);
        t = fmaf(a[i].w, b[c].w, t);
      }
  }
}

// One slab (4 TM query rows of one warp) against key tile k0: q k^T on
// the keys its rows can see (the causal bound, in steps of 16), the online
// softmax on the lanes' registers (l keeps each lane's share of the sum),
// P through the warp's 32-key slice of shared memory, P V into acc.
template <int D, int TM, int BK, int kS, int kDP>
__device__ __forceinline__ void slab_tile(
    const float* __restrict__ Qs, const float* __restrict__ Kt,
    const float* __restrict__ Vt, float* __restrict__ Pw, int row0, int k0,
    int skv, int causal, float scale, float (&m)[TM], float (&l)[TM],
    float (&acc)[TM][(kDP / 32) * 4], int rg, int x) {
  using RV = RowVec<TM>;
  constexpr int kC = BK / 8;             // keys a lane a tile
  constexpr int kNT = kDP / 32;          // float4 columns a lane
  constexpr int kRows = 4 * TM;
  const int row1 = row0 + kRows - 1;
  const int kmax = row1 < 0 ? -1 : causal ? min(skv - 1, row1) : skv - 1;
  if (kmax < k0) return;                 // no key of the tile is seen
  float s[TM][kC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) s[i][c] = 0.0f;
#pragma unroll
  for (int cc = 0; cc < BK / 32; ++cc) {
    if (k0 + 32 * cc + 16 <= kmax) {
      qk_chunk<D, TM, 4, kS>(Qs, Kt + 32 * cc * kS, s, 4 * cc);
    } else if (k0 + 32 * cc <= kmax) {   // the chunk's first 16 keys
      qk_chunk<D, TM, 2, kS>(Qs, Kt + 32 * cc * kS, s, 4 * cc);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg + 4 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (k0 + 16 * (c / 2) > kmax) break;   // keys q k^T left out
      const int key = k0 + x + 8 * c;
      float val = s[i][c] * scale;
      if (key >= skv) val = -INFINITY;
      else if (causal && key > row) val = kNegFill;
      s[i][c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_cur = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_cur);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (k0 + 16 * (c / 2) > kmax) break;
      s[i][c] = expf(s[i][c] - m_cur);
      sum += s[i][c];
    }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int c = 0; c < 4 * kNT; ++c) acc[i][c] *= alpha;
    m[i] = m_cur;
  }
  const int kend = kmax + 1 - k0;        // keys to add
#pragma unroll
  for (int h = 0; h < BK / 32; ++h) {
    if (32 * h < kend) {
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float col[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) col[i] = s[i][4 * h + c];
        *reinterpret_cast<typename RV::T*>(Pw + (x + 8 * c) * kRows +
                                           rg * TM) = RV::make(col);
      }
      __syncwarp();
      const int jn = min(32, kend - 32 * h);
      const float* Vh = Vt + 32 * h * kDP;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const typename RV::T p =
            *reinterpret_cast<const typename RV::T*>(Pw + j * kRows + rg * TM);
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vh + j * kDP + 32 * t);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float pi = RV::get(p, i);
            acc[i][4 * t + 0] = fmaf(pi, vv.x, acc[i][4 * t + 0]);
            acc[i][4 * t + 1] = fmaf(pi, vv.y, acc[i][4 * t + 1]);
            acc[i][4 * t + 2] = fmaf(pi, vv.z, acc[i][4 * t + 2]);
            acc[i][4 * t + 3] = fmaf(pi, vv.w, acc[i][4 * t + 3]);
          }
        }
      }
    }
  }
}

// The CUDA-core kernel: one block a unit. It walks the unit's key tiles;
// with more than one (kv_bufs 2) the next tile's K and V are copied into
// the other buffer while the block computes the current one: one wait and
// one barrier a tile. Within a tile each warp works alone on its slabs
// (slab_tile). With two slabs a warp (SL 2), warp w takes slabs w and
// 2 NW - 1 - w, so under the causal mask every warp has about the same
// work.
template <typename T, int D, int TM, int NW, int BK, int SL, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
    cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              int64_t bh_count, int sq, int skv, int dim, int causal,
              float scale, int kv_bufs, int in_vec, int out_vec) {
  using P = Plan<D, TM, NW, BK, SL>;
  constexpr int kNT = P::kDP / 32;       // float4 columns a lane
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                      // [kv_bufs][BK][kS]
  float* sV = sK + kv_bufs * P::kK;      // [kv_bufs][BK][kDP]
  float* sP = sV + kv_bufs * P::kV;      // [NW][32][kRows]
  float* sQ = sP + NW * P::kP;           // [kBQ][kS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, x = lane % 8;
  const Copier cp(tid, P::kThreads, dim, in_vec);
  int slab[SL];                          // this warp's slabs
  slab[0] = warp;
  if constexpr (SL == 2) slab[1] = 2 * NW - 1 - warp;
  const Unit w = unit_of<P::kBQ, BK>(blockIdx.x, bh_count, sq, skv, causal);
  const T* kb = k + w.bh * skv * static_cast<int64_t>(dim);
  const T* vb = v + w.bh * skv * static_cast<int64_t>(dim);

  auto issue = [&](int tile, int buf) {
    const int k0 = tile * BK;
    const int k1 = min(skv, k0 + BK);
    stage_rows<T>(sK + buf * P::kK, P::kS, kb, dim, k0, k1, k0, cp);
    stage_rows<T>(sV + buf * P::kV, P::kDP, vb, dim, k0, k1, k0, cp);
    cp_async_commit();
  };
  stage_rows<T>(sQ, P::kS, q + w.bh * sq * static_cast<int64_t>(dim), dim,
                max(w.q0, 0), w.q0 + P::kBQ, w.q0, cp);
  issue(0, 0);
  // zeros in the columns [dim, D) of every Q and K row, which q k^T reads
  // and no copy writes (other rows and columns no kept result reads); the
  // first tile's barrier orders them before any read
  for (int r = tid; r < kv_bufs * BK + P::kBQ && dim < D; r += P::kThreads) {
    float* row = r < kv_bufs * BK ? sK + r * P::kS
                                  : sQ + (r - kv_bufs * BK) * P::kS;
    for (int c = dim; c < D; ++c) row[c] = 0.0f;
  }

  float m[SL][TM], l[SL][TM], acc[SL][TM][4 * kNT];
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[sl][i] = kNegFill;
      l[sl][i] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4 * kNT; ++c) acc[sl][i][c] = 0.0f;
    }
  for (int tile = 0; tile < w.n_tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait_all();
    __syncthreads();       // this tile landed; the last tile's buffer free
    if (tile + 1 < w.n_tiles) issue(tile + 1, buf ^ 1);
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      slab_tile<D, TM, BK, P::kS, P::kDP>(
          sQ + (slab[sl] * P::kRows + rg) * P::kS,
          sK + buf * P::kK + x * P::kS, sV + buf * P::kV + 4 * x,
          sP + warp * P::kP, w.q0 + slab[sl] * P::kRows, tile * BK, skv,
          causal, scale, m[sl], l[sl], acc[sl], rg, x);
    }
  }

  T* ob = out + w.bh * sq * static_cast<int64_t>(dim);
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float den = l[sl][i];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      den += __shfl_xor_sync(0xffffffffu, den, 4);
      const float inv = 1.0f / fmaxf(den, 1e-30f);
      const int row = w.q0 + slab[sl] * P::kRows + rg + 4 * i;
      if (row < 0 || row >= sq) continue;
      T* orow = ob + static_cast<int64_t>(row) * dim;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const float a[4] = {
            acc[sl][i][4 * t] * inv, acc[sl][i][4 * t + 1] * inv,
            acc[sl][i][4 * t + 2] * inv, acc[sl][i][4 * t + 3] * inv};
        store4<T>(orow, 4 * x + 32 * t, a, dim, out_vec);
      }
    }
}

template <typename T, int D, int TM, int NW, int BK, int SL, int MINB>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int sq, int skv, int dim, int causal, float scale,
           cudaStream_t stream) {
  using P = Plan<D, TM, NW, BK, SL>;
  auto* kernel = cc_kernel<T, D, TM, NW, BK, SL, MINB>;
  const int kv_bufs = skv > BK ? 2 : 1;  // one tile: nothing to prefetch
  const size_t smem = P::bytes(kv_bufs);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t units = bh * ((sq + P::kBQ - 1) / P::kBQ);
  const uintptr_t in_bits = reinterpret_cast<uintptr_t>(q) |
                            reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v);
  const uintptr_t out_bits = reinterpret_cast<uintptr_t>(out);
  const int es = static_cast<int>(sizeof(T));
  auto width = [&](uintptr_t bits, int most) {
    for (int w = most; w > 1; w /= 2)
      if (dim % w == 0 && bits % (w * es) == 0) return w;
    return 1;
  };
  const int in_vec = es == 4 ? width(in_bits, 4) : 1;
  const int out_vec = width(out_bits, 4);
  kernel<<<static_cast<unsigned>(units), P::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, sq, skv, dim,
      causal, scale, kv_bufs, in_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

// The instance for head width dim: D 32, 52 (SASRec's d 50), 64, 128, 256.
template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out,
               int64_t bh, int sq, int skv, int dim, int causal, float scale,
               cudaStream_t stream) {
  const auto a = std::make_tuple(q, k, v, out, bh, sq, skv, dim, causal,
                                 scale, stream);
  if (dim <= 32) return std::apply(launch<T, 32, 4, 4, 64, 1, 4>, a);
  if (dim <= 52) return std::apply(launch<T, 52, 2, 4, 64, 2, 4>, a);
  if (dim <= 64) return std::apply(launch<T, 64, 2, 4, 64, 2, 4>, a);
  if (dim <= 128) return std::apply(launch<T, 128, 4, 4, 32, 1, 1>, a);
  if (dim <= 256) return std::apply(launch<T, 256, 2, 8, 32, 1, 1>, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cc

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
      return cc::launch_dim<float>(q, k, v, out, bh, sq, skv, dim, causal,
                                   scale, stream);
    case 1:
      return cc::launch_dim<__nv_bfloat16>(q, k, v, out, bh, sq, skv, dim,
                                           causal, scale, stream);
    case 2:
      return cc::launch_dim<__half>(q, k, v, out, bh, sq, skv, dim, causal,
                                    scale, stream);
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
