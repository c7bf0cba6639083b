// DLRM dot interaction for Hopper (sm_90a): per example, the strictly-lower
// triangle of X X^T, compacted.
//
//   x [B, F, d] (f32, bf16 or f16)  ->  out [B, F(F-1)/2] in x's dtype,
//   out[b, i(i-1)/2 + j] = sum_k x[b, i, k] * x[b, j, k]   for 0 <= j < i < F,
//
// the order of np.tril_indices(F, -1). Products and sums in f32, each output
// one fmaf chain over k = 0 .. d-1 in order, one rounding at the store.
//
// Replaces the TPU kernel src/repro/kernels/dot_interaction.py::
// dot_interaction_pallas (pl.pallas_call at :45), which runs the [F, d] x
// [d, F] product on the MXU and gathers the triangle in VMEM, so the
// [B, F, F] interaction tensor never reaches HBM.
//
// What bounds it on the H100: bytes. At the dlrm-mlperf shape (B = 65,536,
// F = 27, d = 128, f32) it reads 906 MB of features and writes 92 MB of
// interactions, ~0.30 ms at 3.35 TB/s, against 5.9 GFLOP of triangle
// (0.088 ms at the f32 rate); in bf16 the bytes halve (~0.15 ms).
//
// What bounded the first design (one thread per (example, pair), a
// d-long fmaf chain over two staged rows): shared-memory issue. Two loads
// per FMA are 11 warps x 128 k x 2 = 2,816 wavefronts per example at F 27,
// ~1.4 M cycles per SM over 65,536 examples (~0.8 ms of its 1.03 ms), and
// its scalar staging alternated with the compute behind block barriers.
//
// This design:
//   * One warp per example, a 4 x 4 register tile per lane. F is padded to
//     4G rows (G = ceil(F/4)) and row group g holds rows g, g + G, g + 2G,
//     g + 3G. Lane l owns the group pair (ti, tj), ti >= tj, of the lower
//     triangle of G x G groups (T = G(G+1)/2 tiles: 28 at F 27; lanes loop
//     when T > 32). Every unordered pair of rows lies in exactly one tile;
//     fmaf is symmetric in its factors, so the tile's (row of ti, row of tj)
//     product is the output of (max, min). Per 4 k a lane issues 8 16-byte
//     loads and 64 fmaf: 256 wavefronts per example at F 27. Rows past F
//     read row F-1 and are dropped, as are a diagonal tile's i <= j.
//   * Rows are staged as f32 with a stride of d rounded up to 4, plus 4
//     floats (132 at d 128): the chunk k/4 of row r lies in 16-byte bank
//     group (r + k/4) mod 8, and a tile's rows are consecutive across the
//     working lanes (g + aG for g = 0 .. G-1), so the G <= 8 distinct rows
//     that one 16-byte load reads across the warp lie in distinct bank
//     groups: one wavefront per load on the H100.
//   * Staging: each warp stages its own example into its own slot (16-byte
//     cp.async for f32; 16-byte loads widened to f32 in registers, exactly,
//     for bf16 and f16, so the inner loop is the same for every dtype), then
//     computes it. Warps never wait on each other: while one waits on its
//     copies, the SM's other 15 warps compute. A pointer or a d that does
//     not allow 16-byte units takes 4-byte cp.async or a load per value.
//     A second slot per warp (the next example's copies in flight during
//     the compute) halves the warps an SM holds (16 -> 8) and measured
//     slower, as did block-wide double buffering behind barriers.
//   * Stores: each warp writes its F(F-1)/2 results into a strip over its
//     own staged rows, then stores the strip with consecutive lanes on
//     consecutive outputs. Where lanes loop over tiles (F > 28) a lane
//     stores its results directly.
// The plan (warps per block, row stride) is made by plan() below from the
// shared memory a block may use: 4 warps of one 14,256-byte slot at
// dlrm-mlperf (57 KB, four blocks and 16 warps per SM), else fewer, down to
// one warp at the first design's stride d + 1. dot_interaction_smem_bytes
// reports it; a shape that no plan fits is refused by the wrapper.
//
// C interface (loaded with ctypes): the launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_convert.cuh"

namespace {

constexpr int kMaxSmem = 232448;        // the shared memory a block may use
constexpr int kWarps = 4;               // warps per block, one example each

// how an example reaches shared memory: 16-byte cp.async (f32), 4-byte
// cp.async (f32), 16-byte loads widened in registers (16-bit), or loads of
// one value widened in registers (16-bit)
enum Load { kCopy16 = 0, kCopy4 = 1, kWiden16 = 2, kWiden2 = 3 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Shape {
  int64_t batch;
  int nf, dim, stride;   // rows, width, staged row stride (floats)
  int ex_floats;         // one example's f32 slot (its rows, or the strip)
  int groups_g;          // G = ceil(F / 4)
  int tiles;             // G (G + 1) / 2
  int pairs;             // F (F - 1) / 2
};

// One warp stages example x_ex [F, d] into its slot as f32 rows of
// s.stride floats: lane l takes the units l, l + 32, ... of F rows x `per`
// units (16-byte chunks or single values), walked without a division.
// The widening loads go out kBatch at a time before their stores.
template <typename T, int kLoad>
__device__ __forceinline__ void stage(const T* __restrict__ x_ex,
                                      const Shape& s, float* rows, int lane) {
  constexpr int kVals = kLoad == kCopy16 ? 4 : (kLoad == kWiden16 ? 8 : 1);
  constexpr int kBatch = kLoad == kWiden16 ? 8 : 1;
  using Unit = typename std::conditional<kLoad == kWiden16, uint4, T>::type;
  const int per = s.dim / kVals;
  const int total = s.nf * per;
  const int dr = 32 / per, dc = 32 - dr * per;
  int r = lane / per, c = lane - r * per;
  for (int u = lane; u < total; u += 32 * kBatch) {
    int off[kBatch];
    Unit v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      off[q] = u + 32 * q < total ? r * s.stride + c * kVals : -1;
      const T* src = x_ex + r * s.dim + c * kVals;
      if constexpr (kLoad == kCopy16) {
        if (off[q] >= 0) cp_async16(rows + off[q], src);
      } else if constexpr (kLoad == kCopy4) {
        if (off[q] >= 0) cp_async4(rows + off[q], src);
      } else {
        if (off[q] >= 0) v[q] = *reinterpret_cast<const Unit*>(src);
      }
      r += dr;
      c += dc;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
    if constexpr (kLoad == kWiden16 || kLoad == kWiden2) {
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (off[q] < 0) continue;
        if constexpr (kLoad == kWiden16) {
          const T* h = reinterpret_cast<const T*>(&v[q]);
          float4* dst = reinterpret_cast<float4*>(rows + off[q]);
          dst[0] = make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]),
                               to_f32(h[3]));
          dst[1] = make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]),
                               to_f32(h[7]));
        } else {
          rows[off[q]] = to_f32(v[q]);
        }
      }
    }
  }
  if constexpr (kLoad == kCopy16 || kLoad == kCopy4) cp_async_commit();
}

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kVec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The 4 x 4 products of row groups ti and tj of one staged example, each
// an fmaf chain over k in order. With kVec the loads of k + 4 are issued
// before the products of k: the last step reads the 4 floats past d4,
// which lie inside the row's stride.
template <bool kVec>
__device__ __forceinline__ void tile_products(const float* ex, const Shape& s,
                                              int ti, int tj,
                                              float acc[4][4]) {
  const float* pi[4];
  const float* pj[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    pi[a] = ex + min(ti + s.groups_g * a, s.nf - 1) * s.stride;
    pj[a] = ex + min(tj + s.groups_g * a, s.nf - 1) * s.stride;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
  const int d4 = s.dim & ~3;
  float4 xi[4], xj[4];
  if (kVec || d4 > 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      xi[a] = load4<kVec>(pi[a]);
      xj[a] = load4<kVec>(pj[a]);
    }
  }
#pragma unroll 2
  for (int k = 0; k < d4; k += 4) {
    const int next = kVec || k + 4 < d4 ? k + 4 : k;
    float4 ni[4], nj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ni[a] = load4<kVec>(pi[a] + next);
      nj[a] = load4<kVec>(pj[a] + next);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(comp(xi[a], kk), comp(xj[b], kk), acc[a][b]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      xi[a] = ni[a];
      xj[a] = nj[a];
    }
  }
  for (int k = d4; k < s.dim; ++k) {
    float vi[4], vj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      vi[a] = pi[a][k];
      vj[a] = pj[a][k];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[a][b] = fmaf(vi[a], vj[b], acc[a][b]);
  }
}

// Visit the outputs of tile (ti, tj): fn(compacted index, value).
template <typename Fn>
__device__ __forceinline__ void tile_outputs(const Shape& s, int ti, int tj,
                                             const float acc[4][4], Fn fn) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = ti + s.groups_g * a;
      const int j = tj + s.groups_g * b;
      if (i < s.nf && j < s.nf && (ti != tj || a > b)) {
        const int hi = max(i, j), lo = min(i, j);
        fn(hi * (hi - 1) / 2 + lo, acc[a][b]);
      }
    }
}

// Advance the tile walk (ti, tj) by `step` tiles in row-major order of the
// lower triangle (diagonal included).
__device__ __forceinline__ void walk(int& ti, int& tj, int step) {
  tj += step;
  while (tj > ti) {
    tj -= ti + 1;
    ++ti;
  }
}

// One warp's staged example: its triangle, stored to dst [pairs]. With one
// tile per lane the results go through a strip over the example's rows and
// leave with consecutive lanes on consecutive outputs.
template <typename T, bool kVec>
__device__ __forceinline__ void warp_example(float* ex, const Shape& s,
                                             T* __restrict__ dst, int lane) {
  int ti = 0, tj = 0;
  walk(ti, tj, lane);
  float acc[4][4];
  if (s.tiles <= 32) {
    if (lane < s.tiles) tile_products<kVec>(ex, s, ti, tj, acc);
    __syncwarp();                        // every lane is done with the rows
    if (lane < s.tiles)
      tile_outputs(s, ti, tj, acc, [&](int p, float v) { ex[p] = v; });
    __syncwarp();
    for (int p = lane; p < s.pairs; p += 32) dst[p] = from_f32<T>(ex[p]);
  } else {
    for (int t = lane; t < s.tiles; t += 32, walk(ti, tj, 32)) {
      tile_products<kVec>(ex, s, ti, tj, acc);
      tile_outputs(s, ti, tj, acc,
                   [&](int p, float v) { dst[p] = from_f32<T>(v); });
    }
  }
  __syncwarp();                          // the slot may be staged again
}

// Every warp walks its own examples (warp w of block b: b * W + w, then a
// stride of all the grid's warps) through one f32 slot of its own: it
// stages an example, waits for it, computes it. No block-wide barrier:
// while one warp waits on its copies, the SM's other warps compute.
template <typename T, int kLoad, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out,
                           Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ex_in = static_cast<int64_t>(s.nf) * s.dim;
  const int64_t step = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  float* rows = smem + warp * s.ex_floats;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                   warp;
       e < s.batch; e += step) {
    stage<T, kLoad>(x + e * ex_in, s, rows, lane);
    if constexpr (kLoad == kCopy16 || kLoad == kCopy4) cp_async_wait_all();
    __syncwarp();                        // every lane's values have landed
    warp_example<T, kVec>(rows, s, out + e * s.pairs, lane);
  }
}

struct Plan {
  int load;
  bool vec;
  int warps, stride, ex_floats;
  int64_t smem;
};

int64_t round4(int64_t v) { return (v + 3) & ~int64_t{3}; }

// The launch for (F, d, element size) with a 16-byte aligned x or not:
// kWarps warps at the padded stride, or the most warps (down to one) that
// fit the shared memory a block may use, then one warp at stride d + 1.
// smem > kMaxSmem: no plan fits (it is then the least any plan needs).
Plan plan(int nf, int dim, int elem, bool aligned16) {
  const int64_t pairs = static_cast<int64_t>(nf) * (nf - 1) / 2;
  const int64_t g = (nf + 3) / 4;
  const bool strip = g * (g + 1) / 2 <= 32;   // outputs go through the strip
  const bool fast = aligned16 && dim % (16 / elem) == 0;
  auto make = [&](int warps, int64_t stride) {
    int64_t ex = static_cast<int64_t>(nf) * stride;
    if (strip && pairs > ex) ex = pairs;
    if (warps > 1) ex = round4(ex);             // 16-byte aligned slots
    const bool wide = fast && stride % 4 == 0;
    const int load = elem == 4 ? (wide ? kCopy16 : kCopy4)
                               : (wide ? kWiden16 : kWiden2);
    return Plan{load, stride % 4 == 0, warps, static_cast<int>(stride),
                static_cast<int>(ex), int64_t{warps} * ex * 4};
  };
  for (int warps = kWarps; warps >= 1; --warps) {
    const Plan p = make(warps, round4(dim) + 4);
    if (p.smem <= kMaxSmem) return p;
  }
  return make(1, dim + 1);
}

template <typename T, int kLoad, bool kVec>
int run(const Plan& p, const T* x, T* out, const Shape& s,
        cudaStream_t stream) {
  auto kernel = dot_interaction_kernel<T, kLoad, kVec>;
  const int smem = static_cast<int>(p.smem);
  // the blocks the card holds at once, asked again only when the device
  // or the shared memory changes
  static int cached_dev = -1, cached_smem = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    // the largest shared-memory carveout, so that the occupancy the
    // runtime reports is the one the card gives
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, p.warps * 32, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = sms * per_sm;
  }
  const int64_t want = (s.batch + p.warps - 1) / p.warps;
  const int64_t blocks = want < cached_blocks ? want : cached_blocks;
  kernel<<<static_cast<unsigned>(blocks), p.warps * 32, smem, stream>>>(
      x, out, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, void* outv, int64_t batch, int nf, int dim,
           cudaStream_t stream) {
  if (batch <= 0 || nf < 2) return static_cast<int>(cudaGetLastError());
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const Plan p = plan(nf, dim, sizeof(T),
                      reinterpret_cast<uintptr_t>(xv) % 16 == 0);
  if (p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int g = (nf + 3) / 4;
  const Shape s{batch, nf, dim, p.stride, p.ex_floats, g, g * (g + 1) / 2,
                nf * (nf - 1) / 2};
  if constexpr (sizeof(T) == 4) {
    if (p.load == kCopy16) return run<T, kCopy16, true>(p, x, out, s, stream);
    return p.vec ? run<T, kCopy4, true>(p, x, out, s, stream)
                 : run<T, kCopy4, false>(p, x, out, s, stream);
  } else {
    if (p.load == kWiden16)
      return run<T, kWiden16, true>(p, x, out, s, stream);
    return p.vec ? run<T, kWiden2, true>(p, x, out, s, stream)
                 : run<T, kWiden2, false>(p, x, out, s, stream);
  }
}

int elem_size(int dtype) {
  return dtype == 0 ? 4 : (dtype == 1 || dtype == 2 ? 2 : 0);
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

// The shared memory (bytes) of the launch at (F, d, dtype) for a 16-byte
// aligned x; above dot_interaction_max_smem() when no plan fits (the least
// any plan needs, whatever the alignment). -1 for an unknown dtype.
extern "C" int64_t dot_interaction_smem_bytes(int nf, int dim, int dtype) {
  const int elem = elem_size(dtype);
  if (elem == 0 || nf < 1 || dim < 1) return -1;
  return plan(nf, dim, elem, true).smem;
}

extern "C" int dot_interaction_max_smem() { return kMaxSmem; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
