// Row gathers of the sum kernels (embedding_bag.cu, codebook_lookup.cu):
// each lane of a warp loads V consecutive elements of a gathered row, and
// every output column is one __fadd_rn fold from +0.0f in the caller's
// order, so a result is bitwise the plain version's.
#pragma once

#include <stdint.h>

namespace gather {

constexpr unsigned kFull = 0xffffffffu;
// floats a lane keeps in flight per step (registers of row loads)
constexpr int kStepFloats = 32;

template <typename T>
__host__ __device__ __forceinline__ constexpr T lesser(T a, T b) {
  return a < b ? a : b;
}

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float2 vzero(float2) {
  return make_float2(0.0f, 0.0f);
}
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// copy_width: the widest vector of floats (4, 2 or 1) that divides a row
// of `dim` floats and whose alignment every pointer in `addr_bits` (the
// OR of the row pointers) has. vec_width, the floats per lane of a
// warp-wide row load: the same, narrowed until a row spreads over more
// than 16 lanes (d = 64 takes float2: one row per warp-wide load).
inline int copy_width(int dim, uintptr_t addr_bits) {
  if (dim % 4 == 0 && addr_bits % 16 == 0) return 4;
  if (dim % 2 == 0 && addr_bits % 8 == 0) return 2;
  return 1;
}

inline int vec_width(int dim, uintptr_t addr_bits) {
  if (dim % 4 == 0 && addr_bits % 16 == 0 && dim > 64) return 4;
  if (dim % 2 == 0 && addr_bits % 8 == 0 && dim > 32) return 2;
  return 1;
}

// 16-bit rows (bf16, f16): V elements loaded as one V x 2-byte word.
template <int V> struct Bits16;
template <> struct Bits16<1> { using T = unsigned short; };
template <> struct Bits16<2> { using T = unsigned int; };
template <> struct Bits16<4> { using T = uint2; };
template <> struct Bits16<8> { using T = uint4; };

// copy_width16 / vec_width16: copy_width and vec_width for a row of `dim`
// 16-bit elements (8, 4, 2 or 1 a vector: 16, 8, 4 or 2 bytes).
inline int copy_width16(int dim, uintptr_t addr_bits) {
  if (dim % 8 == 0 && addr_bits % 16 == 0) return 8;
  if (dim % 4 == 0 && addr_bits % 8 == 0) return 4;
  if (dim % 2 == 0 && addr_bits % 4 == 0) return 2;
  return 1;
}

inline int vec_width16(int dim, uintptr_t addr_bits) {
  if (dim % 8 == 0 && addr_bits % 16 == 0 && dim > 128) return 8;
  if (dim % 4 == 0 && addr_bits % 8 == 0 && dim > 64) return 4;
  if (dim % 2 == 0 && addr_bits % 4 == 0 && dim > 32) return 2;
  return 1;
}

}  // namespace gather
