// Split-three TF32 tiles for the fp32 flash-attention kernels (the forward
// in flash_fwd.cu, dq and dk/dv in flash_bwd.cu): tiles of 64 fp32 rows
// staged by 16-byte cp.async, and the fragments of the two products every
// kernel runs on them with mma.sync m16n8k8 (the split and the product are
// in sm90.cuh).
//
// Four warps a block, 16 rows each (warp w owns tile rows 16w .. 16w + 15;
// a thread rows r = 16w + lane / 4 and r + 8). A first product (S = Q K^T,
// dP = dO V^T and their transposes) reduces over D along the rows of both
// tiles; its accumulator is the A operand of a second product (O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q) as it stands, so P and dS stay
// in registers. A second product reduces down its B tile.

#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace tf32x3 {

constexpr int BR = 64;  // rows of a tile

constexpr int TC_THREADS = 128;  // four warps of 16 rows each
constexpr int TC_STAGES = 2;     // streamed tiles in flight

// A tile of 64 rows of D floats in shared memory, each row padded by 8
// floats: at a row stride of 8 banks (mod 32) the first products' 64-bit
// fragment loads (8 rows x 4 column pairs a half-warp) meet every bank once.
template <int D>
struct F32Tile {
  static constexpr int STRIDE = D + 8;
  static constexpr int FLOATS = BR * STRIDE;
};

// Rows r0 .. r0 + 63 of one (batch, head), D floats each at row stride `sl`
// (elements), into a padded tile with 16-byte cp.async; rows past `limit`
// land as zeros. The caller commits the group.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t sl, int r0, int limit) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BR * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool in = row < limit;
    sm90::cp_async_16(dst + r * F32Tile<D>::STRIDE + 4 * c,
                      in ? src + row * sl + 4 * c : src, in);
  }
}

// First products (S = Q K^T, dP = dO V^T and their transposes) reduce over
// D, which runs along the tile rows of both operands. Within a depth step
// kk of 8 the depth order is permuted, A column t and B row t taking depth
// 2t and column / row t + 4 depth 2t + 1, so each thread's pair of values
// is one 64-bit load. A: rows r and r + 8 of `tile`.
template <int D>
__device__ __forceinline__ sm90::FragA first_a(const float* tile, int r,
                                               int kk, int t) {
  constexpr int S = F32Tile<D>::STRIDE;
  const float2 x =
      *reinterpret_cast<const float2*>(tile + r * S + 8 * kk + 2 * t);
  const float2 y =
      *reinterpret_cast<const float2*>(tile + (r + 8) * S + 8 * kk + 2 * t);
  return sm90::split_a(x.x, y.x, x.y, y.y);
}

// B of a first product: its column g is row n of `tile`.
template <int D>
__device__ __forceinline__ void first_b(const float* tile, int n, int kk,
                                        int t, sm90::Tf32x2& b0,
                                        sm90::Tf32x2& b1) {
  const float2 x = *reinterpret_cast<const float2*>(
      tile + n * F32Tile<D>::STRIDE + 8 * kk + 2 * t);
  b0 = sm90::split_tf32(x.x);
  b1 = sm90::split_tf32(x.y);
}

// The A operand of a second product from the accumulator of a first: its
// columns 8j .. 8j + 7 (keys or queries) are depth step j, thread t holding
// columns 2t and 2t + 1, which become A columns t and t + 4. The B rows are
// read in that same order, so P and dS never leave the registers.
__device__ __forceinline__ sm90::FragA second_a(const float (&c)[4]) {
  return sm90::split_a(c[0], c[2], c[1], c[3]);
}

// part += a x (tile rows 8j .. 8j + 7, columns c0 .. c0 + NC - 1): the
// second products (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q)
// reduce down the tile. B rows t and t + 4 are tile rows 8j + 2t and 8j + 2t + 1; n-tiles
// 2c and 2c + 1 take columns c0 + 16c + 2g and c0 + 16c + 2g + 1, one
// 64-bit load for both, so a thread's columns are c0 + 16c + 4t ..
// c0 + 16c + 4t + 3 (store_row).
template <int D, int NC>
__device__ __forceinline__ void second_mma(float (&part)[NC / 8][4],
                                           const sm90::FragA& a,
                                           const float* tile, int j, int c0,
                                           int g, int t) {
  constexpr int S = F32Tile<D>::STRIDE;
  const float* r0 = tile + (8 * j + 2 * t) * S + c0 + 2 * g;
#pragma unroll
  for (int c = 0; c < NC / 16; ++c) {
    const float2 x = *reinterpret_cast<const float2*>(r0 + 16 * c);
    const float2 y = *reinterpret_cast<const float2*>(r0 + S + 16 * c);
    sm90::mma_3xtf32(part[2 * c], a, sm90::split_tf32(x.x),
                     sm90::split_tf32(y.x));
    sm90::mma_3xtf32(part[2 * c + 1], a, sm90::split_tf32(x.y),
                     sm90::split_tf32(y.y));
  }
}

// Columns of a second product summed from zero at once beside a D-wide
// running sum and a 64-wide score tile: every column at D <= 64, half of
// them at D = 128, so that the tile's partial sums fit the registers.
template <int D>
constexpr int PART_NC = D <= 64 ? D : D / 2;

// acc += (ac's J depth steps) x (tile rows 0 .. 8J - 1): one tile's second
// product. The tensor cores' fp32 accumulator drops low bits as it adds, so
// a sum run in it across every tile drifts from fp32's as the tiles pile
// up. Each tile's product is therefore summed from zero, NC columns at a
// time (NC < D where the registers hold no third D-wide accumulator), and
// added to the running sum in fp32.
template <int D, int NC, int J>
__device__ __forceinline__ void second_sum(float (&acc)[D / 8][4],
                                           const float (&ac)[J][4],
                                           const float* tile, int g, int t) {
  static_assert(D % NC == 0 && NC % 16 == 0, "whole 16-column groups");
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += NC) {
    float part[NC / 8][4] = {};
#pragma unroll
    for (int j = 0; j < J; ++j)
      second_mma<D, NC>(part, second_a(ac[j]), tile, j, c0, g, t);
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + n][e] += part[n][e];
  }
}

// Row g (hr = 0) or g + 8 (hr = 1) of a second product's accumulator,
// times `scale`, into `out` (D contiguous floats): 16 bytes a column group.
template <int D>
__device__ __forceinline__ void store_row(float* out,
                                          const float (&acc)[D / 8][4],
                                          int hr, int t, float scale) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    *reinterpret_cast<float4*>(out + 16 * c + 4 * t) = make_float4(
        acc[2 * c][2 * hr] * scale, acc[2 * c + 1][2 * hr] * scale,
        acc[2 * c][2 * hr + 1] * scale, acc[2 * c + 1][2 * hr + 1] * scale);
}

}  // namespace tf32x3
