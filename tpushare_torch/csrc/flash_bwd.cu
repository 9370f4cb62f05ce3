// Causal flash-attention backward for Hopper (sm_90a): a dq kernel and a
// dk/dv kernel, bound to Python through plain C entries and ctypes
// (tpushare_torch/workload/flash_attention.py).
//
// Replaces: tpushare/workload/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (both launched by `_flash_bwd_call`). Same function:
// from the forward's saved (out, lse) and delta = rowsum(do * out) - dlse,
// for every (query, key) pair the causal mask keeps on GLOBAL positions
// (q_offset + i >= kv_offset + j):
//   p  = exp(min(s - lse, 30)),  s = q k^T / sqrt(D)   (0 where masked)
//   ds = p * (do v^T - delta)
//   dq = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dv = p^T do.
// The clamp at 30 keeps exp finite on rows whose lse is the NEG_INF
// sentinel (rows that see no key); such rows get p = 0 and add nothing.
//
// What bounds it on this card: dq does 6 * D operations per visible pair
// (s, dp, and ds k: three products of 2 * D), dk/dv 8 * D (s, dp, p^T do,
// ds^T q), against about 10 * D bytes per row in bf16 (q, k, v, do read,
// one gradient written). Causal attention at length L has about L / 2
// visible pairs per row, so both kernels do about L / 3 operations per
// byte or more: bound by operations from L ~ 900 in bf16 against the 989
// TFLOP/s of the tensor cores. fp32 runs every product as three TF32
// passes (below) on the tensor cores' 495 TFLOP/s, an fp32-accurate roof
// of 165 TFLOP/s, bound by operations from L ~ 300; on the SIMT units the
// same work has a roof of 67 TFLOP/s.
//
// What the design does about it (both dtypes):
//  * dq: one block per (batch * head, 64 query rows). Q and dO are loaded
//    once; lse and delta for the block's rows stay in registers. The block
//    walks 64-key tiles up to the causal diagonal (a tile starting past the
//    block's last global query position is never loaded) and keeps dq's
//    accumulator in registers for the whole walk. Blocks launch heaviest
//    first (the last queries see the most keys).
//  * dk/dv: one block per (batch * head, 64 or 128 keys). K and V are
//    loaded once; the block walks the Q tiles from the first that sees its
//    keys to the end, with the dk and dv accumulators in registers for the
//    whole walk. Blocks launch heaviest first (the first keys see every Q
//    tile).
//  * On the TPU the accumulators rode a sequential grid axis in VMEM
//    scratch; here the walk is a loop inside the block, blocks run in no
//    order and each gradient row is written once by one block. There are
//    no atomics, so the gradients are bitwise the same from run to run.
//  * q, k, v and do are read in the model's [B, L, H, D] layout through
//    their strides (the last axis unit-stride), so the v view of the fused
//    qkv product goes in uncopied; ragged Lq and Lk are masked.
//
// bf16 (the training dtype) is built for Hopper (sm90.cuh) and runs all its
// products on the tensor cores with wgmma: one producer warp issues TMA
// loads into a ring of two stages under mbarriers, and consumer warpgroups
// of 64 rows each run the products. The score and dP accumulators become P
// and dS in registers, and their fragments, rounded to bf16, are the
// register A operand of the second products as they stand (accumulator
// columns 16k..16k+15 are depth step k), so neither goes through shared
// memory. The B operand of each second product is read MN-major, through
// the descriptor's transpose bit, from a TMA tile that the first products
// read K-major: nothing is staged transposed and no thread copies a tile.
// Head dims 16, 64 and 128: at 16 a tile row is 32 bytes under the 32-byte
// swizzle (sm90.cuh, BfTile), the first products are one depth step and
// the second products m64n16k16.
//  * dq: the producer loads the block's Q and dO once and streams K and V
//    tiles. One warpgroup (the block's 64 query rows) runs S = Q K^T and
//    dP = dO V^T from shared memory, then dQ += dS K with K read MN-major.
//  * dk/dv: the producer loads K and V once and streams (Q, dO) tiles,
//    copying each tile's lse and delta beside them. Each warpgroup (64
//    keys) runs S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//    dK += dS^T Q with dO and Q read MN-major: a whole 64-query tile a step.
//  * Two warpgroups may share each streamed tile, halving its loads, but
//    registers decide how many warpgroups an SM holds. dq takes one at both
//    head dims: at D = 64 three blocks of one fit an SM where one block of
//    two does, and at D = 128 two were no faster. dk/dv takes two at D = 64
//    where there are blocks enough to fill the card twice, one otherwise,
//    and one at D = 128, where its two D-wide accumulators fill the
//    registers.
//
// fp32 (head dims 16, 64 and 128) runs every product on the tensor cores
// in split-three TF32 (sm90.cuh; the tile helpers, shared with the fp32
// forward, in tf32x3.cuh): each operand splits as x = hi + lo, both
// TF32, and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b summed in fp32,
// as the memory-efficient attention backward PyTorch ships computes fp32
// (CUTLASS's 3xTF32). One TF32 pass is not enough: it keeps 10 mantissa
// bits, and a numpy model of this backward (round to nearest, fp32 sums;
// tests/test_torch_tf32x3.py) puts dq, dk and dv about 1e-3 (normalized)
// from fp32 with one pass, ten times the 1e-4 the kernels are held to,
// and below 1e-6 with three.
//  * The instruction is mma.sync m16n8k8 throughout, the library's own.
//    wgmma has no transpose bit for TF32: both of its shared-memory
//    operands must be K-major, so the second products' B tiles (K in dq;
//    dO and Q in dk/dv) would need a transposed hi / lo copy staged by the
//    consumers every step. mma.sync loads its fragments by thread from
//    padded tiles in either direction and splits them in registers. At
//    8 x 2048, 8 heads of 64, the pair takes 2.06 ms (dq 0.87, dk/dv 1.19)
//    against 4.89 for the SIMT pair it replaces and 2.87 for PyTorch's
//    memory-efficient backward, which is 3xTF32 too; the bound is 0.73
//    (NVIDIA H100 80GB HBM3, 700 W; tools/fp32_bwd_ab.py, chip_smoke.py
//    phase 7b). wgmma for the first products, K-major as loaded, is the
//    next step.
//  * The tensor cores' fp32 accumulator drops low bits as it adds, so a
//    sum run in it across every tile drifts from fp32's as L grows: summed
//    so, dk and dv ran 3.6e-5 (normalized) from the plain fp32 version at
//    L = 2048 and 8.5e-5 at L = 8192, near the 1e-4 they are held to, at
//    D = 128 (tools/fp32_bwd_ab.py). So the running sums take each tile's
//    second products summed from zero and add them in fp32: dq at every
//    head dim (half of D's columns at a time at D = 128) and dk/dv at
//    D <= 64. At D = 128 dk/dv's two D-wide running sums fill the
//    registers: they run in the accumulator and move out to the fp32
//    outputs every 4 Q tiles (each thread adds into its own elements).
//    Every gradient is then within 1.1e-5 at L = 8192 (chip_smoke.py 3b
//    holds them at L = 2048 and 8192); the moves cost dk/dv at D = 128
//    about 6% and a 40-byte stack frame.
//  * Four warps a block, 16 rows each (a block's 64 queries in dq, 64 keys
//    in dk/dv); the accumulator of a first product is the A operand of the
//    second as it stands, its columns 2t and 2t + 1 being A columns t and
//    t + 4, with the B rows read in that order: P and dS are split in
//    registers and never go to shared memory.
//  * Tiles arrive by 16-byte cp.async into rows padded by 8 floats, in a
//    ring of two stages: the copy of tile i + 2 is issued once every warp
//    is done with tile i, and lands while tile i + 1's products run. Bases
//    and strides must be 16-byte multiples (the wrapper checks).
//  * dk/dv at D = 128 covers a 64-query tile in two halves of 32, so its
//    score tiles and its two D-wide accumulators fit the registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;  // F32Tile, stage_rows, first_a, ..., TC_THREADS

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr float EXP_CLAMP = 30.f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLAMP2 = EXP_CLAMP * LOG2E;  // the clamp, log2 domain
static_assert(BQ == BR && BK == BR, "the staging helpers copy BR rows a tile");

struct Strides {  // (batch, length, head) strides of q, k, v and do
  int64_t q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h;
};

// ------------------------------------------------------------------------
// fp32: split-three TF32 products on the tensor cores (mma.sync), tiles
// copied by cp.async
// ------------------------------------------------------------------------

// dq: the block's Q and dO tiles, then TC_STAGES K tiles and TC_STAGES V
// tiles. dk/dv: the block's K and V tiles, TC_STAGES Q and dO tiles, and
// the lse and delta of each staged Q tile's rows.
template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * (2 + 2 * TC_STAGES) * F32Tile<D>::FLOATS;
}
template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) *
         ((2 + 2 * TC_STAGES) * F32Tile<D>::FLOATS + TC_STAGES * 2 * BQ);
}

// store_row (tf32x3.cuh) plus what `out` holds: out = (out + acc) * scale.
template <int D>
__device__ __forceinline__ void add_row(float* out,
                                        const float (&acc)[D / 8][4], int hr,
                                        int t, float scale) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    float4* o = reinterpret_cast<float4*>(out + 16 * c + 4 * t);
    const float4 was = *o;
    *o = make_float4((was.x + acc[2 * c][2 * hr]) * scale,
                     (was.y + acc[2 * c + 1][2 * hr]) * scale,
                     (was.z + acc[2 * c][2 * hr + 1]) * scale,
                     (was.w + acc[2 * c + 1][2 * hr + 1]) * scale);
  }
}

// dk/dv at D = 128: its two D-wide running sums fill the registers, so
// they run in the accumulator and move out to the fp32 outputs every
// DKV_FLUSH Q tiles instead.
constexpr int DKV_FLUSH = 4;

template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Lq, int Lk, Strides st, int q_offset,
                    int kv_offset, float scale, float scale_log2) {
  using T = F32Tile<D>;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Os = Qs + T::FLOATS;                // dO
  float* Ks = Os + T::FLOATS;                // [TC_STAGES]
  float* Vs = Ks + TC_STAGES * T::FLOATS;    // [TC_STAGES]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Query rows q0 .. q0 + 63, heaviest first: blockIdx.y = 0 takes the last
  // rows, which see the most keys.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_first = q_offset + q0;
  // KV tiles starting past the block's last global query position are
  // wholly above the diagonal and are never loaded.
  const int key_last = q_offset + min(q0 + BQ, Lq) - 1 - kv_offset;
  const int n_kv = (Lk == 0 || key_last < 0)
                       ? 0
                       : min((Lk + BK - 1) / BK, key_last / BK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * warp + g;  // this thread's tile rows: r and r + 8
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  // lse (times log2 e) and delta of this thread's rows for the whole walk.
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r + 8 * hr;
    const int64_t idx = ((int64_t)b * Lq + row) * H + h;
    lse2[hr] = row < Lq ? lse[idx] * LOG2E : 0.f;
    dlt[hr] = row < Lq ? delta[idx] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Group 0: Q, dO and the first K, V tile; group 1: the second K, V tile.
  if (n_kv > 0) {
    stage_rows<D>(Qs, q + b * st.q_b + h * st.q_h, st.q_l, q0, Lq);
    stage_rows<D>(Os, dout + b * st.o_b + h * st.o_h, st.o_l, q0, Lq);
    stage_rows<D>(Ks, kb, st.k_l, 0, Lk);
    stage_rows<D>(Vs, vb, st.v_l, 0, Lk);
  }
  sm90::cp_async_commit();
  if (n_kv > 1) {
    stage_rows<D>(Ks + T::FLOATS, kb, st.k_l, BK, Lk);
    stage_rows<D>(Vs + T::FLOATS, vb, st.v_l, BK, Lk);
  }
  sm90::cp_async_commit();

  for (int it = 0; it < n_kv; ++it) {
    // Every group but the newest has landed: tile `it` is in.
    sm90::cp_async_wait<1>();
    __syncthreads();
    const int s = it % TC_STAGES, k0 = it * BK;
    const float* Kt = Ks + s * T::FLOATS;
    const float* Vt = Vs + s * T::FLOATS;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys.
    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const sm90::FragA qa = first_a<D>(Qs, r, kk, t);
      const sm90::FragA oa = first_a<D>(Os, r, kk, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sm90::Tf32x2 b0, b1;
        first_b<D>(Kt, 8 * j + g, kk, t, b0, b1);
        sm90::mma_3xtf32(sc[j], qa, b0, b1);
        first_b<D>(Vt, 8 * j + g, kk, t, b0, b1);
        sm90::mma_3xtf32(dp[j], oa, b0, b1);
      }
    }

    // P = exp(min(s scale - lse, 30)) (in the log2 domain), then
    // dS = P (dP - delta), kept in dp. Only a tile reaching past the
    // diagonal or the ragged end needs the mask; a row that sees no key has
    // lse NEG_INF, so every key of it is masked there, not clamped.
    const bool edge = kv_offset + k0 + BK - 1 > q_first || k0 + BK > Lk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = sm90::exp2_approx(
            fminf(sc[j][e] * scale_log2 - lse2[hr], CLAMP2));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (!(key < Lk && kv_offset + key <= q_first + r + 8 * hr))
            p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dlt[hr]);
      }

    // dQ += dS K, the tile's sum taken from zero (second_sum).
    second_sum<D, PART_NC<D>, BK / 8>(acc, dp, Kt, g, t);

    // Every warp is done with this stage; refill it with tile it + 2.
    __syncthreads();
    if (it + TC_STAGES < n_kv) {
      stage_rows<D>(Ks + s * T::FLOATS, kb, st.k_l, k0 + TC_STAGES * BK, Lk);
      stage_rows<D>(Vs + s * T::FLOATS, vb, st.v_l, k0 + TC_STAGES * BK, Lk);
    }
    sm90::cp_async_commit();
  }

  // dq is freshly allocated, contiguous [B, Lq, H, D]; rows that see no key
  // get zeros.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r + 8 * hr;
    if (row < Lq)
      store_row<D>(dq + (((int64_t)b * Lq + row) * H + h) * D, acc, hr, t,
                   scale);
  }
}

// QC: the queries a warp's score tiles cover at once. The accumulators of
// dK and dV take D / 2 registers each; at D = 128 the score tiles cover 32
// queries of a 64-row Q tile at a time to stay within the registers.
template <int D, int QC>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
flash_bwd_dkv_tf32x3(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Lq, int Lk, Strides st,
                     int q_offset, int kv_offset, float scale,
                     float scale_log2) {
  using T = F32Tile<D>;
  static_assert(BQ % QC == 0, "a Q tile is whole chunks");
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + T::FLOATS;
  float* Qs = Vs + T::FLOATS;                 // [TC_STAGES]
  float* Os = Qs + TC_STAGES * T::FLOATS;     // [TC_STAGES] dO
  float* stats = Os + TC_STAGES * T::FLOATS;  // [TC_STAGES][lse BQ, delta BQ]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Keys k0 .. k0 + 63. blockIdx.y = 0 (k0 = 0) sees every Q tile, so the
  // heaviest blocks launch first.
  const int k0 = blockIdx.y * BK;
  // The first query row that sees key k0 is q_offset + r >= kv_offset + k0;
  // Q tiles before the one holding it see nothing of this block's keys.
  const int r_first = max(0, kv_offset + k0 - q_offset);
  const int q_begin = (r_first / BQ) * BQ;
  const int n_q = q_begin < Lq ? (Lq - q_begin + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * warp + g;  // this thread's keys: k0 + r and k0 + r + 8
  int kpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r + 8 * hr;
    kpos[hr] = key < Lk ? kv_offset + key : INT_MAX;  // past Lk: seen by none
  }
  const bool has_keys = k0 + 16 * warp < Lk;
  const int warp_key_first = kv_offset + k0 + 16 * warp;
  const bool warp_ragged = k0 + 16 * warp + 16 > Lk;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* ob = dout + b * st.o_b + h * st.o_h;

  // Q and dO rows q0 .. q0 + 63 into stage s, with their lse and delta
  // (strided by H in [B, Lq, H]: 4-byte copies).
  auto stage_q = [&](int s, int q0) {
    stage_rows<D>(Qs + s * T::FLOATS, qb, st.q_l, q0, Lq);
    stage_rows<D>(Os + s * T::FLOATS, ob, st.o_l, q0, Lq);
    float* sts = stats + s * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += TC_THREADS) {
      const int row = q0 + i % BQ;
      const bool in = row < Lq;
      const float* src = i < BQ ? lse : delta;
      sm90::cp_async_4(sts + i,
                       in ? src + ((int64_t)b * Lq + row) * H + h : src, in);
    }
  };
  if (n_q > 0) {
    stage_rows<D>(Ks, k + b * st.k_b + h * st.k_h, st.k_l, k0, Lk);
    stage_rows<D>(Vs, v + b * st.v_b + h * st.v_h, st.v_l, k0, Lk);
    stage_q(0, q_begin);
  }
  sm90::cp_async_commit();
  if (n_q > 1) stage_q(1, q_begin + BQ);
  sm90::cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    sm90::cp_async_wait<1>();
    __syncthreads();
    const int s = it % TC_STAGES, q0 = q_begin + it * BQ;
    const float* Qt = Qs + s * T::FLOATS;
    const float* Ot = Os + s * T::FLOATS;
    const float* sts = stats + s * 2 * BQ;

#pragma unroll 1
    for (int qc = 0; qc < BQ && has_keys && q0 + qc < Lq; qc += QC) {
      // No query of this chunk sees a key of this warp.
      if (q_offset + min(q0 + qc + QC, Lq) - 1 < warp_key_first) continue;

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x QC queries.
      float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const sm90::FragA ka = first_a<D>(Ks, r, kk, t);
        const sm90::FragA va = first_a<D>(Vs, r, kk, t);
#pragma unroll
        for (int j = 0; j < QC / 8; ++j) {
          sm90::Tf32x2 b0, b1;
          first_b<D>(Qt, qc + 8 * j + g, kk, t, b0, b1);
          sm90::mma_3xtf32(sc[j], ka, b0, b1);
          first_b<D>(Ot, qc + 8 * j + g, kk, t, b0, b1);
          sm90::mma_3xtf32(dp[j], va, b0, b1);
        }
      }

      // P^T = exp(min(s scale - lse, 30)) (in the log2 domain) kept in sc,
      // dS^T = P^T (dP^T - delta) in dp. Only a chunk reaching past the
      // diagonal or a ragged end needs the mask.
      const bool edge = warp_key_first + 15 > q_offset + q0 + qc ||
                        q0 + qc + QC > Lq || warp_ragged;
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const int c = qc + 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(sts + c);
        const float2 dl = *reinterpret_cast<const float2*>(sts + BQ + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_e = (e & 1) ? l.y : l.x;
          float p = sm90::exp2_approx(
              fminf(sc[j][e] * scale_log2 - lse_e * LOG2E, CLAMP2));
          if (edge) {
            const int row = q0 + c + (e & 1);
            if (!(row < Lq && kpos[e >> 1] <= q_offset + row)) p = 0.f;
          }
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q: at D <= 64 each chunk's sums taken
      // from zero (second_sum); at D = 128 in the running sums.
      if constexpr (D <= 64) {
        second_sum<D, D, QC / 8>(dva, sc, Ot + qc * T::STRIDE, g, t);
        second_sum<D, D, QC / 8>(dka, dp, Qt + qc * T::STRIDE, g, t);
      } else {
#pragma unroll
        for (int j = 0; j < QC / 8; ++j) {
          second_mma<D, D>(dva, second_a(sc[j]), Ot + qc * T::STRIDE, j, 0,
                           g, t);
          second_mma<D, D>(dka, second_a(dp[j]), Qt + qc * T::STRIDE, j, 0,
                           g, t);
        }
      }
    }

    // D = 128: every DKV_FLUSH tiles but the last, the running sums move
    // out to this thread's own elements of dk and dv (unscaled), where
    // fp32 adds them, and restart from zero.
    if constexpr (D > 64) {
      if ((it + 1) % DKV_FLUSH == 0 && it + 1 < n_q) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = k0 + r + 8 * hr;
          if (key >= Lk) continue;
          const int64_t o = (((int64_t)b * Lk + key) * H + h) * D;
          if (it < DKV_FLUSH) {  // the first move
            store_row<D>(dk + o, dka, hr, t, 1.f);
            store_row<D>(dv + o, dva, hr, t, 1.f);
          } else {
            add_row<D>(dk + o, dka, hr, t, 1.f);
            add_row<D>(dv + o, dva, hr, t, 1.f);
          }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
      }
    }

    // Every warp is done with this stage; refill it with tile it + 2.
    __syncthreads();
    if (it + TC_STAGES < n_q) stage_q(s, q0 + TC_STAGES * BQ);
    sm90::cp_async_commit();
  }

  // dk and dv are freshly allocated, contiguous [B, Lk, H, D]; keys no
  // query sees get zeros.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r + 8 * hr;
    if (key >= Lk) continue;
    const int64_t o = (((int64_t)b * Lk + key) * H + h) * D;
    if (D > 64 && n_q > DKV_FLUSH) {  // sums were moved out
      add_row<D>(dk + o, dka, hr, t, scale);
      add_row<D>(dv + o, dva, hr, t, 1.f);
    } else {
      store_row<D>(dk + o, dka, hr, t, scale);
      store_row<D>(dv + o, dva, hr, t, 1.f);
    }
  }
}

// ------------------------------------------------------------------------
// bf16: TMA-fed tiles, wgmma products
// ------------------------------------------------------------------------

constexpr int STAGES = 2;  // streamed tiles in flight

// Shared memory of one dq block: its 64 rows of Q and dO, loaded once; a
// ring of (K, V) tiles; the mbarriers. Tiles are stacks of BfTile<D> boxes
// (sm90.cuh), all at multiples of 1024.
template <int D>
struct DqLayout {
  using G = sm90::BfTile<D>;
  static_assert(G::ROWS == BQ && G::ROWS == BK, "64-row tiles");
  static constexpr int TILE = G::TILE;  // 64 rows of Q, dO, K or V
  static constexpr int O_OFF = TILE;
  static constexpr int K_OFF = 2 * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int THREADS = sm90::WG_THREADS + 32;
};

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
flash_bwd_dq_bf16_sm90(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       __grid_constant__ const CUtensorMap tm_o,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                       int q_offset, int kv_offset, float scale,
                       float scale_log2) {
  using Lay = DqLayout<D>;
  using G = typename Lay::G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Query rows q0 .. q0 + 63. Heaviest first: blockIdx.y = 0 takes the last
  // rows, which see the most keys.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // The block's first and last global query positions. KV tiles starting
  // past the last are wholly above the diagonal and are never loaded.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, Lq) - 1;
  const int key_last = q_last - kv_offset;
  const int n_kv = (Lk == 0 || key_last < 0)
                       ? 0
                       : min((Lk + BK - 1) / BK, key_last / BK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one lane issues every load
    if (lane == 0 && n_kv > 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * Lay::TILE);
      for (int c = 0; c < G::NC; ++c) {
        sm90::tma_load_4d(smem + c * G::BOX, &tm_q, q_full, c * G::BOX_COLS,
                          h, q0, b);
        sm90::tma_load_4d(smem + Lay::O_OFF + c * G::BOX, &tm_o, q_full,
                          c * G::BOX_COLS, h, q0, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        // The stage's previous tile must be released by every consumer.
        if (it >= STAGES)
          sm90::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + s, 2 * Lay::TILE);
        for (int c = 0; c < G::NC; ++c) {
          const int off = s * Lay::TILE + c * G::BOX;
          sm90::tma_load_4d(smem + Lay::K_OFF + off, &tm_k, full + s,
                            c * G::BOX_COLS, h, it * BK, b);
          sm90::tma_load_4d(smem + Lay::V_OFF + off, &tm_v, full + s,
                            c * G::BOX_COLS, h, it * BK, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's rows are row0 and row0 + 8 (the
  // wgmma accumulator rows), its keys 8j + 2t + {0, 1} of each KV tile.
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;
  // lse (times log2 e) and delta of this thread's rows, fixed for the whole
  // walk; strided by H in [B, Lq, H], which TMA's 16-byte rule does not take.
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const int64_t idx = ((int64_t)b * Lq + row) * H + h;
    lse2[hr] = row < Lq ? lse[idx] * LOG2E : 0.f;
    dlt[hr] = row < Lq ? delta[idx] : 0.f;
  }
  const uint32_t q_addr = sm90::smem_u32(smem);
  const uint32_t o_addr = sm90::smem_u32(smem + Lay::O_OFF);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_kv > 0) sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = it * BK;
    sm90::mbar_wait(full + s, ph);
    __syncwarp();
    const uint32_t k_addr = sm90::smem_u32(smem + Lay::K_OFF + s * Lay::TILE);
    const uint32_t v_addr = sm90::smem_u32(smem + Lay::V_OFF + s * Lay::TILE);

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, D / 16 depth steps,
    // both operands K-major from shared memory.
    float sc[BK / 2], dp[BK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss<0>(sc, sm90::desc_k_major<D>(q_addr, kk),
                        sm90::desc_k_major<D>(k_addr, kk), kk > 0);
      sm90::wgmma_ss<0>(dp, sm90::desc_k_major<D>(o_addr, kk),
                        sm90::desc_k_major<D>(v_addr, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // P = exp(min(s scale - lse, 30)) (in the log2 domain), then
    // dS = P (dP - delta), kept in dp. Only a tile reaching past the
    // diagonal or the ragged end needs the mask; a row that sees no key
    // has lse NEG_INF, so every key of it is masked there, not clamped.
    const bool edge = kv_offset + k0 + BK - 1 > q_first || k0 + BK > Lk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = sm90::exp2_approx(
            fminf(sc[4 * j + e] * scale_log2 - lse2[hr], CLAMP2));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (!(key < Lk && kv_offset + key <= q_offset + row0 + 8 * hr))
            p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt[hr]);
      }

    // dQ += dS K: dS is the register A operand (its columns 16kk..16kk+15
    // make depth step kk); K (keys x D) is read MN-major from its tile.
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = sm90::pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<1>(acc, da[kk], sm90::desc_mn_major<D>(k_addr, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }

  // dq is freshly allocated, contiguous [B, Lq, H, D]; rows that see no key
  // get zeros.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= Lq) continue;
    __nv_bfloat16* out = dq + (((int64_t)b * Lq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hr] * scale, acc[4 * j + 2 * hr + 1] * scale);
  }
}

// Shared memory of one dk/dv block: the K and V rows of its NWG
// warpgroups, loaded once; a ring of (Q, dO) tiles with the lse (times
// log2 e) and delta of their rows; the mbarriers. Tiles are stacks of
// BfTile<D> boxes (sm90.cuh), all at multiples of 1024.
template <int D, int NWG>
struct DkvLayout {
  using G = sm90::BfTile<D>;
  static_assert(G::ROWS == BQ && G::ROWS == BK, "64-row tiles");
  static constexpr int TILE = G::TILE;  // 64 rows of K, V, Q or dO
  static constexpr int V_OFF = NWG * TILE;
  static constexpr int Q_OFF = 2 * NWG * TILE;
  static constexpr int O_OFF = Q_OFF + STAGES * TILE;
  static constexpr int STAT_OFF = O_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int THREADS = NWG * sm90::WG_THREADS + 32;
};

template <int D, int NWG>
__global__ void __launch_bounds__(DkvLayout<D, NWG>::THREADS, 1)
flash_bwd_dkv_bf16_sm90(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                        int q_offset, int kv_offset, float scale,
                        float scale_log2) {
  using Lay = DkvLayout<D, NWG>;
  using G = typename Lay::G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + Lay::STAT_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Keys k0 .. k0 + 64 NWG - 1. blockIdx.y = 0 (k0 = 0) sees every Q tile,
  // so the heaviest blocks launch first.
  const int k0 = blockIdx.y * 64 * NWG;
  // The first query row that sees key k0 is q_offset + r >= kv_offset + k0;
  // Q tiles before the one holding it see nothing of this block's keys.
  const int r_first = max(0, kv_offset + k0 - q_offset);
  const int q_begin = (r_first / BQ) * BQ;
  const int n_q = q_begin < Lq ? (Lq - q_begin + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 32);        // the producer warp's lanes
      sm90::mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // The producer warp: lane 0 issues the TMA loads; all lanes copy the
    // tile rows' lse and delta (strided by H in [B, Lq, H], which TMA's
    // 16-byte rule does not take) and arrive with them.
    if (n_q > 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * NWG * Lay::TILE);
        for (int w = 0; w < NWG; ++w)
          for (int c = 0; c < G::NC; ++c) {
            const int off = w * Lay::TILE + c * G::BOX;
            sm90::tma_load_4d(smem + off, &tm_k, kv_full, c * G::BOX_COLS, h,
                              k0 + 64 * w, b);
            sm90::tma_load_4d(smem + Lay::V_OFF + off, &tm_v, kv_full,
                              c * G::BOX_COLS, h, k0 + 64 * w, b);
          }
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % STAGES, q0 = q_begin + it * BQ;
        if (it >= STAGES)
          sm90::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        float* st = stats + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int row = q0 + i;
          const int64_t idx = ((int64_t)b * Lq + row) * H + h;
          st[i] = row < Lq ? lse[idx] * LOG2E : 0.f;
          st[BQ + i] = row < Lq ? delta[idx] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full + s, 2 * Lay::TILE);
          for (int c = 0; c < G::NC; ++c) {
            const int off = s * Lay::TILE + c * G::BOX;
            sm90::tma_load_4d(smem + Lay::Q_OFF + off, &tm_q, full + s,
                              c * G::BOX_COLS, h, q0, b);
            sm90::tma_load_4d(smem + Lay::O_OFF + off, &tm_o, full + s,
                              c * G::BOX_COLS, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns keys k0 + 64w .. +63; this thread's keys
  // are key0 and key0 + 8 (the wgmma accumulator rows), its query columns
  // 8j + 2t + {0, 1} of each Q tile.
  const int w = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + 64 * w + 16 * (warp % 4) + g;
  int kpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + 8 * hr;
    kpos[hr] = key < Lk ? kv_offset + key : INT_MAX;  // past Lk: seen by none
  }
  const bool has_keys = k0 + 64 * w < Lk;
  const int wg_key_first = kv_offset + k0 + 64 * w;
  const bool wg_ragged = k0 + 64 * w + 64 > Lk;
  const uint32_t k_addr = sm90::smem_u32(smem + w * Lay::TILE);
  const uint32_t v_addr = sm90::smem_u32(smem + Lay::V_OFF + w * Lay::TILE);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (n_q > 0) sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int q0 = q_begin + it * BQ;
    sm90::mbar_wait(full + s, ph);
    __syncwarp();
    if (!has_keys || q_offset + min(q0 + BQ, Lq) - 1 < wg_key_first) {
      // No query of this tile sees a key of this warpgroup.
      if (lane == 0) sm90::mbar_arrive(empty + s);
      continue;
    }
    const uint32_t q_addr = sm90::smem_u32(smem + Lay::Q_OFF + s * Lay::TILE);
    const uint32_t o_addr = sm90::smem_u32(smem + Lay::O_OFF + s * Lay::TILE);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, D / 16 depth
    // steps, both operands K-major from shared memory.
    float sc[BQ / 2], dp[BQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss<0>(sc, sm90::desc_k_major<D>(k_addr, kk),
                        sm90::desc_k_major<D>(q_addr, kk), kk > 0);
      sm90::wgmma_ss<0>(dp, sm90::desc_k_major<D>(v_addr, kk),
                        sm90::desc_k_major<D>(o_addr, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // P^T = exp(min(s scale - lse, 30)) (in the log2 domain) kept in sc,
    // dS^T = P^T (dP^T - delta) in dp. Only a tile reaching past the
    // diagonal or a ragged end needs the mask.
    const bool edge = wg_key_first + 63 > q_offset + q0 || q0 + BQ > Lq ||
                      wg_ragged;
    const float* st = stats + s * 2 * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(st + c);
      const float2 dlt = *reinterpret_cast<const float2*>(st + BQ + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = sm90::exp2_approx(fminf(
            sc[4 * j + e] * scale_log2 - ((e & 1) ? lse2.y : lse2.x), CLAMP2));
        if (edge) {
          const int row = q0 + c + (e & 1);
          if (!(row < Lq && kpos[e >> 1] <= q_offset + row)) p = 0.f;
        }
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dlt.y : dlt.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T are the register A
    // operands (their columns 16kk..16kk+15 make depth step kk); dO and Q
    // (queries x D) are read MN-major from their tiles.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = sm90::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        da[kk][r] = sm90::pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::wgmma_rs<1>(dva, pa[kk], sm90::desc_mn_major<D>(o_addr, kk), 1);
      sm90::wgmma_rs<1>(dka, da[kk], sm90::desc_mn_major<D>(q_addr, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dka);
    sm90::fence_regs(dva);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }

  // dk and dv are freshly allocated, contiguous [B, Lk, H, D]; keys no
  // query sees get zeros.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + 8 * hr;
    if (key >= Lk) continue;
    const int64_t o = (((int64_t)b * Lk + key) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hr] * scale,
                                dka[4 * j + 2 * hr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
    }
  }
}

// ------------------------------------------------------------------------
// Launchers
// ------------------------------------------------------------------------

float softmax_scale(int d) { return (float)(1.0 / sqrt((double)d)); }

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Lq, Lk;
  Strides st;
  int q_offset, kv_offset;
  cudaStream_t stream;
};

// cudaFuncSetAttribute once per kernel instance and device, not per launch.
#define SET_MAX_SMEM(kernel, bytes)                                         \
  do {                                                                      \
    static std::atomic<uint32_t> attr_set{0};                               \
    const cudaError_t e = sm90::set_max_smem_once(attr_set, kernel, bytes); \
    if (e != cudaSuccess) return e;                                         \
  } while (0)

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  constexpr size_t smem = dq_f32_smem_bytes<D>();
  SET_MAX_SMEM(flash_bwd_dq_tf32x3<D>, smem);
  dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
  flash_bwd_dq_tf32x3<D><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.H, a.Lq, a.Lk, a.st,
      a.q_offset, a.kv_offset, softmax_scale(D), softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  constexpr int QC = D == 128 ? 32 : 64;
  constexpr size_t smem = dkv_f32_smem_bytes<D>();
  SET_MAX_SMEM((flash_bwd_dkv_tf32x3<D, QC>), smem);
  dim3 grid(a.B * a.H, (a.Lk + BK - 1) / BK);
  flash_bwd_dkv_tf32x3<D, QC><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.H,
      a.Lq, a.Lk, a.st, a.q_offset, a.kv_offset, softmax_scale(D),
      softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

// TMA maps over q, k, v and do: boxes of 64 rows of one (batch, head).
template <int D>
cudaError_t make_maps(const Args& a, CUtensorMap* tq, CUtensorMap* tk,
                      CUtensorMap* tv, CUtensorMap* to) {
  const Strides& s = a.st;
  cudaError_t err;
  if ((err = sm90::make_bhld_map<D>(tq, a.q, a.B, a.Lq, a.H, s.q_b, s.q_l,
                                    s.q_h)) != cudaSuccess ||
      (err = sm90::make_bhld_map<D>(tk, a.k, a.B, a.Lk, a.H, s.k_b, s.k_l,
                                    s.k_h)) != cudaSuccess ||
      (err = sm90::make_bhld_map<D>(tv, a.v, a.B, a.Lk, a.H, s.v_b, s.v_l,
                                    s.v_h)) != cudaSuccess)
    return err;
  return sm90::make_bhld_map<D>(to, a.dout, a.B, a.Lq, a.H, s.o_b, s.o_l,
                                s.o_h);
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  using Lay = DqLayout<D>;
  SET_MAX_SMEM(flash_bwd_dq_bf16_sm90<D>, Lay::SMEM);
  CUtensorMap tq, tk, tv, to;
  const cudaError_t err = make_maps<D>(a, &tq, &tk, &tv, &to);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
  flash_bwd_dq_bf16_sm90<D><<<grid, Lay::THREADS, Lay::SMEM, a.stream>>>(
      tq, tk, tv, to, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), a.H,
      a.Lq, a.Lk, a.q_offset, a.kv_offset, softmax_scale(D),
      softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dkv_bf16_nwg(const Args& a, void* dk, void* dv) {
  using Lay = DkvLayout<D, NWG>;
  SET_MAX_SMEM((flash_bwd_dkv_bf16_sm90<D, NWG>), Lay::SMEM);
  CUtensorMap tq, tk, tv, to;
  const cudaError_t err = make_maps<D>(a, &tq, &tk, &tv, &to);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Lk + 64 * NWG - 1) / (64 * NWG));
  flash_bwd_dkv_bf16_sm90<D, NWG><<<grid, Lay::THREADS, Lay::SMEM, a.stream>>>(
      tq, tk, tv, to, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.H, a.Lq, a.Lk, a.q_offset,
      a.kv_offset, softmax_scale(D), softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

// Warpgroups (64 keys each) per dk/dv block. At D = 64 two share each
// (Q, dO) tile when there are at least two such blocks per SM to go round
// (the train step's shape: 0.200 ms against 0.263 with one, H100), one
// otherwise (twice the blocks for short or few sequences). At D = 128 one:
// its two D-wide accumulators beside the score tiles take 246 registers.
// At D = 16 one (the dry run's blocks are 16 keys long).
template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  if constexpr (D == 64) {
    const long long blocks_128 = (long long)a.B * a.H * ((a.Lk + 127) / 128);
    if (blocks_128 >= 2LL * sm90::sm_count())
      return launch_dkv_bf16_nwg<D, 2>(a, dk, dv);
  }
  return launch_dkv_bf16_nwg<D, 1>(a, dk, dv);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int H, int Lq,
               int Lk, const long long* s, int q_offset, int kv_offset,
               void* stream) {
  return Args{q, k, v, dout,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              B, H, Lq, Lk,
              Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                      s[9], s[10], s[11]},
              q_offset, kv_offset, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, length, head) for q, then k, then v, then do; the head_dim axis
// is unit-stride, the bases 16-byte aligned and every stride a multiple of
// 16 bytes (TMA reads bf16, 16-byte cp.async fp32). lse and delta are
// contiguous fp32 [B, Lq, H]. Head dims: 16, 64 and 128 in both dtypes.
// Each entry returns a cudaError_t (0 on success).
extern "C" int tpushare_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int H,
    int Lq, int Lk, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, int q_offset, int kv_offset, void* stream) {
  if (Lq == 0 || B * H == 0) return cudaSuccess;
  const long long s[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                           v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Lq, Lk, s,
                           q_offset, kv_offset, stream);
  if (dtype == 0 && D == 16) return launch_dq_f32<16>(a, dq);
  if (dtype == 0 && D == 64) return launch_dq_f32<64>(a, dq);
  if (dtype == 0 && D == 128) return launch_dq_f32<128>(a, dq);
  if (dtype == 1 && D == 16) return launch_dq_bf16<16>(a, dq);
  if (dtype == 1 && D == 64) return launch_dq_bf16<64>(a, dq);
  if (dtype == 1 && D == 128) return launch_dq_bf16<128>(a, dq);
  return cudaErrorInvalidValue;
}

extern "C" int tpushare_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int Lq, int Lk, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int q_offset, int kv_offset,
    void* stream) {
  if (Lk == 0 || B * H == 0) return cudaSuccess;
  const long long s[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                           v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Lq, Lk, s,
                           q_offset, kv_offset, stream);
  if (dtype == 0 && D == 16) return launch_dkv_f32<16>(a, dk, dv);
  if (dtype == 0 && D == 64) return launch_dkv_f32<64>(a, dk, dv);
  if (dtype == 0 && D == 128) return launch_dkv_f32<128>(a, dk, dv);
  if (dtype == 1 && D == 16) return launch_dkv_bf16<16>(a, dk, dv);
  if (dtype == 1 && D == 64) return launch_dkv_bf16<64>(a, dk, dv);
  if (dtype == 1 && D == 128) return launch_dkv_bf16<128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
