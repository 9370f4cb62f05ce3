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
// byte or more: bound by operations from L ~ 900 in bf16 against the
// 989 TFLOP/s of the tensor cores, and from L ~ 60 in fp32 against the
// 67 TFLOP/s of the SIMT units.
//
// What the design does about it:
//  * dq: one block per (batch * head, 64-row Q tile). Q and dO are staged
//    once; lse and delta for the block's rows stay in registers. The block
//    walks 64-row KV tiles up to the causal diagonal (a tile starting past
//    the block's last global query position is never loaded) and keeps
//    dq's accumulator in registers for the whole walk.
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
// bf16 (the training dtype) runs all its products on the tensor cores.
// The score and dP accumulators become P and dS in registers, and their
// fragments, rounded to bf16, are the A operand of the second products as
// they stand (the accumulator layout of two 8-column chunks is the operand
// layout of one depth step), so neither goes through shared memory.
//  * dq keeps its first design, mma.sync m16n8k16: four warps of 16 Q
//    rows; K is staged a second time transposed for the dS K product, rows
//    padded so fragment reads are free of bank conflicts, with 16-byte
//    loads when the strides allow.
//  * dk/dv is built for Hopper (sm90.cuh): one producer warp loads K and V
//    by TMA once and streams (Q, dO) tiles through a ring of two stages,
//    copying each tile's lse and delta beside them; one consumer
//    warpgroup per 64 keys runs S^T = K Q^T and dP^T = V dO^T with wgmma
//    from shared memory, then dV += P^T dO and dK += dS^T Q with P^T and
//    dS^T from registers and dO and Q read straight from their TMA tiles
//    through the descriptor's transpose bit: no transposed copies, and a
//    whole 64-query tile per step. Two warpgroups share each (Q, dO) tile
//    at D = 64 when there are blocks enough to fill the card twice; one
//    otherwise, and always at D = 128, for its registers.
// fp32 keeps full fp32 products on the SIMT units (tensor-core TF32 would
// lose the reference's precision): 256 threads as 16 row groups x 16
// column lanes, a 4 x 4 slice of each score tile and 4 rows x D/16 columns
// of each accumulator to a thread, tiles staged in dynamic shared memory
// with rows padded by one float.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr float EXP_CLAMP = 30.f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "the staging helpers copy BQ rows for every tile");

struct Strides {  // (batch, length, head) strides of q, k, v and do
  int64_t q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h;
};

// ------------------------------------------------------------------------
// fp32: SIMT products
// ------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;  // 16 row groups x 16 column lanes

// Copy BQ rows of D values from global (row stride `sl`) into shared
// memory [BQ][D + 1], zero for rows past `limit`.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int64_t sl, int r0, int limit) {
  for (int i = threadIdx.x; i < BQ * D; i += SIMT_THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < limit ? src[row * sl + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * (4 * BQ * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) * (4 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int H, int Lq, int Lk, Strides st, int q_offset,
                 int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + BQ * DP;   // dO
  float* Ks = Os + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ds = Vs + BK * DP;   // [BQ][BK + 1] dS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16;    // rows rg*4 .. rg*4+3
  const int cg = tid % 16;    // columns cg + 16*j
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  stage_f32<D>(Qs, q + b * st.q_b + h * st.q_h, st.q_l, q0, Lq);
  stage_f32<D>(Os, dout + b * st.o_b + h * st.o_h, st.o_l, q0, Lq);

  // lse and delta are contiguous [B, Lq, H].
  float row_lse[4], row_delta[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const int64_t idx = ((int64_t)b * Lq + row) * H + h;
    row_lse[i] = row < Lq ? lse[idx] : 0.f;
    row_delta[i] = row < Lq ? delta[idx] : 0.f;
    qpos[i] = row < Lq ? q_offset + row : INT_MIN;  // past Lq: sees nothing
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // Global position of this tile's last real query row: KV tiles starting
  // past it are wholly above the diagonal and are never loaded.
  const int q_last = q_offset + min(q0 + BQ, Lq) - 1;
  for (int k0 = 0; k0 < Lk && kv_offset + k0 <= q_last; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ds fully consumed
    stage_f32<D>(Ks, kb, st.k_l, k0, Lk);
    stage_f32<D>(Vs, vb, st.v_l, k0, Lk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 x 4 slice.
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg * 4 + i) * DP + d];
        ov[i] = Os[(rg * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(cg + 16 * j) * DP + d];
        vv[j] = Vs[(cg + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + cg + 16 * j;
        const bool ok = c < Lk && kv_offset + c <= qpos[i];
        const float p =
            ok ? expf(fminf(s[i][j] * scale - row_lse[i], EXP_CLAMP)) : 0.f;
        Ds[(rg * 4 + i) * (BK + 1) + cg + 16 * j] =
            p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();

    // dQ += dS K.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(rg * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[kk * DP + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  // dq is freshly allocated, contiguous [B, Lq, H, D].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Lq) continue;
    float* out = dq + (((int64_t)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[cg + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Lq, int Lk, Strides st,
                  int q_offset, int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* Os = Qs + BQ * DP;        // dO
  float* Ps = Os + BQ * DP;        // [BK][BQ + 1] P^T
  float* Ds = Ps + BK * (BQ + 1);  // [BK][BQ + 1] dS^T
  float* Ls = Ds + BK * (BQ + 1);  // [BQ] lse of the Q tile's rows
  float* Dl = Ls + BQ;             // [BQ] delta of the Q tile's rows

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int rg = tid / 16;    // keys rg*4 .. rg*4+3
  const int cg = tid % 16;    // query columns / accumulator columns cg + 16*j
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* ob = dout + b * st.o_b + h * st.o_h;

  stage_f32<D>(Ks, k + b * st.k_b + h * st.k_h, st.k_l, k0, Lk);
  stage_f32<D>(Vs, v + b * st.v_b + h * st.v_h, st.v_l, k0, Lk);

  int kpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    kpos[i] = key < Lk ? kv_offset + key : INT_MAX;  // past Lk: seen by none
  }

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // The first query row that sees key k0 is q_offset + r >= kv_offset + k0;
  // Q tiles before the one holding it see nothing of this KV tile.
  const int r_first = max(0, kv_offset + k0 - q_offset);
  for (int q0 = (r_first / BQ) * BQ; q0 < Lq; q0 += BQ) {
    __syncthreads();  // previous tile's Qs/Os/Ps/Ds fully consumed
    stage_f32<D>(Qs, qb, st.q_l, q0, Lq);
    stage_f32<D>(Os, ob, st.o_l, q0, Lq);
    for (int i = tid; i < BQ; i += SIMT_THREADS) {
      const int row = q0 + i;
      const int64_t idx = ((int64_t)b * Lq + row) * H + h;
      Ls[i] = row < Lq ? lse[idx] : 0.f;
      Dl[i] = row < Lq ? delta[idx] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(rg * 4 + i) * DP + d];
        vv[i] = Vs[(rg * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(cg + 16 * j) * DP + d];
        ov[j] = Os[(cg + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j, row = q0 + c;
        const bool ok = row < Lq && kpos[i] <= q_offset + row;
        const float p =
            ok ? expf(fminf(s[i][j] * scale - Ls[c], EXP_CLAMP)) : 0.f;
        Ps[(rg * 4 + i) * (BQ + 1) + c] = p;
        Ds[(rg * 4 + i) * (BQ + 1) + c] = p * (dp[i][j] - Dl[c]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q.
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(rg * 4 + i) * (BQ + 1) + qq];
        dsv[i] = Ds[(rg * 4 + i) * (BQ + 1) + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float ov = Os[qq * DP + cg + 16 * j];
        const float qv = Qs[qq * DP + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pv[i], ov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

  // dk and dv are freshly allocated, contiguous [B, Lk, H, D]; keys no
  // query sees get zeros.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    if (key >= Lk) continue;
    const int64_t o = (((int64_t)b * Lk + key) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[o + cg + 16 * j] = dk_acc[i][j] * scale;
      dv[o + cg + 16 * j] = dv_acc[i][j];
    }
  }
}

// ------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync m16n8k16)
// ------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr int KP = 8;             // row padding (bf16) of every staged tile
constexpr int TP = BQ + KP;       // row stride of the transposed tiles

template <int D>
constexpr size_t dq_bf16_smem_bytes() {  // Qs, Os, Ks, Vs + Kt
  return sizeof(__nv_bfloat16) * (4 * BQ * (D + KP) + D * TP);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows r0, r0 + 8 and k-step ks of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int ks, int t) {
  const int c = ks * 16 + t * 2;
  a[0] = ld32(tile + r0 * ld + c);
  a[1] = ld32(tile + (r0 + 8) * ld + c);
  a[2] = ld32(tile + r0 * ld + c + 8);
  a[3] = ld32(tile + (r0 + 8) * ld + c + 8);
}

// Copy BQ rows of D values from global (row stride `sl`) into shared
// memory, zero past `limit`; `transpose` writes dst[d * ld + r] instead of
// dst[r * ld + d]. 16-byte loads when `vec` (aligned base and strides).
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, int64_t sl,
                                      int r0, int limit, bool vec) {
  constexpr int CH = D / 8;  // 8-value chunks per row
  for (int i = threadIdx.x; i < BQ * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8, row = r0 + r;
    __align__(16) __nv_bfloat16 val[8];
    if (row >= limit) {
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] = __float2bfloat16_rn(0.f);
    } else if (vec) {
      *reinterpret_cast<uint4*>(val) =
          *reinterpret_cast<const uint4*>(src + row * sl + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] = src[row * sl + c + e];
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(c + e) * ld + r] = val[e];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(val);
    }
  }
}

// Fragment element (nt, e) of a 16 x 64 accumulator tile is row
// r0 + 8 * (e / 2), column nt * 8 + t * 2 + e % 2.

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                  Strides st, int q_offset, int kv_offset, float scale,
                  bool vec) {
  constexpr int QP = D + KP;  // row stride of the row-major tiles
  constexpr int KS = D / 16;  // k-steps of the S and dP products
  constexpr int NO = D / 8;   // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + BQ * QP;  // dO
  __nv_bfloat16* Ks = Os + BQ * QP;
  __nv_bfloat16* Vs = Ks + BK * QP;
  __nv_bfloat16* Kt = Vs + BK * QP;  // [D][TP], K transposed

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair
  const int r0 = warp * 16 + g;          // this thread's rows r0, r0 + 8
  const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h;

  stage<D, false>(Qs, QP, q + b * st.q_b + h * st.q_h, st.q_l, q0, Lq, vec);
  stage<D, false>(Os, QP, dout + b * st.o_b + h * st.o_h, st.o_l, q0, Lq,
                  vec);

  float row_lse[2], row_delta[2];
  int qpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    const int64_t idx = ((int64_t)b * Lq + row) * H + h;
    row_lse[hr] = row < Lq ? lse[idx] : 0.f;
    row_delta[hr] = row < Lq ? delta[idx] : 0.f;
    qpos[hr] = row < Lq ? q_offset + row : INT_MIN;  // past Lq: sees nothing
  }

  float acc[NO][4] = {};
  const int q_last = q_offset + min(q0 + BQ, Lq) - 1;
  for (int k0 = 0; k0 < Lk && kv_offset + k0 <= q_last; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Kt fully consumed
    stage<D, false>(Ks, QP, kb, st.k_l, k0, Lk, vec);
    stage<D, false>(Vs, QP, vb, st.v_l, k0, Lk, vec);
    stage<D, true>(Kt, TP, kb, st.k_l, k0, Lk, vec);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, QP, r0, ks, t);
      load_a(oa, Os, QP, r0, ks, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = (nt * 8 + g) * QP + ks * 16 + t * 2;
        mma_bf16(s[nt], qa, ld32(Ks + c), ld32(Ks + c + 8));
        mma_bf16(dp[nt], oa, ld32(Vs + c), ld32(Vs + c + 8));
      }
    }

    // dS = P * (dP - delta), P rebuilt from lse; kept in s.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e / 2;
        const int key = k0 + nt * 8 + t * 2 + e % 2;
        const bool ok = key < Lk && kv_offset + key <= qpos[hr];
        const float p = ok ? expf(fminf(s[nt][e] * scale - row_lse[hr],
                                        EXP_CLAMP))
                           : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[hr]);
      }

    // dQ += dS K: the dS fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; K^T rows give the B fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const __nv_bfloat16* krow = Kt + (nt * 8 + g) * TP + kk * 16 + t * 2;
        mma_bf16(acc[nt], a, ld32(krow), ld32(krow + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= Lq) continue;
    __nv_bfloat16* out = dq + (((int64_t)b * Lq + row) * H + h) * D + t * 2;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) = __floats2bfloat162_rn(
          acc[nt][2 * hr] * scale, acc[nt][2 * hr + 1] * scale);
  }
}

// ------------------------------------------------------------------------
// bf16 dk/dv: TMA-fed tiles, wgmma products
// ------------------------------------------------------------------------

constexpr int STAGES = 2;  // (Q, dO) tiles in flight

// Shared memory of one dk/dv block: the K and V rows of its NWG
// warpgroups, loaded once; a ring of (Q, dO) tiles with the lse (times
// log2 e) and delta of their rows; the mbarriers. Tiles are stacks of
// 64-column boxes of 128-byte swizzled rows, all at multiples of 1024.
template <int D, int NWG>
struct DkvLayout {
  static constexpr int NC = D / sm90::BOX_COLS;  // boxes per row
  static constexpr int BOX = 64 * sm90::ROW_BYTES;
  static constexpr int TILE = NC * BOX;  // 64 rows of K, V, Q or dO
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
  constexpr int NC = Lay::NC;
  constexpr float CLAMP2 = EXP_CLAMP * LOG2E;
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
          for (int c = 0; c < NC; ++c) {
            const int off = w * Lay::TILE + c * Lay::BOX;
            sm90::tma_load_4d(smem + off, &tm_k, kv_full, c * sm90::BOX_COLS,
                              h, k0 + 64 * w, b);
            sm90::tma_load_4d(smem + Lay::V_OFF + off, &tm_v, kv_full,
                              c * sm90::BOX_COLS, h, k0 + 64 * w, b);
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
          for (int c = 0; c < NC; ++c) {
            const int off = s * Lay::TILE + c * Lay::BOX;
            sm90::tma_load_4d(smem + Lay::Q_OFF + off, &tm_q, full + s,
                              c * sm90::BOX_COLS, h, q0, b);
            sm90::tma_load_4d(smem + Lay::O_OFF + off, &tm_o, full + s,
                              c * sm90::BOX_COLS, h, q0, b);
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
      const uint32_t off = (kk / 4) * Lay::BOX + (kk % 4) * 32;
      sm90::wgmma_ss<0>(sc, sm90::desc_sw128(k_addr + off, 16, 1024),
                        sm90::desc_sw128(q_addr + off, 16, 1024), kk > 0);
      sm90::wgmma_ss<0>(dp, sm90::desc_sw128(v_addr + off, 16, 1024),
                        sm90::desc_sw128(o_addr + off, 16, 1024), kk > 0);
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
      const uint32_t off = kk * 16 * sm90::ROW_BYTES;
      sm90::wgmma_rs<1>(dva, pa[kk],
                        sm90::desc_sw128(o_addr + off, Lay::BOX, 1024), 1);
      sm90::wgmma_rs<1>(dka, da[kk],
                        sm90::desc_sw128(q_addr + off, Lay::BOX, 1024), 1);
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

// 16-byte loads need 16-byte aligned bases and strides in multiples of 8.
bool vec_ok(const Args& a) {
  const Strides& s = a.st;
  return ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k)
           | reinterpret_cast<uintptr_t>(a.v)
           | reinterpret_cast<uintptr_t>(a.dout)) % 16 == 0) &&
         ((s.q_b | s.q_l | s.q_h | s.k_b | s.k_l | s.k_h | s.v_b | s.v_l |
           s.v_h | s.o_b | s.o_l | s.o_h) % 8 == 0);
}

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
  SET_MAX_SMEM(flash_bwd_dq_f32<D>, smem);
  dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
  flash_bwd_dq_f32<D><<<grid, SIMT_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.H, a.Lq, a.Lk, a.st,
      a.q_offset, a.kv_offset, softmax_scale(D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_f32_smem_bytes<D>();
  SET_MAX_SMEM(flash_bwd_dkv_f32<D>, smem);
  dim3 grid(a.B * a.H, (a.Lk + BK - 1) / BK);
  flash_bwd_dkv_f32<D><<<grid, SIMT_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.H,
      a.Lq, a.Lk, a.st, a.q_offset, a.kv_offset, softmax_scale(D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  SET_MAX_SMEM(flash_bwd_dq_bf16<D>, smem);
  dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
  flash_bwd_dq_bf16<D><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.H, a.Lq, a.Lk, a.st, a.q_offset,
      a.kv_offset, softmax_scale(D), vec_ok(a));
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dkv_bf16_nwg(const Args& a, void* dk, void* dv) {
  using Lay = DkvLayout<D, NWG>;
  SET_MAX_SMEM((flash_bwd_dkv_bf16_sm90<D, NWG>), Lay::SMEM);
  const Strides& s = a.st;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = sm90::make_bhld_map(&tq, a.q, a.B, a.Lq, a.H, D, s.q_b, s.q_l,
                                 s.q_h, BQ)) != cudaSuccess ||
      (err = sm90::make_bhld_map(&tk, a.k, a.B, a.Lk, a.H, D, s.k_b, s.k_l,
                                 s.k_h, 64)) != cudaSuccess ||
      (err = sm90::make_bhld_map(&tv, a.v, a.B, a.Lk, a.H, D, s.v_b, s.v_l,
                                 s.v_h, 64)) != cudaSuccess ||
      (err = sm90::make_bhld_map(&to, a.dout, a.B, a.Lq, a.H, D, s.o_b, s.o_l,
                                 s.o_h, BQ)) != cudaSuccess)
    return err;
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
// is unit-stride. lse and delta are contiguous fp32 [B, Lq, H]. Each entry
// returns a cudaError_t (0 on success).
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
  if (dtype == 0 && D == 64) return launch_dq_f32<64>(a, dq);
  if (dtype == 0 && D == 128) return launch_dq_f32<128>(a, dq);
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
  if (dtype == 0 && D == 64) return launch_dkv_f32<64>(a, dk, dv);
  if (dtype == 0 && D == 128) return launch_dkv_f32<128>(a, dk, dv);
  if (dtype == 1 && D == 64) return launch_dkv_bf16<64>(a, dk, dv);
  if (dtype == 1 && D == 128) return launch_dkv_bf16<128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
