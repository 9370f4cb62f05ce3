// Causal flash-attention forward for Hopper (sm_90a), bound to Python
// through a plain C entry and ctypes (tpushare_torch/workload/flash_attention.py).
//
// Replaces: tpushare/workload/flash_attention.py `_flash_kernel` (launched by
// `_flash_call`). Same function: out = softmax(q k^T / sqrt(D), causal mask
// on GLOBAL positions q_offset + i >= kv_offset + j) v, plus the per-row
// log-sum-exp lse = m + log(l), or NEG_INF where a row sees no key (out 0).
//
// What bounds it on this card: 4 * D operations per visible (query, key)
// pair against 8 * D bytes of q/k/v/out per row in bf16, so causal
// attention does about L / 4 operations per byte. Against the bf16
// tensor-core peak (989 TFLOP/s over 3.35 TB/s, ~295 operations a byte) it
// is bound by bytes up to L ~ 1200 and by operations beyond; in fp32,
// against the 67 TFLOP/s of the SIMT units, by operations from L ~ 160.
//
// What the design does about it (both paths):
//  * a block walks the KV tiles of its Q rows up to the causal diagonal and
//    never loads a tile wholly above it, so the causal half of the work is
//    skipped;
//  * q, k, v are read in the model's [B, L, H, D] layout through their
//    strides (the last axis must be unit-stride), so no transposes are made;
//  * the running max m, normaliser l and output accumulator stay in
//    registers in fp32 for the whole KV walk; a row's reductions are warp
//    shuffles among the lanes that share it;
//  * ragged tails (any Lq, Lk) are masked: rows past Lk load as zeros and
//    masked scores contribute exactly zero probability.
//
// bf16 (the serving and training dtype) is built for Hopper (sm90.cuh):
//  * one producer warp issues TMA loads: the block's Q rows once, then K
//    and V tiles of 64 keys into a ring of two stages, each tile under its
//    own mbarrier, so the next tile is in flight while this one is used;
//  * one consumer warpgroup of 64 Q rows runs both products with wgmma: S = Q K^T with Q and K from shared memory (K-major), and
//    O += P V with P from registers and V read straight from its TMA tile
//    through the descriptor's transpose bit, so nothing is staged
//    transposed and no thread copies a tile;
//  * the softmax runs in fp32 on log2e-scaled scores with exp2, and masks
//    only the tiles that straddle the diagonal or the ragged end;
//  * P's accumulator fragments are repacked in registers as the A operand
//    of the PV product (the wgmma accumulator and register-A layouts agree
//    per warp with mma.sync's);
//  * blocks launch heaviest first (the last Q tiles see the most keys), so
//    the longest blocks do not run as a tail. A block is one warpgroup and
//    the producer warp (160 threads), so several share an SM; two
//    warpgroups sharing each K/V tile ran slower at every measured shape.
// fp32 (head dims 16, 64 and 128) still runs its products on the SIMT
// units: each of 256 threads owns a 4-row slice of scores and output, with
// Q, K, V and P staged as fp32 in dynamic shared memory above the 48 KB
// default. One TF32 pass on the tensor cores would lose fp32's precision,
// but the split-three TF32 products of the fp32 backward (flash_bwd.cu)
// keep it; moving this kernel to them is the next redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block (fp32)
constexpr int BK = 64;  // key rows per KV tile (both paths)
constexpr float NEG_INF = -1073741824.0f;  // -2**30, as the JAX package
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  int64_t q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h;
};

// ------------------------------------------------------------------------
// fp32: SIMT products
// ------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;  // 16 row groups x 16 column lanes

constexpr size_t simt_smem_bytes(int d) {
  return sizeof(float) * (3 * BQ * (d + 1) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int H, int Lq, int Lk, Strides st,
              int q_offset, int kv_offset, float scale) {
  constexpr int DP = D + 1;   // padded row stride in shared memory
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;   // [BQ][BK + 1] probabilities

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16;    // rows rg*4 .. rg*4+3
  const int cg = tid % 16;    // columns cg + 16*j
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  for (int i = tid; i < BQ * D; i += SIMT_THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * DP + d] = row < Lq ? qb[row * st.q_l + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Global position of this tile's last real query row: KV tiles starting
  // past it are wholly above the diagonal and are never loaded.
  const int q_last = q_offset + min(q0 + BQ, Lq) - 1;
  for (int k0 = 0; k0 < Lk && kv_offset + k0 <= q_last; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int i = tid; i < BK * D; i += SIMT_THREADS) {
      const int r = i / D, d = i % D, row = k0 + r;
      const bool in = row < Lk;
      Ks[r * DP + d] = in ? kb[row * st.k_l + d] : 0.f;
      Vs[r * DP + d] = in ? vb[row * st.v_l + d] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + cg + 16 * j;
        ok[j] = c < Lk && kv_offset + c <= qpos;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(rg * 4 + i) * (BK + 1) + cg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * DP + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // out and lse are freshly allocated, contiguous [B, Lq, H, D] / [B, Lq, H].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int64_t o = ((int64_t)b * Lq + row) * H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[o * D + cg + 16 * j] = acc[i][j] * inv;
    if (cg == 0)
      lse[o] = l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : NEG_INF;
  }
}

// ------------------------------------------------------------------------
// bf16: TMA-fed tiles, wgmma products
// ------------------------------------------------------------------------

constexpr int STAGES = 2;  // K/V tiles in flight

// Shared memory of one block: its 64 Q rows, then the K and V rings, then
// the mbarriers. Every tile is a stack of 64-column boxes of
// 128-byte swizzled rows; every offset is a multiple of 1024.
template <int D>
struct FwdLayout {
  static constexpr int NC = D / sm90::BOX_COLS;  // boxes per row
  static constexpr int Q_BOX = 64 * sm90::ROW_BYTES;
  static constexpr int KV_BOX = BK * sm90::ROW_BYTES;
  static constexpr int Q_TILE = NC * Q_BOX;  // the block's 64 Q rows
  static constexpr int KV = NC * KV_BOX;    // one K or V tile
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static constexpr int THREADS = sm90::WG_THREADS + 32;
};

template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::THREADS, 1)
flash_fwd_bf16_sm90(__grid_constant__ const CUtensorMap tm_q,
                    __grid_constant__ const CUtensorMap tm_k,
                    __grid_constant__ const CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int H, int Lq, int Lk, int q_offset, int kv_offset,
                    float scale_log2) {
  using Lay = FwdLayout<D>;
  constexpr int NC = Lay::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Heaviest first: blockIdx.y = 0 takes the last Q tile, which sees the
  // most keys.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  // KV tiles starting past the block's last global query position are
  // wholly above the diagonal and are never loaded.
  const int key_last = q_offset + min(q0 + 64, Lq) - 1 - kv_offset;
  const int n_kv = (Lk == 0 || key_last < 0)
                       ? 0
                       : min((Lk + BK - 1) / BK, key_last / BK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one lane issues every load
    if (lane == 0 && n_kv > 0) {
      sm90::mbar_arrive_expect_tx(q_full, Lay::Q_TILE);
      for (int c = 0; c < NC; ++c)
        sm90::tma_load_4d(smem + c * Lay::Q_BOX, &tm_q, q_full,
                          c * sm90::BOX_COLS, h, q0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        // The stage's previous tile must be released by every consumer.
        if (it >= STAGES)
          sm90::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        unsigned char* ks = smem + Lay::K_OFF + s * Lay::KV;
        unsigned char* vs = smem + Lay::V_OFF + s * Lay::KV;
        sm90::mbar_arrive_expect_tx(k_full + s, Lay::KV);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_4d(ks + c * Lay::KV_BOX, &tm_k, k_full + s,
                            c * sm90::BOX_COLS, h, it * BK, b);
        sm90::mbar_arrive_expect_tx(v_full + s, Lay::KV);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_4d(vs + c * Lay::KV_BOX, &tm_v, v_full + s,
                            c * sm90::BOX_COLS, h, it * BK, b);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's rows are row0 and row0 + 8 (the
  // wgmma accumulator layout).
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;
  const int q_first = q_offset + q0;  // the block's first global position
  const uint32_t q_addr = sm90::smem_u32(smem);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (n_kv > 0) sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = it * BK;
    sm90::mbar_wait(k_full + s, ph);
    __syncwarp();

    // S = Q K^T: 64 rows x 64 keys, D / 16 depth steps.
    const uint32_t k_addr = sm90::smem_u32(smem + Lay::K_OFF + s * Lay::KV);
    float sc[BK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;  // 16 values along the row
      sm90::wgmma_ss<0>(
          sc, sm90::desc_sw128(q_addr + (kk / 4) * Lay::Q_BOX + step, 16, 1024),
          sm90::desc_sw128(k_addr + (kk / 4) * Lay::KV_BOX + step, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // Online softmax in the log2 domain. Masked scores become -inf (exp2
    // gives 0); only a tile reaching past the diagonal or Lk needs a mask.
    const bool edge = kv_offset + k0 + BK - 1 > q_first || k0 + BK > Lk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q_offset + row0 + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * hr + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (!(key < Lk && kv_offset + key <= qpos)) x = -INFINITY;
          }
          sc[4 * j + 2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = sm90::exp2_approx(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = sm90::exp2_approx(sc[4 * j + 2 * hr + e] - m_new);
          sc[4 * j + 2 * hr + e] = p;
          sum += p;
        }
      // This thread's share of the row sum; the row's four lanes are
      // added once, at the end.
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hr] *= alpha;
        o[4 * j + 2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator columns 16kk..16kk+15 are the A operand
    // of depth step kk; V (keys x D) is read MN-major from its tile.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = sm90::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    sm90::mbar_wait(v_full + s, ph);
    __syncwarp();
    const uint32_t v_addr = sm90::smem_u32(smem + Lay::V_OFF + s * Lay::KV);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<1>(
          o, pa[kk],
          sm90::desc_sw128(v_addr + kk * 16 * sm90::ROW_BYTES, Lay::KV_BOX,
                           1024),
          1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }

  // out and lse are freshly allocated, contiguous [B, Lq, H, D] / [B, Lq, H].
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * hr;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int64_t o_idx = ((int64_t)b * Lq + row) * H + h;
    __nv_bfloat16* orow = out + o_idx * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
    if (t == 0) lse[o_idx] = lt > 0.f ? (m[hr] + log2f(lt)) * LN2 : NEG_INF;
  }
}

// ------------------------------------------------------------------------
// Launchers
// ------------------------------------------------------------------------

float softmax_scale(int d) { return (float)(1.0 / sqrt((double)d)); }

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int Lq, int Lk,
                       const Strides& st, int q_offset, int kv_offset,
                       cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes(D);
  static std::atomic<uint32_t> attr_set{0};
  cudaError_t err = sm90::set_max_smem_once(attr_set, flash_fwd_f32<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_f32<D><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Lq, Lk,
      st, q_offset, kv_offset, softmax_scale(D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Lq, int Lk,
                        const Strides& st, int q_offset, int kv_offset,
                        cudaStream_t stream) {
  using Lay = FwdLayout<D>;
  static std::atomic<uint32_t> attr_set{0};
  cudaError_t err =
      sm90::set_max_smem_once(attr_set, flash_fwd_bf16_sm90<D>, Lay::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = sm90::make_bhld_map(&tq, q, B, Lq, H, D, st.q_b, st.q_l, st.q_h,
                                 64)) != cudaSuccess ||
      (err = sm90::make_bhld_map(&tk, k, B, Lk, H, D, st.k_b, st.k_l, st.k_h,
                                 BK)) != cudaSuccess ||
      (err = sm90::make_bhld_map(&tv, v, B, Lk, H, D, st.v_b, st.v_l, st.v_h,
                                 BK)) != cudaSuccess)
    return err;
  dim3 grid(B * H, (Lq + 63) / 64);
  flash_fwd_bf16_sm90<D><<<grid, Lay::THREADS, Lay::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, Lq, Lk, q_offset,
      kv_offset, softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, length, head) for q, then k, then v; the head_dim axis is
// unit-stride (and for bf16, which TMA reads, the base 16-byte aligned and
// every stride a multiple of 8 elements). Head dims: 16, 64 and 128 in
// fp32, 64 and 128 in bf16. Returns a cudaError_t (0 on
// success).
extern "C" int tpushare_flash_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int dtype, int B,
                                  int H, int Lq, int Lk, int D,
                                  long long q_sb, long long q_sl,
                                  long long q_sh, long long k_sb,
                                  long long k_sl, long long k_sh,
                                  long long v_sb, long long v_sl,
                                  long long v_sh, int q_offset,
                                  int kv_offset, void* stream) {
  if (Lq == 0 || B * H == 0) return cudaSuccess;
  const Strides st = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 16)
    return launch_f32<16>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                          kv_offset, s);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                          kv_offset, s);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                           kv_offset, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                           kv_offset, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                            kv_offset, s);
  return cudaErrorInvalidValue;
}
