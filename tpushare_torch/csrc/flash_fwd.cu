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
// is bound by bytes up to L ~ 1200 and by operations beyond. fp32 moves
// twice the bytes (L / 8 operations a byte) and runs each product as three
// TF32 passes (below), an fp32-accurate roof of 165 TFLOP/s: bound by
// operations from L ~ 400.
//
// What the design does about it (both dtypes):
//  * a block walks the KV tiles of its Q rows up to the causal diagonal and
//    never loads a tile wholly above it, so the causal half of the work is
//    skipped;
//  * q, k, v are read in the model's [B, L, H, D] layout through their
//    strides (the last axis must be unit-stride), so no transposes are made;
//  * the running max m, normaliser l and output accumulator stay in
//    registers in fp32 for the whole KV walk; a row's reductions are warp
//    shuffles among the four lanes that share it;
//  * the softmax runs in fp32 on log2e-scaled scores with exp2, and masks
//    only the tiles that straddle the diagonal or the ragged end (masked
//    scores are -inf, so they contribute exactly zero probability; rows
//    past Lk load as zeros);
//  * the score accumulator's fragments are the A operand of the PV product
//    as they stand (the accumulator and A layouts agree per warp), so P
//    never goes through shared memory;
//  * K and V tiles of 64 keys arrive in a ring of two stages while the
//    previous tile's products run;
//  * blocks launch heaviest first (the last Q tiles see the most keys), so
//    the longest blocks do not run as a tail.
//
// bf16 (the serving and training dtype; head dims 16, 64 and 128) is built
// for Hopper (sm90.cuh):
//  * one producer warp issues TMA loads: the block's Q rows once, then K
//    and V tiles into the ring, each tile under its own mbarrier;
//  * one consumer warpgroup of 64 Q rows runs both products with wgmma:
//    S = Q K^T with Q and K from shared memory (K-major), and O += P V
//    with P from registers, rounded to bf16, and V read straight from its
//    TMA tile through the descriptor's transpose bit, so nothing is staged
//    transposed and no thread copies a tile. At head dim 16 a tile row is
//    32 bytes under the 32-byte swizzle, S is one depth step and O += P V
//    is m64n16k16;
//  * a block is one warpgroup and the producer warp (160 threads), so
//    several share an SM; two warpgroups sharing each K/V tile ran slower
//    at every measured shape.
// fp32 (head dims 16, 64 and 128) runs both products on the tensor cores in
// split-three TF32 (sm90.cuh, tf32x3.cuh), as the fp32 backward does: each
// operand splits as x = hi + lo, both TF32, and a product is lo_a hi_b +
// hi_a lo_b + hi_a hi_b summed in fp32 (one TF32 pass would keep 10
// mantissa bits; tests/test_torch_tf32x3.py models both).
//  * mma.sync m16n8k8: four warps of 16 Q rows make a 64-row tile; Q is
//    staged once and K and V tiles arrive by 16-byte cp.async into rows
//    padded by 8 floats, the refill of tile i + 2 issued once every warp is
//    done with tile i (bases and strides must be 16-byte multiples; the
//    wrapper checks).
//  * O += P V is summed from zero for each KV tile (half of D's columns at
//    a time at D = 128) and added in fp32 to the running O, rescaled by the
//    row's alpha first: the tensor cores' accumulator drops low bits as it
//    adds, so a sum run in it across every tile drifts as L grows (the fp32
//    backward's dk and dv did, to 8.5e-5 at L = 8192; flash_bwd.cu).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;  // F32Tile, stage_rows, first_a, ..., TC_THREADS

constexpr int BQ = 64;  // query rows per block (both dtypes)
constexpr int BK = 64;  // key rows per KV tile (both dtypes)
static_assert(BQ == BR && BK == BR, "the staging helpers copy BR rows a tile");
constexpr float NEG_INF = -1073741824.0f;  // -2**30, as the JAX package
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  int64_t q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h;
};

// ------------------------------------------------------------------------
// fp32: split-three TF32 products on the tensor cores (mma.sync), tiles
// copied by cp.async
// ------------------------------------------------------------------------

// The block's Q tile, then TC_STAGES K tiles and TC_STAGES V tiles.
template <int D>
constexpr size_t fwd_f32_smem_bytes() {
  return sizeof(float) * (1 + 2 * TC_STAGES) * F32Tile<D>::FLOATS;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, Strides st,
                 int q_offset, int kv_offset, float scale_log2) {
  using T = F32Tile<D>;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + T::FLOATS;              // [TC_STAGES]
  float* Vs = Ks + TC_STAGES * T::FLOATS;  // [TC_STAGES]

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

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // Running max (log2 domain) and this thread's share of the row sum of
  // rows r and r + 8; a row's four lanes are added once, at the end.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // Group 0: Q and the first K, V tile; group 1: the second K, V tile.
  if (n_kv > 0) {
    stage_rows<D>(Qs, q + b * st.q_b + h * st.q_h, st.q_l, q0, Lq);
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

    // S = Q K^T: this warp's 16 rows x 64 keys, D / 8 depth steps.
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const sm90::FragA qa = first_a<D>(Qs, r, kk, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sm90::Tf32x2 b0, b1;
        first_b<D>(Kt, 8 * j + g, kk, t, b0, b1);
        sm90::mma_3xtf32(sc[j], qa, b0, b1);
      }
    }

    // Online softmax in the log2 domain; sc[j][e] is row r + 8 (e / 2),
    // key k0 + 8j + 2t + e % 2. Masked scores become -inf (exp2 gives 0);
    // only a tile reaching past the diagonal or Lk needs a mask.
    const bool edge = kv_offset + k0 + BK - 1 > q_first || k0 + BK > Lk;
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q_first + r + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          float x = sc[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (!(key < Lk && kv_offset + key <= qpos)) x = -INFINITY;
          }
          sc[j][e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      alpha[hr] = sm90::exp2_approx(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = sm90::exp2_approx(sc[j][e] - m_new);
          sc[j][e] = p;
          sum += p;
        }
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }

    // O = alpha O + P V, the tile's P V summed from zero (second_sum).
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    second_sum<D, PART_NC<D>, BK / 8>(acc, sc, Vt, g, t);

    // Every warp is done with this stage; refill it with tile it + 2.
    __syncthreads();
    if (it + TC_STAGES < n_kv) {
      stage_rows<D>(Ks + s * T::FLOATS, kb, st.k_l, k0 + TC_STAGES * BK, Lk);
      stage_rows<D>(Vs + s * T::FLOATS, vb, st.v_l, k0 + TC_STAGES * BK, Lk);
    }
    sm90::cp_async_commit();
  }

  // out and lse are freshly allocated, contiguous [B, Lq, H, D] / [B, Lq, H];
  // a row that sees no key has l = 0 and O = 0: out 0, lse NEG_INF.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + r + 8 * hr;
    if (row >= Lq) continue;
    const int64_t o = ((int64_t)b * Lq + row) * H + h;
    store_row<D>(out + o * D, acc, hr, t, 1.f / fmaxf(lt, 1e-30f));
    if (t == 0) lse[o] = lt > 0.f ? (m[hr] + log2f(lt)) * LN2 : NEG_INF;
  }
}

// ------------------------------------------------------------------------
// bf16: TMA-fed tiles, wgmma products
// ------------------------------------------------------------------------

constexpr int STAGES = 2;  // K/V tiles in flight

// Shared memory of one block: its 64 Q rows, then the K and V rings, then
// the mbarriers. Every tile is a stack of BfTile<D> boxes (sm90.cuh); every
// offset is a multiple of 1024.
template <int D>
struct FwdLayout {
  using G = sm90::BfTile<D>;
  static_assert(G::ROWS == BQ && G::ROWS == BK, "64-row tiles");
  static constexpr int Q_TILE = G::TILE;  // the block's 64 Q rows
  static constexpr int KV = G::TILE;      // one K or V tile
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
  using G = typename Lay::G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // Heaviest first: blockIdx.y = 0 takes the last Q tile, which sees the
  // most keys.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // KV tiles starting past the block's last global query position are
  // wholly above the diagonal and are never loaded.
  const int key_last = q_offset + min(q0 + BQ, Lq) - 1 - kv_offset;
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
      for (int c = 0; c < G::NC; ++c)
        sm90::tma_load_4d(smem + c * G::BOX, &tm_q, q_full,
                          c * G::BOX_COLS, h, q0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        // The stage's previous tile must be released by every consumer.
        if (it >= STAGES)
          sm90::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        unsigned char* ks = smem + Lay::K_OFF + s * Lay::KV;
        unsigned char* vs = smem + Lay::V_OFF + s * Lay::KV;
        sm90::mbar_arrive_expect_tx(k_full + s, Lay::KV);
        for (int c = 0; c < G::NC; ++c)
          sm90::tma_load_4d(ks + c * G::BOX, &tm_k, k_full + s,
                            c * G::BOX_COLS, h, it * BK, b);
        sm90::mbar_arrive_expect_tx(v_full + s, Lay::KV);
        for (int c = 0; c < G::NC; ++c)
          sm90::tma_load_4d(vs + c * G::BOX, &tm_v, v_full + s,
                            c * G::BOX_COLS, h, it * BK, b);
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
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(sc, sm90::desc_k_major<D>(q_addr, kk),
                        sm90::desc_k_major<D>(k_addr, kk), kk > 0);
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
    // of depth step kk; V (keys x D) is read MN-major from its tile
    // (m64nDk16).
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
      sm90::wgmma_rs<1>(o, pa[kk], sm90::desc_mn_major<D>(v_addr, kk), 1);
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
  constexpr size_t smem = fwd_f32_smem_bytes<D>();
  static std::atomic<uint32_t> attr_set{0};
  cudaError_t err =
      sm90::set_max_smem_once(attr_set, flash_fwd_tf32x3<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_tf32x3<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Lq, Lk,
      st, q_offset, kv_offset, softmax_scale(D) * LOG2E);
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
  if ((err = sm90::make_bhld_map<D>(&tq, q, B, Lq, H, st.q_b, st.q_l,
                                    st.q_h)) != cudaSuccess ||
      (err = sm90::make_bhld_map<D>(&tk, k, B, Lk, H, st.k_b, st.k_l,
                                    st.k_h)) != cudaSuccess ||
      (err = sm90::make_bhld_map<D>(&tv, v, B, Lk, H, st.v_b, st.v_l,
                                    st.v_h)) != cudaSuccess)
    return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_bf16_sm90<D><<<grid, Lay::THREADS, Lay::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, Lq, Lk, q_offset,
      kv_offset, softmax_scale(D) * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, length, head) for q, then k, then v; the head_dim axis is
// unit-stride, the bases 16-byte aligned and every stride a multiple of 16
// bytes (TMA reads bf16, 16-byte cp.async fp32). Head dims: 16, 64 and 128
// in both dtypes. Returns a cudaError_t (0 on success).
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
  if (dtype == 1 && D == 16)
    return launch_bf16<16>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                           kv_offset, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                           kv_offset, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, out, l, B, H, Lq, Lk, st, q_offset,
                            kv_offset, s);
  return cudaErrorInvalidValue;
}
