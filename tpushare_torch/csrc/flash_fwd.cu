// Causal flash-attention forward for Hopper (sm_90a), bound to Python
// through a plain C entry and ctypes (tpushare_torch/workload/flash_attention.py).
//
// Replaces: tpushare/workload/flash_attention.py `_flash_kernel` (launched by
// `_flash_call`). Same function: out = softmax(q k^T / sqrt(D), causal mask
// on GLOBAL positions q_offset + i >= kv_offset + j) v, plus the per-row
// log-sum-exp lse = m + log(l), or NEG_INF where a row sees no key.
//
// What bounds it on this card: 4 * D operations per visible (query, key)
// pair against 8 * D bytes of q/k/v/out per row in bf16, so causal
// attention does about L / 4 operations per byte. Against the bf16
// tensor-core peak (989 TFLOP/s over 3.35 TB/s, ~295 operations a byte) it
// is bound by bytes up to L ~ 1200 and by operations beyond; in fp32,
// against the 67 TFLOP/s of the SIMT units, by operations from L ~ 160.
//
// What the design does about it (both paths):
//  * one block per (batch * head, 64-row Q tile); the block walks 64-row
//    KV tiles up to the causal diagonal and never loads a tile wholly above
//    it, so the causal half of the work is skipped;
//  * q, k, v are read in the model's [B, L, H, D] layout through their
//    strides (the last axis must be unit-stride), so no transposes are made;
//  * the running max m, normaliser l and output accumulator stay in
//    registers in fp32 for the whole KV walk; a row's reductions are warp
//    shuffles among the lanes that share it;
//  * ragged tails (any Lq, Lk) are masked: rows past Lk load as zeros and
//    masked scores contribute exactly zero probability.
//
// bf16 (the serving dtype) runs both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate): four warps of 16 query
// rows; the score fragments become the probability operand of the PV
// product in registers; K and a transposed V tile are staged in shared
// memory (rows padded so fragment reads are free of bank conflicts), with
// 16-byte loads when the strides allow. fp32 keeps full fp32 products on
// the SIMT units (tensor-core TF32 would lose the reference's precision):
// each of 256 threads owns a 4-row slice of scores and output, with Q, K,
// V and P staged as fp32 in dynamic shared memory above the 48 KB default.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per KV tile
constexpr float NEG_INF = -1073741824.0f;  // -2**30, as the JAX package
static_assert(BQ == BK, "stage() copies BK rows for Q tiles too");

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
// bf16: tensor-core products (mma.sync m16n8k16)
// ------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int KP = 8;             // row padding (bf16) of Qs/Ks and Vt

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * BQ * (D + KP) + D * (BK + KP));
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

// Copy `rows` rows of D values from global (row stride `sl`) into shared
// memory, zero past `limit`; `transpose` writes dst[d * ld + r] instead of
// dst[r * ld + d]. 16-byte loads when `vec` (aligned base and strides).
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, int64_t sl,
                                      int r0, int limit, bool vec) {
  constexpr int CH = D / 8;  // 8-value chunks per row
  for (int i = threadIdx.x; i < BK * CH; i += MMA_THREADS) {
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int H, int Lq, int Lk, Strides st, int q_offset, int kv_offset,
               float scale, bool vec) {
  constexpr int QP = D + KP;   // Qs / Ks row stride
  constexpr int VP = BK + KP;  // Vt row stride
  constexpr int KS = D / 16;   // k-steps of the QK^T product
  constexpr int NO = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QP;  // [BK][QP]
  __nv_bfloat16* Vt = Ks + BK * QP;  // [D][VP], V transposed

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair
  const int r0 = warp * 16 + g;          // this thread's rows r0, r0 + 8
  const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h;

  stage<D, false>(Qs, QP, q + b * st.q_b + h * st.q_h, st.q_l, q0, Lq, vec);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = ld32(Qs + r0 * QP + c);
    qf[ks][1] = ld32(Qs + (r0 + 8) * QP + c);
    qf[ks][2] = ld32(Qs + r0 * QP + c + 8);
    qf[ks][3] = ld32(Qs + (r0 + 8) * QP + c + 8);
  }

  float o[NO][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};

  const int q_last = q_offset + min(q0 + BQ, Lq) - 1;
  for (int k0 = 0; k0 < Lk && kv_offset + k0 <= q_last; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vt fully consumed
    stage<D, false>(Ks, QP, kb, st.k_l, k0, Lk, vec);
    stage<D, true>(Vt, VP, vb, st.v_l, k0, Lk, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4] = {};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * QP + t * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    // Online softmax; element (nt, e) is row r0 + 8 * (e / 2), key
    // nt * 8 + t * 2 + e % 2. Masked scores become -inf: exp gives 0.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + t * 2 + e;
          const bool ok = key < Lk && kv_offset + key <= qpos[hr];
          const float x = ok ? s[nt][2 * hr + e] * scale : -INFINITY;
          s[nt][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][2 * hr + e] - m_new);
          s[nt][2 * hr + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[hr] - m_new);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        o[nt][2 * hr] *= alpha;
        o[nt][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: the score fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const __nv_bfloat16* vrow = Vt + (nt * 8 + g) * VP + kk * 16 + t * 2;
        mma_bf16(o[nt], a, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    const int64_t o_idx = ((int64_t)b * Lq + row) * H + h;
    __nv_bfloat16* orow = out + o_idx * D + t * 2;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * hr] * inv, o[nt][2 * hr + 1] * inv);
    if (t == 0)
      lse[o_idx] = l[hr] > 0.f ? m[hr] + logf(fmaxf(l[hr], 1e-30f)) : NEG_INF;
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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte loads need 16-byte aligned bases and strides in multiples of 8.
  const bool vec =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
      ((st.q_b | st.q_l | st.q_h | st.k_b | st.k_l | st.k_h | st.v_b |
        st.v_l | st.v_h) % 8 == 0);
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, H, Lq, Lk, st, q_offset,
      kv_offset, softmax_scale(D), vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, length, head) for q, then k, then v; the head_dim axis is
// unit-stride. Returns a cudaError_t (0 on success).
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
