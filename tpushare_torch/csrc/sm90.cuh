// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile loads, warpgroup matrix products (wgmma) and the
// shared-memory descriptors they read, and the host-side tensor-map builder.
//
// The tiles these kernels use are all one shape in shared memory: rows of
// 64 bf16 values (128 bytes), laid out by TMA with the 128-byte swizzle
// (the 16-byte chunk c of row r lands at chunk c ^ (r % 8)), so that eight
// rows make one 1024-byte swizzle atom. A row wider than 64 values (head
// dim 128) goes in as two such boxes, one after the other. Every tile
// starts on a 1024-byte boundary, which is what lets a wgmma descriptor
// name a tile by its start address alone (base offset 0).

#pragma once

#include <atomic>
#include <cuda.h>  // CUtensorMap and its enums (the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace sm90 {

constexpr int WG_THREADS = 128;  // a warpgroup: four warps that issue one wgmma
constexpr int BOX_COLS = 64;     // bf16 values in a 128-byte swizzled row
constexpr int ROW_BYTES = 128;

// --------------------------------------------------------------------------
// Device side
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is only
// guaranteed 16-byte alignment; the launch asks for 1024 bytes of slack).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// mbarrier: a 64-bit word in shared memory that completes a phase when its
// expected arrivals have arrived and its expected transaction bytes (from
// TMA) have landed. Waiters name the phase they wait for by its parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes initialised barriers visible to the TMA unit; then __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival; releases this thread's earlier shared-memory writes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0, c1, c2, c3) of `map` into shared
// memory at `dst` (1024-byte aligned); completion is counted in bytes on
// `bar`. Elements outside the tensor land as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma ordering: fence before a batch (after registers it reads were
// written), commit the batch as a group, wait until at most N groups are
// still in flight.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile.
//  * K-major operand (the product's depth runs along the 128-byte rows):
//    rows are M or N; 8-row groups are `sbo` = 1024 bytes apart; `lbo` is
//    unused. A k-step of 16 values is the start address plus 32 bytes.
//  * MN-major operand (M or N runs along the rows, the depth down them;
//    the transpose bit set in the instruction): 8-row groups of depth are
//    `sbo` = 1024 bytes apart, and successive 64-wide column boxes `lbo`
//    bytes apart. A k-step of 16 values is the start plus 16 rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

// Accumulator layout of m64nNk16 (f32), the same as mma.sync's per warp:
// warp w of the warpgroup holds rows 16w..16w+15; d[4j + e] is row
// 16w + lane/4 + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2. The A
// operand from registers (a[0..3], bf16 pairs) has the mma.sync m16n8k16
// A layout, so accumulator columns 16k..16k+15 of two 8-column chunks,
// packed, are the A operand of depth step k.
#define SM90_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D32 SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
#define SM90_D64 SM90_D32, SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
#define SM90_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (+)= A B, m64n64k16, A and B from shared memory (A K-major).
// scale_d = 0 overwrites D; TRANS_B = 1 reads B MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// D (+)= A B, m64n64k16, A from registers (four bf16 pairs a thread), B
// from shared memory. (The score products are 64 wide; only these, the
// products into the D-wide accumulators, also come 128 wide.)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// The same, m64n128k16.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

#undef SM90_D8
#undef SM90_D32
#undef SM90_D64
#undef SM90_R32
#undef SM90_R64

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one instruction (2 ulp); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A TMA map over a bf16 [B, L, H, D] tensor (strides in elements, the D
// axis unit-stride) as dims {D, H, L, B}, boxes of 64 columns x `rows`
// rows of one (batch, head), 128-byte swizzle, zeros outside the tensor
// (ragged tails load as zeros). TMA needs a 16-byte aligned base and byte
// strides that are multiples of 16; the Python wrapper checks both. The
// stride of an axis of size 1 is never used and is replaced by a valid one.
inline cudaError_t make_bhld_map(CUtensorMap* map, const void* base, int B,
                                 int L, int H, int D, long long sb,
                                 long long sl, long long sh, int rows) {
  if (L == 0) {  // nothing to load: the kernel issues no load through it
    memset(map, 0, sizeof(*map));
    return cudaSuccess;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (H == 1) sh = D;
  if (L == 1) sl = sh * H;
  if (B == 1) sb = sl * L;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 132;
    return count;
  }();
  return n;
}

// cudaFuncSetAttribute for the dynamic shared memory above 48 KB, once per
// kernel and device (`done` is the kernel's own flag word), not per launch.
template <typename Kernel>
cudaError_t set_max_smem_once(std::atomic<uint32_t>& done, Kernel kernel,
                              size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace sm90
