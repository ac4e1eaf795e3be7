// Hopper pieces shared by the port's warp-specialised kernels
// (flash_attention/csrc/flash_attention_bwd.cu, flash_attention_tc.cu,
// ssd_chunk/csrc/ssd_chunk_tc.cu, ssd_chunk_bwd.cu), for NVIDIA H100
// (sm_90a):
//
//   * mbarriers: init, arrive, arrive with an expected byte count, and a
//     parity wait that traps after about ten seconds, so that a protocol
//     fault ends the launch with an error instead of hanging the card;
//   * copies by the Tensor Memory Accelerator: a 4-d tiled load through a
//     tensor map, and a plain bulk copy, both completing on an mbarrier;
//     a 4-d tiled store and a plain bulk store, waited for by bulk group;
//     tensor maps are encoded on the host by the driver's
//     cuTensorMapEncodeTiled, reached through the runtime
//     (cudaGetDriverEntryPoint), so a library built with `nvcc -shared`
//     needs no link to libcuda;
//   * warpgroup matrix multiply (wgmma.mma_async, bf16 in, float32
//     accumulators): shared-memory descriptors for tiles in the 128-byte
//     swizzle that the tensor maps write, fence / commit / wait, the
//     m64n64k16 product with both operands in shared memory (B K-major or
//     MN-major) and its m64n32k16 form, and the
//     m64nNk16 products (N 64, 128, 256) with A in registers and B read
//     transposed;
//   * named barriers between warpgroups.
//
// Tile layout.  A tile of R rows by C bf16 columns (C a multiple of 64) is
// stored as C / 64 column blocks of R x 128 bytes, each row of a block 64
// values, 16-byte chunks swizzled by the row (chunk ^= row % 8): what a
// tensor map with CU_TENSOR_MAP_SWIZZLE_128B and a box of 64 x R writes.
// Blocks start at 1024-byte boundaries.  As an operand:
//   * K-major (the k index runs along the row), for A or B untransposed:
//     the k16 step kk starts at block kk / 4, byte (kk % 4) * 32 of the
//     row; stride between 8-row groups (SBO) 1024;
//   * MN-major (the k index runs down the rows), for B transposed: the k16
//     step kk starts at row 16 kk (byte 2048 kk); SBO 1024 between 8-row
//     groups along k, LBO the bytes between column blocks (R * 128) along
//     n.
//
// Fragments (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup, lane l,
// g = l / 4, q = l % 4.  The float32 accumulator holds, for each n8 tile j,
// d[4j + 0, 1] = (row 16w + g, columns 8j + 2q, + 1) and d[4j + 2, 3] =
// (row 16w + g + 8, the same columns).  An A operand in registers takes,
// for its k16 step, the mma.m16n8k16 A fragment of the warp's 16 rows, so
// the accumulators of n8 tiles 2kk and 2kk + 1 are, pair by pair, the A
// operand of k16 step kk of the next product (mma::acc_to_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of more
// than 2^34 clocks (about ten seconds) traps
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

// the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory,
// completing `bar`'s transaction bytes; rows or columns outside the tensor
// arrive as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// the box at (c0, c1, c2, c3) of a 4-d tensor map from shared memory to
// device memory (rows or columns outside the tensor are not written), in
// this thread's bulk group; `src` in the layout tma_load_4d writes
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk groups have read their shared memory
// (READ) or completed
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared, completing `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) shared ->
// global, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// ---------------------------------------------------------------------------
// named barriers (ids 1..15; 0 is __syncthreads)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive without waiting, this thread's shared-memory writes made visible
// first to the threads that sync on the barrier
__device__ __forceinline__ void named_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand starting at `p` (see the tile
// layout above): LBO and SBO in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

// orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (a wgmma operand written by the threads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

// keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A operands held in registers: the values are made here, not
// moved by the compiler into a later pipeline stage
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HOP_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOP_F32(d, i) \
  HOP_F8(d, i), HOP_F8(d, i + 8), HOP_F8(d, i + 16), HOP_F8(d, i + 24)
#define HOP_W8(d, i)                                                      \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),             \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define HOP_W32(d, i) \
  HOP_W8(d, i), HOP_W8(d, i + 8), HOP_W8(d, i + 16), HOP_W8(d, i + 24)

#define HOP_R32                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "  \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31"
#define HOP_R64                                                   \
  HOP_R32                                                         \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define HOP_R128                                                      \
  HOP_R64                                                             \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "     \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "      \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "      \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127"

// d (64 x 64) = a b + (scale_d ? d : 0): a 64 x 16 and b 16 x 64 bf16, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOP_F32(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N) += a b: a 64 x 16 bf16 in registers (the warp's A fragment),
// b 16 x N bf16 MN-major in shared memory (read transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOP_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The first product of a chain, d = a b (scale-d false), its accumulators
// written only, so that the compiler keeps no earlier value of d alive
// through the loop: the m64n64k16 products above, both operands in shared
// memory (K-major) or A in registers (B MN-major).
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOP_W32(d, 0)
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 32) (+)= a b, both K-major in shared memory; `_first` writes d
// only (scale-d false)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOP_F8(d, 0), HOP_F8(d, 8)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16],
                                                   uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOP_W8(d, 0), HOP_W8(d, 8)
      : "l"(da), "l"(db), "r"(0));
}

// d (+)= a b: a 64 x 16 bf16 K-major and b 16 x 64 bf16 MN-major (read
// transposed), both in shared memory; `_first` writes d only (scale-d
// false), as above
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HOP_F32(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64_tb_first(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HOP_W32(d, 0)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n64_first(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOP_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOP_W32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" HOP_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOP_F32(d, 0), HOP_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" HOP_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOP_F32(d, 0), HOP_F32(d, 32), HOP_F32(d, 64), HOP_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the product of width N (64, 128 or 256) with A in registers
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
}

#undef HOP_F8
#undef HOP_F32
#undef HOP_W8
#undef HOP_W32
#undef HOP_R32
#undef HOP_R64
#undef HOP_R128

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (nullptr if the
// driver has none)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    auto found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a map of the contiguous bf16 tensor (n3, n2, n1, n0), n0 innermost, read
// in boxes of 64 x 1 x `rows` x 1 in the 128-byte swizzle; 0 on success
inline int bf16_map_4d(CUtensorMap* map, const void* base, uint64_t n0,
                       uint64_t n1, uint64_t n2, uint64_t n3, uint32_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {n0, n1, n2, n3};
  const cuuint64_t strides[3] = {n0 * 2, n0 * n1 * 2, n0 * n1 * n2 * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
