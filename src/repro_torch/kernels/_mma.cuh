// Warp-level tensor-core pieces shared by the port's bf16 kernels
// (flash_attention/csrc/flash_attention_tc.cu, ssd_chunk/csrc/
// ssd_chunk_tc.cu), for NVIDIA Hopper (sm_90a) through mma.sync:
//
//   * mma_bf16: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b
//     with a 16 x 16 bf16 A tile, a 16 x 8 bf16 B tile and a 16 x 8 float32
//     accumulator;
//   * ldmatrix_x4 / ldmatrix_x4_trans: four 8 x 8 bf16 matrices from shared
//     memory into fragments (.trans for B tiles stored k-major);
//   * cp_async16 with commit / wait: 16-byte copies global -> shared that
//     run behind the compute, a source of 0 bytes filling zeros;
//   * split2 / split3: the split of float32 values into two (hi, lo) or
//     three (hi, mid, lo) bf16 values, and the repack of float32
//     accumulator pairs into A fragments.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), for lane l of a
// warp, g = l / 4 and q = l % 4:
//   A (16 x 16, row-major):  a0 = (g, 2q..2q+1)      a1 = (g+8, 2q..2q+1)
//                            a2 = (g, 2q+8..2q+9)    a3 = (g+8, 2q+8..2q+9)
//   B (16 x 8, k x n):       b0 = (k 2q..2q+1, n g)  b1 = (k 2q+8..2q+9, n g)
//   C (16 x 8, float32):     c0, c1 = (g, 2q..2q+1)  c2, c3 = (g+8, 2q..2q+1)
// Each 32-bit register holds two bf16 values, the lower column in the lower
// half.  So the accumulators of two neighbouring n8 tiles (columns 0-7 and
// 8-15 of a 16-column block) are, pair by pair, the A fragment of the next
// product over those 16 columns: the weights never pass through shared
// memory.
//
// The hi/lo split.  A float32 weight w that multiplies an exact bf16 operand
// goes in as two products, hi = bf16_rn(w) and lo = bf16_rn(w - hi):
// w - hi is exact in float32, and |w - hi - lo| <= 2^-17 |w|.  The
// tensor cores form each bf16 x bf16 product exactly and add it in float32,
// so hi * x + lo * x carries about 16 significant bits of w: the error is
// about 2^-17 of each term, where one bf16 rounding of w would be 2^-9.
// Three parts (mid = bf16_rn(w - hi), lo = bf16_rn(w - hi - mid), each
// difference exact) give back every float32 w of the normal range exactly,
// for one product more.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `valid` false writes 16 zero
// bytes and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives (row l / 4, columns 2 (l % 4) + 0, 1)
// of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// the same, each matrix transposed: register i receives (rows 2 (l % 4) +
// 0, 1, column l / 4) of matrix i as stored
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: A 16 x 16 bf16, B 16 x 8 bf16 (b0, b1), D 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = (bf16_rn(x0), bf16_rn(x1)), lo = bf16_rn of what hi
// leaves, each pair packed with x0 in the lower half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y)));
}

// (x0, x1) -> hi, mid, lo: split2 of x, then split2 of what hi leaves
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  split2(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y), mid, lo);
}

// the A fragments (hi and lo) over 16 columns from the accumulators of the
// two n8 tiles that cover them (columns 0-7 in c0, 8-15 in c1)
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// the same in three parts
__device__ __forceinline__ void acc_to_a3(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
  split3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

}  // namespace mma
