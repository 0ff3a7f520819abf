// What the tensor-core kernels of this package share (respond_packed.cu's
// tensor-core regime and respond_digits.cu): the geometry of the packed hi
// plane, asynchronous copies into shared memory, `ldmatrix` loads and the
// int8 `mma.sync` products. Device code only; needs sm_80 or newer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int PACK>
struct Fields {
  static constexpr int kBits = PACK > 1 ? 8 / PACK : 8;
  // the field mask repeated in each byte: (w >> shift) & kRep takes field j
  // of 4 packed bytes at once (bits + shift <= 8, so nothing leaks)
  static constexpr uint32_t kRep = ((1u << kBits) - 1u) * 0x01010101u;
};

// hi plane row stride and the column offset / shift of the field block that
// holds `col` (the 4 or 16 columns read together never straddle two blocks)
template <int PACK>
__device__ __forceinline__ void hi_geometry(int64_t col, int64_t c_pad, int64_t pc,
                                            int64_t* ld, int64_t* hcol, int* shift) {
  if (PACK > 1) {
    const int64_t j = col / pc;
    *ld = pc;
    *hcol = col - j * pc;
    *shift = (int)j * Fields<PACK>::kBits;
  } else {
    *ld = c_pad;
    *hcol = col;
    *shift = 0;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// asynchronous copies into shared memory; a source of 0 valid bytes
// writes zeros (rows past the split, queries past nq)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// `bytes` (0 to 8 or 16) valid source bytes, the rest of the copy zeros
__device__ __forceinline__ void cp_async8n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices, transposed: lane 8j + i names row i of matrix j
// (16 bytes: one chunk of 16 columns of one raw plane row); register j of
// lane (g, t) holds rows 2t and 2t + 1 of matrix j at columns 2g and 2g + 1
__device__ __forceinline__ void ldmatrix_t4(uint32_t (&r)[4], const uint8_t* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row_addr)));
}

// four 8 x 8 b16 matrices as they lie: register j of lane (g, t) holds
// bytes 4t .. 4t + 3 of row g of matrix j, which is how the K-major A
// operand of an int8 mma wants its rows
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const uint8_t* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row_addr)));
}

// The registers of ldmatrix_t4 hold two columns each; these are the B
// fragment words of one k32 mma step for columns 2g (even) and 2g + 1
// (odd): word `half` takes, in this order, rows 2t and 2t + 1 of matrix
// 2 half and rows 2t and 2t + 1 of matrix 2 half + 1. Which plane rows
// those are is up to the addresses ldmatrix_t4 was given.
__device__ __forceinline__ void split_columns(const uint32_t (&r)[4], uint32_t (&even)[2],
                                              uint32_t (&odd)[2]) {
  even[0] = __byte_perm(r[0], r[1], 0x6420);
  odd[0] = __byte_perm(r[0], r[1], 0x7531);
  even[1] = __byte_perm(r[2], r[3], 0x6420);
  odd[1] = __byte_perm(r[2], r[3], 0x7531);
}

// m16n8k32 int8 products into s32 accumulators (no .satfinite)
__device__ __forceinline__ void mma_s8u8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
