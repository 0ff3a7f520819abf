// The streaming client's s.A over ctr A in one pass: out[q, c] = sum_r
// s_q[r] * A[r, col0 + c] (mod 2^32) for nq ternary secrets s_q, with A
// generated here and never stored. A is fingerprint-major: column c is
// words [c * rows, (c + 1) * rows) of the ctr stream, whose block i is
// TurboSHAKE128(seed || LE64(i))[:168], 42 little-endian u32 words.
//
// Pairs with the Pallas kernel chalametpir_tpu/ops/prg_jax.py
// `ctr_blocks_pallas` (:195, body `_ctr_keccak_kernel` :144) fused with the
// JAX client's einsum over the slab it generates
// (chalametpir_tpu/ops/client_device.py `_streaming_fold`). The TPU fold
// writes A's slab, recodes it into byte planes and multiplies them on the
// matrix unit; here the secrets are ternary and few, so the product is one
// integer multiply-add per generated word and secret, done in registers
// as the permutation emits the word.
//
// Bound: integer ALU, as K3 (ctr_keccak.cu): ~2,160 32-bit operations a
// Keccak-p[1600,12] for 42 words, plus nq multiply-adds a word. Nothing of
// A touches device memory; the kernel reads nq * rows sign bytes and
// writes nq * ncols words. Design: one thread owns one fingerprint column
// (43-44 ctr blocks; a block that straddles two columns, ~3 % of them, is
// permuted by both threads), so there is no cross-thread reduction and no
// atomic. The signs sit in shared memory as int8, each secret's row
// zero-padded on both sides so a block's words outside the column
// multiply by 0 without a branch; a block's 42 signs are 12 aligned u32
// loads, and `prmt` takes each sign out of them sign-extended, with its
// byte shift in the selector. For a few secrets the permutation's rounds
// are unrolled (keccak_p12_unrolled), which K3 does not do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_p12.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 42;  // u32 words a ctr block
// zero sign bytes before row 0: a column's first block starts up to 41
// words before the column (a multiple of 4, so the rows' bytes keep their
// alignment)
constexpr int kPad = 44;
// secrets a launch takes (kernels.SA_MAX_Q): a larger batch is launched in
// chunks of 32, the instantiation with the least time a secret (32.1 ms for
// 32 secrets over the 2^21 columns against 77.2 ms for 64; PERF.md §6)
constexpr int kMaxQ = 32;
// the instantiations up to this many secrets unroll the permutation's
// rounds: at one secret 14.5 against 15.7-16.0 ms over the 2^21 columns;
// past 8 the unrolled rounds and the dot's unrolled secrets outgrow the
// instruction cache (32 secrets 37.1 against 32.2 ms; PERF.md §6)
constexpr int kUnrolledMaxQ = 8;

// bytes of one secret's sign row in shared memory: the pad, the rows, and
// room for the 12 words loaded past the last block's first row
__host__ __device__ constexpr int sign_stride(int rows) { return (kPad + rows + 48 + 15) / 16 * 16; }

// byte `sel & 7` of {b, a} sign-extended to 32 bits (the selector's other
// nibbles replicate that byte's sign bit)
__device__ __forceinline__ int32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  int32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t sext_selector(uint32_t byte) { return byte | ((byte | 8u) * 0x1110u); }

template <int Q>
__global__ void __launch_bounds__(kThreads)
ctr_keccak_kernel_sa(uint64_t s0, uint64_t s1, uint64_t s2, uint64_t s3, const int8_t* __restrict__ signs,
                     int nq, int rows, uint64_t col0, int64_t ncols, uint32_t* __restrict__ out,
                     int64_t out_stride) {
  extern __shared__ uint32_t sgn[];  // nq rows of sign_stride(rows) bytes
  const int words = sign_stride(rows) / 4;
  for (int i = threadIdx.x; i < nq * words; i += kThreads) {
    const int q = i / words;
    const int p = (i - q * words) * 4 - kPad;  // the row of the word's first byte
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p + k >= 0 && p + k < rows) w |= (uint32_t)(uint8_t)signs[(int64_t)q * rows + p + k] << (8 * k);
    sgn[i] = w;
  }
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= ncols) return;
  const uint64_t w0 = (col0 + (uint64_t)c) * (uint64_t)rows;  // the column's first word: past 2^32 from c 2,421,064
  const uint64_t blk = w0 / kWords;
  const int off = (int)(w0 - blk * kWords);
  const int nblk = (int)((w0 + rows - 1) / kWords - blk) + 1;
  uint32_t acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0;
#pragma unroll 1
  for (int i = 0; i < nblk; ++i) {
    uint64_t st[25];
    ctr_absorb(st, s0, s1, s2, s3, blk + i);
    if constexpr (Q <= kUnrolledMaxQ)
      keccak_p12_unrolled(st);
    else
      keccak_p12(st);
    const int base = kPad + kWords * i - off;  // sign byte of the block's first word, >= 3
    const uint32_t* sw = sgn + (base >> 2);
    const uint32_t sh = base & 3;
    uint32_t sel[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) sel[t] = sext_selector(t + sh);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q < nq) {  // the same for every thread
        uint32_t w[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) w[k] = sw[q * words + k];
        uint32_t a = acc[q];
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const uint32_t word = (j & 1) ? (uint32_t)(st[j >> 1] >> 32) : (uint32_t)st[j >> 1];
          a += (uint32_t)prmt(w[j >> 2], w[(j >> 2) + 1], sel[j & 3]) * word;
        }
        acc[q] = a;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (q < nq) out[q * out_stride + c] = acc[q];
}

template <int Q>
int launch(uint64_t s0, uint64_t s1, uint64_t s2, uint64_t s3, const int8_t* signs, int nq, int rows,
           uint64_t col0, int64_t ncols, uint32_t* out, int64_t out_stride, cudaStream_t stream) {
  const int smem = nq * sign_stride(rows);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ctr_keccak_kernel_sa<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t grid = (ncols + kThreads - 1) / kThreads;
  ctr_keccak_kernel_sa<Q><<<(unsigned)grid, kThreads, smem, stream>>>(s0, s1, s2, s3, signs, nq, rows, col0,
                                                                     ncols, out, out_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// signs: (nq, rows) int8 in {-1, 0, 1}, contiguous; out: nq rows of ncols
// u32 words, row stride out_stride words. Columns col0 .. col0 + ncols of
// A, A having `rows` rows. 1 <= nq <= kMaxQ. The seed is passed as its
// four little-endian 64-bit lanes. Launches on `stream`; returns the
// launch status (cudaSuccess or the reason the launch was refused).
extern "C" int ctr_keccak_sa_launch(uint64_t s0, uint64_t s1, uint64_t s2, uint64_t s3, const int8_t* signs,
                                    int nq, int rows, uint64_t col0, int64_t ncols, uint32_t* out,
                                    int64_t out_stride, void* stream) {
  if (ncols <= 0) return (int)cudaSuccess;
  if (nq < 1 || nq > kMaxQ || rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nq <= 1) return launch<1>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
  if (nq <= 2) return launch<2>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
  if (nq <= 4) return launch<4>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
  if (nq <= 8) return launch<8>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
  if (nq <= 16) return launch<16>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
  return launch<32>(s0, s1, s2, s3, signs, nq, rows, col0, ncols, out, out_stride, st);
}
