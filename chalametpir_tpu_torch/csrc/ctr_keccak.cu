// ctr-mode TurboSHAKE128 block generator: block i of the public LWE matrix
// stream is TurboSHAKE128(seed || LE64(block0 + i))[:168], emitted as 42
// little-endian u32 words, block-major (nblocks, 42).
//
// Replaces the Pallas kernel chalametpir_tpu/ops/prg_jax.py
// `_ctr_keccak_kernel` (launched by `ctr_blocks_pallas`). The permutation,
// with 64-bit lanes in registers, is keccak_p12.cuh's, which the fused
// client kernel (ctr_keccak_sa.cu) shares.
//
// Bound: integer ALU. One Keccak-p[1600,12] permutation is ~1,000 64-bit
// operations per 168 output bytes, so the card's integer throughput, not
// its memory bandwidth, limits the kernel. Design: one thread per ctr block
// (no cross-thread state); the 168-byte outputs are staged through shared
// memory so the global stores of a thread block are one contiguous,
// coalesced range instead of 168-byte strided writes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_p12.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 42;  // 21 rate lanes x 2 u32 words

__global__ void __launch_bounds__(kThreads)
ctr_keccak_kernel(uint64_t s0, uint64_t s1, uint64_t s2, uint64_t s3,
                  uint64_t block0, int64_t nblocks, uint32_t* __restrict__ out) {
  __shared__ uint32_t stage[kThreads * kWords];
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int64_t b = first + threadIdx.x;
  if (b < nblocks) {
    uint64_t st[25];
    ctr_absorb(st, s0, s1, s2, s3, block0 + (uint64_t)b);  // u64 wraparound carries into the high word
    keccak_p12(st);
    uint32_t* mine = stage + threadIdx.x * kWords;
#pragma unroll
    for (int lane = 0; lane < 21; ++lane) {
      mine[2 * lane] = (uint32_t)st[lane];
      mine[2 * lane + 1] = (uint32_t)(st[lane] >> 32);
    }
  }
  __syncthreads();
  const int64_t here = min((int64_t)kThreads, nblocks - first) * kWords;
  uint32_t* dst = out + first * kWords;
  for (int64_t i = threadIdx.x; i < here; i += kThreads) dst[i] = stage[i];
}

}  // namespace

// out: device buffer of nblocks * 42 u32 words. The seed is passed as its
// four little-endian 64-bit lanes. Launches on `stream`; returns the launch
// status (cudaSuccess or the reason the launch was refused).
extern "C" int ctr_keccak_launch(uint64_t s0, uint64_t s1, uint64_t s2, uint64_t s3,
                                 uint64_t block0, int64_t nblocks, uint32_t* out,
                                 void* stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  const int64_t grid = (nblocks + kThreads - 1) / kThreads;
  ctr_keccak_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      s0, s1, s2, s3, block0, nblocks, out);
  return (int)cudaGetLastError();
}
