// Keccak-p[1600,12] (the permutation of TurboSHAKE128) on one thread's
// 25-lane state, shared by the ctr block generator (ctr_keccak.cu) and the
// fused client s.A kernel (ctr_keccak_sa.cu). Device code only.
//
// The TPU version carries every 64-bit lane as a (lo, hi) u32 pair because
// its vector unit has no 64-bit integers; Hopper has native 64-bit lanes,
// so each thread holds the state in registers as uint64_t and the compiler
// maps the rotates onto funnel shifts. The lane loops are fully unrolled so
// every state index is a compile-time register.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the final 12 Keccak-f[1600] round constants (Keccak-p[1600, 12])
__constant__ uint64_t kRc12[12] = {
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

// one round of Keccak-f[1600] with round constant rc
__device__ __forceinline__ void keccak_round(uint64_t st[25], uint64_t rc) {
  // rho offsets and pi lane order walked along the pi cycle starting at
  // lane 1 (the usual compact formulation of rho+pi)
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  uint64_t bc[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
    for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
  }
  uint64_t t = st[1];
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int j = piln[i];
    const uint64_t tmp = st[j];
    st[j] = rotl64(t, rotc[i]);
    t = tmp;
  }
#pragma unroll
  for (int j = 0; j < 25; j += 5) {
    uint64_t b[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) b[i] = st[j + i];
#pragma unroll
    for (int i = 0; i < 5; ++i) st[j + i] = b[i] ^ (~b[(i + 1) % 5] & b[(i + 2) % 5]);
  }
  st[0] ^= rc;
}

// the 12 rounds in a loop: the state returns to the same registers each
// round, so pi's lane moves are register copies (K3's form)
__device__ __forceinline__ void keccak_p12(uint64_t st[25]) {
#pragma unroll 1
  for (int r = 0; r < 12; ++r) keccak_round(st, kRc12[r]);
}

// the 12 rounds unrolled: pi's lane moves become register renames, at
// ~40 more registers a thread and 12 rounds of code (the fused kernel's
// form for a few secrets, ctr_keccak_sa.cu)
__device__ __forceinline__ void keccak_p12_unrolled(uint64_t st[25]) {
#pragma unroll
  for (int r = 0; r < 12; ++r) keccak_round(st, kRc12[r]);
}

// the state after absorbing seed || LE64(counter) as one TurboSHAKE128
// block: the seed in lanes 0-3, the 64-bit counter in lane 4, the domain
// byte 0x1F at byte 40, the pad bit at byte 167
__device__ __forceinline__ void ctr_absorb(uint64_t st[25], uint64_t s0, uint64_t s1, uint64_t s2,
                                           uint64_t s3, uint64_t counter) {
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
  st[0] = s0;
  st[1] = s1;
  st[2] = s2;
  st[3] = s3;
  st[4] = counter;
  st[5] = 0x1FULL;
  st[20] = 0x8000000000000000ULL;
}

}  // namespace
