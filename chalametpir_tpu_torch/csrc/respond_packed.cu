// Packed-layout respond / hint-fold kernels:
//   out[q, c] += sum_k Q[q, k] * el[k, c]   (mod 2^32, u32 wraparound)
// with el = (lo[k, c] + 128) + (field(hi, k, c) << 8) read straight from the
// packed serving planes (the JAX package's ops/packed.py layout): lo is the
// biased low byte, hi holds PACK fields of 8/PACK bits per byte,
// block-interleaved (field j of packed word t is column j*pc + t). PACK = 0
// means b <= 8 and no hi plane at all.
//
// Replaces the Pallas kernels chalametpir_tpu/ops/respond_pallas.py
// `_kernel_with_hi` (K1, PACK in {1, 2, 4, 8}) and `_kernel_lo_only` (K2,
// PACK = 0) together with the XLA glue around them (the int8 digit recode
// of the queries, the bias sums and `_combine`). Two regimes, picked by
// the number of queries Q (kernels.py `MMA_MIN_Q`):
//
// * Scan (one query). Bound by device memory: the planes are read once
//   and each element costs one u32 multiply-add on the CUDA cores.
//   Each thread owns 16 adjacent columns, so every row is one 16-byte load
//   of lo and one of hi (the 16 columns of a thread lie in one field block:
//   pc is a multiple of 16; the lanes of a warp that read the same hi bytes
//   for other field blocks issue one merged request). The query word of a
//   row is read straight into a register (all lanes read the same word:
//   one broadcast), and kUnroll rows are loaded before any is used, to
//   keep enough bytes in flight. Row lanes of a block sum in shared memory
//   before the atomics: every split adds into the same c_pad words.
//
// * Tensor cores (Q >= 2: batches and the hint folds, Q = 16 and 1774).
//   Q u32 multiply-adds per element would bound the fold by the integer
//   multiply-add rate; instead, as on the TPU, each query word is split
//   into four balanced int8 digits, x == sum_d D_d 256^d (mod 2^32), and the
//   digits meet the planes in `mma.sync.m16n8k32` s8 x u8 -> s32: the lo
//   byte read as u8 (lo ^ 0x80) takes all four digits, the hi field takes
//   digits 0-2 (digit 3 x 2^8 x 2^24 vanishes mod 2^32), 7 digit rows per
//   query with no bias correction. Each digit's s32 partial is scaled by
//   2^(8d) and summed in u32. A block owns 16 queries x 128 columns and a
//   split of at most 65,536 rows, so |partial| <= 65,536 x 128 x 255
//   < 2^31: the s32 accumulators never overflow. The balanced digits of x
//   are the bytes of (x + 0x80808080) ^ 0x80808080 (the carries of the add
//   are the digit carries). Both operands of an int8 mma are K-major and
//   the planes are row-major (row = k). A ring of kStages stages in shared
//   memory is filled by cp.async (raw plane rows, 16 bytes a copy, and the
//   raw query words, 16 or 8 bytes a copy where their layout allows: the
//   copies, not the products, are what a stage costs), so three stages are
//   in flight while one is multiplied. The plane operand needs no transposing pass:
//   `ldmatrix.trans` on the raw rows hands each lane two rows of two
//   columns per 8 x 8 b16 matrix, and two `prmt` per column make the
//   fragment word; the k order this gives (rows 2t, 2t + 1, 2t + 8,
//   2t + 9 in one word) is free within a product, so the query digits are
//   staged in the same order. Query tiles are the fastest grid dimension,
//   so the blocks that share a plane tile run together and read it from
//   device memory about once for all Q.
//
// The TPU walks its row tiles in order and accumulates in the output block;
// here blocks run in parallel over row splits, and the partial sums meet in
// `out` through u32 atomicAdd (addition mod 2^32 is associative, so the
// result is bit-identical in any order). `out` is accumulated into, never
// overwritten: the setup's hint chunks all add into one buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

// -- scan regime -------------------------------------------------------------

constexpr int kScanCols = 16;  // columns per thread: one 16-byte load per plane
constexpr int kUnroll = 8;     // rows loaded before the first is used

template <int PACK>
__device__ __forceinline__ void scan_row(uint32_t (&acc)[kScanCols], const uint4& lw,
                                         const uint4& hw, int shift, uint32_t qv) {
  const uint32_t lws[4] = {lw.x, lw.y, lw.z, lw.w};
  const uint32_t hws[4] = {hw.x, hw.y, hw.z, hw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // biased int8 -> unsigned low byte: (int8)x + 128 == (uint8)x ^ 0x80
    const uint32_t l = lws[i] ^ 0x80808080u;
    uint32_t el[4];
    if (PACK == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) el[j] = (l >> (8 * j)) & 0xFFu;
    } else {
      const uint32_t f = (hws[i] >> shift) & Fields<PACK>::kRep;
      const uint32_t p01 = __byte_perm(l, f, 0x5140);  // l0 f0 l1 f1
      const uint32_t p23 = __byte_perm(l, f, 0x7362);  // l2 f2 l3 f3
      el[0] = p01 & 0xFFFFu;
      el[1] = p01 >> 16;
      el[2] = p23 & 0xFFFFu;
      el[3] = p23 >> 16;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[4 * i + j] += qv * el[j];
  }
}

// one query (blockIdx.z) per block; 16 columns per thread (threadIdx.x);
// blockDim.y lanes split the block's rows, and their sums meet in shared
// memory, so one atomic per column and block reaches `out`: the atomics of
// every split land on the same c_pad words, and without the block sum they
// took a quarter of a one-query scan
template <int PACK>
__global__ void __launch_bounds__(512)
respond_scan_kernel(const uint32_t* __restrict__ q, int64_t sq, int64_t sk,
                    const int8_t* __restrict__ lo, const uint8_t* __restrict__ hi, int64_t m,
                    int64_t c_pad, int64_t pc, int64_t rows_per_split, uint32_t* __restrict__ out,
                    int64_t ld_out) {
  extern __shared__ uint32_t sums[];  // [lane][column of the thread][thread]
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kScanCols;
  const bool active = col < c_pad;
  const int64_t s_begin = (int64_t)blockIdx.y * rows_per_split;
  const int64_t s_end = min(m, s_begin + rows_per_split);
  const int64_t per_lane = (s_end - s_begin + blockDim.y - 1) / blockDim.y;
  const int64_t k_begin = s_begin + threadIdx.y * per_lane;
  const int64_t k_end = min(s_end, k_begin + per_lane);
  int64_t hi_ld = 0, hi_col = 0;
  int shift = 0;
  if (PACK != 0) hi_geometry<PACK>(col, c_pad, pc, &hi_ld, &hi_col, &shift);
  const uint32_t* qrow = q + (int64_t)blockIdx.z * sq;

  uint32_t acc[kScanCols];
#pragma unroll
  for (int i = 0; i < kScanCols; ++i) acc[i] = 0u;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int64_t k = active ? k_begin : k_end;
  for (; k + kUnroll <= k_end; k += kUnroll) {
    uint4 lw[kUnroll], hw[kUnroll];
    uint32_t qv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      lw[u] = __ldg(reinterpret_cast<const uint4*>(lo + (k + u) * c_pad + col));
      hw[u] = PACK != 0 ? __ldg(reinterpret_cast<const uint4*>(hi + (k + u) * hi_ld + hi_col)) : zero4;
      qv[u] = __ldg(qrow + (k + u) * sk);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) scan_row<PACK>(acc, lw[u], hw[u], shift, qv[u]);
  }
  for (; k < k_end; ++k) {
    const uint4 lw = __ldg(reinterpret_cast<const uint4*>(lo + k * c_pad + col));
    const uint4 hw = PACK != 0 ? __ldg(reinterpret_cast<const uint4*>(hi + k * hi_ld + hi_col)) : zero4;
    scan_row<PACK>(acc, lw, hw, shift, __ldg(qrow + k * sk));
  }

  const int nx = blockDim.x;
#pragma unroll
  for (int i = 0; i < kScanCols; ++i) sums[(threadIdx.y * kScanCols + i) * nx + threadIdx.x] = acc[i];
  __syncthreads();
  if (threadIdx.y != 0 || !active) return;
  for (int y = 1; y < (int)blockDim.y; ++y)
#pragma unroll
    for (int i = 0; i < kScanCols; ++i) acc[i] += sums[(y * kScanCols + i) * nx + threadIdx.x];
  uint32_t* dst = out + (int64_t)blockIdx.z * ld_out + col;
#pragma unroll
  for (int i = 0; i < kScanCols; ++i) atomicAdd(dst + i, acc[i]);
}

// -- tensor-core regime ------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kBQ = 16;           // queries per block: one m16 tile per digit
constexpr int kBN = 128;          // columns per block: 32 per warp, two 16-column chunks
constexpr int kKT = 64;           // rows per stage: two k32 steps
constexpr int kStages = 4;        // stages of raw tiles in flight (cp.async ring)
constexpr int kPlaneLd = kBN + 16;  // raw plane row stride in bytes: ldmatrix rows hit 8 bank groups
// Raw query tile layouts, by how the queries lie in device memory:
// kQRows: rows of k contiguous and 16-byte aligned (respond): 16-byte copies
//   of 4 consecutive k into query-major rows;
// kQCols: the 16 queries of a k contiguous and 8-byte aligned (the hint
//   fold's transposed A slab): 8-byte copies of 2 queries into k-major rows;
// kQAny: any other strides: one 4-byte copy per word, query-major rows.
enum QLayout { kQAny = 0, kQRows = 1, kQCols = 2 };
constexpr int kQLd = kKT + 4;   // query-major row stride in words (16-byte rows)
constexpr int kQLdT = kBQ + 2;  // k-major row stride in words (8-byte rows)
constexpr int kALd = kKT / 4 + 4;   // digit row stride in words (16 + 4 padding)

// shared memory of one block: a ring of kStages raw stages (queries, lo,
// and hi when PACK > 0) and the digit tile of the current stage
template <int PACK>
struct MmaSmem {
  static constexpr int kQBytes = (kBQ * kQLd > kKT * kQLdT ? kBQ * kQLd : kKT * kQLdT) * 4;
  static constexpr int kPlaneBytes = kKT * kPlaneLd;
  static constexpr int kStageBytes = kQBytes + kPlaneBytes * (PACK != 0 ? 2 : 1);
  static constexpr int kDigitBytes = 4 * kBQ * kALd * 4;
  static constexpr int kBytes = kStages * kStageBytes + kDigitBytes;
};

// 4 x 4 byte transpose: out[j] byte r = in[r] byte j
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The k order inside one k32 mma step (helpers in mma_common.cuh):
// ldmatrix_t4 is given the raw plane rows in order, so fragment word
// (half, t) of the k-major operands holds the plane rows 16 half + 2t +
// {0, 1, 8, 9}. The order of k in a product is free as long as both
// operands agree, and the query digits are built here, so they are
// staged in that order.

template <int PACK, int QL>
__global__ void __launch_bounds__(kMmaThreads, 2)
respond_mma_kernel(const uint32_t* __restrict__ q, int64_t nq, int64_t sq, int64_t sk,
                   const int8_t* __restrict__ lo, const uint8_t* __restrict__ hi, int64_t m,
                   int64_t c_pad, int64_t pc, int64_t rows_per_split, uint32_t* __restrict__ out,
                   int64_t ld_out) {
  using Smem = MmaSmem<PACK>;
  constexpr int kHiDigits = PACK != 0 ? 3 : 0;
  extern __shared__ __align__(16) uint8_t smem[];
  auto q_raw = [&](int slot) {
    return reinterpret_cast<uint32_t(*)[kQLd]>(smem + slot * Smem::kStageBytes);
  };
  auto q_raw_t = [&](int slot) {
    return reinterpret_cast<uint32_t(*)[kQLdT]>(smem + slot * Smem::kStageBytes);
  };
  auto lo_raw = [&](int slot) { return smem + slot * Smem::kStageBytes + Smem::kQBytes; };
  auto hi_raw = [&](int slot) {
    return smem + slot * Smem::kStageBytes + Smem::kQBytes + Smem::kPlaneBytes;
  };
  auto a_s = reinterpret_cast<uint32_t(*)[kBQ][kALd]>(smem + kStages * Smem::kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t c0 = (int64_t)blockIdx.y * kBN;
  const int64_t k_begin = (int64_t)blockIdx.z * rows_per_split;
  const int64_t k_end = min(m, k_begin + rows_per_split);
  const int nstages = (int)((k_end - k_begin + kKT - 1) / kKT);

  // plane copies: 64 rows x 8 chunks of 16 bytes, 4 per thread, all in
  // this thread's chunk (tid & 7); the hi bytes of a chunk's 16 columns
  // lie in one field block
  const int chunk = tid & 7;
  int64_t hi_ld = 0, hi_col = 0;
  int shift_unused = 0;
  if (PACK != 0) hi_geometry<PACK>(c0 + chunk * 16, c_pad, pc, &hi_ld, &hi_col, &shift_unused);
  // the field shift of each of this warp's two chunks, for the unpack
  int shift[2] = {0, 0};
  if (PACK > 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      shift[h] = (int)((c0 + (warp * 2 + h) * 16) / pc) * Fields<PACK>::kBits;
  }

  // this thread's plane rows: (tid >> 3) + 16 i of each stage
  const int64_t plane_step = (int64_t)(kMmaThreads / 8) * c_pad;
  const int64_t hi_step = (int64_t)(kMmaThreads / 8) * hi_ld;

  auto issue = [&](int s) {
    const int slot = s % kStages;
    const int64_t k0 = k_begin + (int64_t)s * kKT;
    const bool full = k0 + kKT <= k_end;  // every row of the stage is in the split
    if (QL == kQRows) {
      uint32_t(*qs)[kQLd] = q_raw(slot);
#pragma unroll
      for (int i = 0; i < kBQ * kKT / 4 / kMmaThreads; ++i) {
        const int e = tid + i * kMmaThreads;
        const int qq = e >> 4, kk = (e & 15) * 4;
        const int64_t qi = q0 + qq, k = k0 + kk;
        const int words = qi < nq ? (int)max((int64_t)0, min((int64_t)4, k_end - k)) : 0;
        cp_async16n(&qs[qq][kk], words ? q + qi * sq + k : q, 4 * words);
      }
    } else if (QL == kQCols) {
      uint32_t(*qt)[kQLdT] = q_raw_t(slot);
#pragma unroll
      for (int i = 0; i < kBQ * kKT / 2 / kMmaThreads; ++i) {
        const int e = tid + i * kMmaThreads;
        const int kk = e >> 3, qq = (e & 7) * 2;
        const int64_t qi = q0 + qq, k = k0 + kk;
        const int words = k < k_end ? (int)max((int64_t)0, min((int64_t)2, nq - qi)) : 0;
        cp_async8n(&qt[kk][qq], words ? q + qi + k * sk : q, 4 * words);
      }
    } else {
      uint32_t(*qs)[kQLd] = q_raw(slot);
#pragma unroll
      for (int i = 0; i < kBQ * kKT / kMmaThreads; ++i) {
        const int e = tid + i * kMmaThreads;
        // neighbouring threads copy neighbouring words along whichever
        // query stride is unit
        const int qq = sk == 1 ? e / kKT : e % kBQ;
        const int kk = sk == 1 ? e % kKT : e / kBQ;
        const int64_t qi = q0 + qq, k = k0 + kk;
        const bool ok = qi < nq && k < k_end;
        cp_async4(&qs[qq][kk], ok ? q + qi * sq + k * sk : q, ok);
      }
    }
    const int row0 = tid >> 3;
    const int8_t* lo_src = lo + (k0 + row0) * c_pad + c0 + chunk * 16;
    const uint8_t* hi_src = PACK != 0 ? hi + (k0 + row0) * hi_ld + hi_col : nullptr;
#pragma unroll
    for (int i = 0; i < kKT * 8 / kMmaThreads; ++i) {
      const int row = row0 + i * (kMmaThreads / 8);
      const bool ok = full || k0 + row < k_end;
      cp_async16(lo_raw(slot) + row * kPlaneLd + chunk * 16, ok ? lo_src + i * plane_step : lo, ok);
      if (PACK != 0)
        cp_async16(hi_raw(slot) + row * kPlaneLd + chunk * 16, ok ? hi_src + i * hi_step : hi, ok);
    }
  };

  int32_t acc_lo[4][4][4];  // [digit][n8 tile: chunk h, parity p -> 2h + p][fragment]
  int32_t acc_hi[kHiDigits > 0 ? 3 : 1][4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc_lo[d][n][f] = 0;
#pragma unroll
  for (int d = 0; d < (kHiDigits > 0 ? 3 : 1); ++d)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc_hi[d][n][f] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    const int slot = s % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed for all; stage s - 1 is consumed
    if (s + kStages - 1 < nstages) issue(s + kStages - 1);
    cp_async_commit();

    // query words -> balanced digits, k-major, in the k order of the mma
    // steps: 2 units (query, fragment word) per thread
    {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + i * kMmaThreads;
        const int qq = u >> 4, w = u & 15;
        const int k = (w >> 3) * 32 + ((w >> 2) & 1) * 16 + 2 * (w & 3);
        uint32_t x[4];
        if (QL == kQCols) {
          uint32_t(*qt)[kQLdT] = q_raw_t(slot);
          x[0] = qt[k][qq];
          x[1] = qt[k + 1][qq];
          x[2] = qt[k + 8][qq];
          x[3] = qt[k + 9][qq];
        } else {
          uint32_t(*qs)[kQLd] = q_raw(slot);
          const uint2 x01 = *reinterpret_cast<const uint2*>(&qs[qq][k]);
          const uint2 x89 = *reinterpret_cast<const uint2*>(&qs[qq][k + 8]);
          x[0] = x01.x;
          x[1] = x01.y;
          x[2] = x89.x;
          x[3] = x89.y;
        }
        uint32_t dgt[4], dk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) dgt[j] = (x[j] + 0x80808080u) ^ 0x80808080u;
        transpose4(dgt, dk);  // dk[digit] = that digit of the 4 k
#pragma unroll
        for (int d = 0; d < 4; ++d) a_s[d][qq][w] = dk[d];
      }
    }
    __syncthreads();

    // every plane fragment of the stage first: the ldmatrix results are in
    // flight together instead of each one stalling the mma that follows it
    const uint8_t* lo_t = lo_raw(slot);
    const uint8_t* hi_t = hi_raw(slot);
    uint32_t rl[kKT / 32][2][4], rh[kKT / 32][2][4];
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {
      const int row = ks * 32 + 8 * (lane >> 3) + (lane & 7);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cb = (warp * 2 + h) * 16;
        ldmatrix_t4(rl[ks][h], lo_t + row * kPlaneLd + cb);
        if (PACK != 0) ldmatrix_t4(rh[ks][h], hi_t + row * kPlaneLd + cb);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {
      const int w0 = ks * 8 + t;
      uint32_t a[4][4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        a[d][0] = a_s[d][g][w0];
        a[d][1] = a_s[d][g + 8][w0];
        a[d][2] = a_s[d][g][w0 + 4];
        a[d][3] = a_s[d][g + 8][w0 + 4];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4], b[2][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = rl[ks][h][j] ^ 0x80808080u;  // biased int8 -> u8
        split_columns(r, b[0], b[1]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int d = 0; d < 4; ++d) mma_s8u8(acc_lo[d][2 * h + p], a[d], b[p][0], b[p][1]);
        if (PACK != 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) r[j] = (rh[ks][h][j] >> shift[h]) & Fields<PACK>::kRep;
          split_columns(r, b[0], b[1]);
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int d = 0; d < kHiDigits; ++d) mma_s8u8(acc_hi[d][2 * h + p], a[d], b[p][0], b[p][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // n8 tile 2h + p, fragment f: query g (f < 2) or g + 8; n index 2t + (f & 1)
  // is column 2n + p of chunk h
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int64_t qi = q0 + g + (f >= 2 ? 8 : 0);
      if (qi >= nq) continue;
      uint32_t v = 0u;
#pragma unroll
      for (int d = 0; d < 4; ++d) v += (uint32_t)acc_lo[d][n][f] << (8 * d);
#pragma unroll
      for (int d = 0; d < kHiDigits; ++d) v += (uint32_t)acc_hi[d][n][f] << (8 * (d + 1));
      const int col = (warp * 2 + (n >> 1)) * 16 + 2 * (2 * t + (f & 1)) + (n & 1);
      atomicAdd(out + qi * ld_out + c0 + col, v);
    }
  }
}

template <int PACK>
cudaError_t launch_scan(const uint32_t* q, int64_t nq, int64_t sq, int64_t sk, const int8_t* lo,
                        const uint8_t* hi, int64_t m, int64_t c_pad, int64_t pc, int64_t splits,
                        int64_t rows_per_split, int threads, int lanes, uint32_t* out,
                        int64_t ld_out, cudaStream_t stream) {
  const int64_t groups = c_pad / kScanCols;
  const dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)splits, (unsigned)nq);
  const size_t bytes = (size_t)lanes * kScanCols * threads * sizeof(uint32_t);
  respond_scan_kernel<PACK><<<grid, dim3(threads, lanes), bytes, stream>>>(
      q, sq, sk, lo, hi, m, c_pad, pc, rows_per_split, out, ld_out);
  return cudaGetLastError();
}

template <int PACK, int QL>
cudaError_t launch_mma(const uint32_t* q, int64_t nq, int64_t sq, int64_t sk, const int8_t* lo,
                       const uint8_t* hi, int64_t m, int64_t c_pad, int64_t pc, int64_t splits,
                       int64_t rows_per_split, uint32_t* out, int64_t ld_out, cudaStream_t stream) {
  const int bytes = MmaSmem<PACK>::kBytes;  // above the 48 KB a launch gets unasked
  const cudaError_t attr = cudaFuncSetAttribute(
      respond_mma_kernel<PACK, QL>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((nq + kBQ - 1) / kBQ), (unsigned)(c_pad / kBN), (unsigned)splits);
  respond_mma_kernel<PACK, QL><<<grid, kMmaThreads, bytes, stream>>>(
      q, nq, sq, sk, lo, hi, m, c_pad, pc, rows_per_split, out, ld_out);
  return cudaGetLastError();
}

// the widest query copy the strides and the alignment allow
template <int PACK>
cudaError_t launch_mma_layout(const uint32_t* q, int64_t nq, int64_t sq, int64_t sk,
                              const int8_t* lo, const uint8_t* hi, int64_t m, int64_t c_pad,
                              int64_t pc, int64_t splits, int64_t rows_per_split, uint32_t* out,
                              int64_t ld_out, cudaStream_t s) {
  const uintptr_t addr = (uintptr_t)q;
  if (sk == 1 && sq % 4 == 0 && addr % 16 == 0)
    return launch_mma<PACK, kQRows>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
  if (sq == 1 && sk % 2 == 0 && addr % 8 == 0)
    return launch_mma<PACK, kQCols>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
  return launch_mma<PACK, kQAny>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
}

}  // namespace

// Both entry points accumulate Q . D into out (nq rows of ld_out u32 words;
// the first c_pad columns are written). Q element (i, k) is q[i * sq + k *
// sk]; only rows k < m of the planes are read. lo is (>= m, c_pad) int8, hi
// is (>= m, pc) uint8 (pc = c_pad / pack, or c_pad when pack == 1) or null
// when pack == 0; both 16-byte aligned, c_pad % 128 == 0. The rows are split
// into `splits` ranges of rows_per_split. Each launches on `stream` and
// returns the launch status.

// Scan regime: blocks of `threads` column groups x `lanes` row lanes
// (threads x lanes <= 512), one query per grid.z slice.
extern "C" int respond_packed_scan_launch(const uint32_t* q, int64_t nq, int64_t sq, int64_t sk,
                                          const int8_t* lo, const uint8_t* hi, int64_t m,
                                          int64_t c_pad, int64_t pc, int pack, int64_t splits,
                                          int64_t rows_per_split, int threads, int lanes,
                                          uint32_t* out, int64_t ld_out, void* stream) {
  if (nq <= 0 || m <= 0 || c_pad <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pack) {
    case 0: return (int)launch_scan<0>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, threads, lanes, out, ld_out, s);
    case 1: return (int)launch_scan<1>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, threads, lanes, out, ld_out, s);
    case 2: return (int)launch_scan<2>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, threads, lanes, out, ld_out, s);
    case 4: return (int)launch_scan<4>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, threads, lanes, out, ld_out, s);
    case 8: return (int)launch_scan<8>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, threads, lanes, out, ld_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tensor-core regime: rows_per_split a multiple of 64 and at most 65,536.
extern "C" int respond_packed_mma_launch(const uint32_t* q, int64_t nq, int64_t sq, int64_t sk,
                                         const int8_t* lo, const uint8_t* hi, int64_t m,
                                         int64_t c_pad, int64_t pc, int pack, int64_t splits,
                                         int64_t rows_per_split, uint32_t* out, int64_t ld_out,
                                         void* stream) {
  if (nq <= 0 || m <= 0 || c_pad <= 0) return (int)cudaSuccess;
  if (rows_per_split % kKT || rows_per_split > 65536) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pack) {
    case 0: return (int)launch_mma_layout<0>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
    case 1: return (int)launch_mma_layout<1>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
    case 2: return (int)launch_mma_layout<2>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
    case 4: return (int)launch_mma_layout<4>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
    case 8: return (int)launch_mma_layout<8>(q, nq, sq, sk, lo, hi, m, c_pad, pc, splits, rows_per_split, out, ld_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
