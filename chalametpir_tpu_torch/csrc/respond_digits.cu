// Digit-layout packed respond kernel:
//   out_lo[r, c] += sum_k qd(r, k) * lo[k, c]                  r < qd_rows
//   out_hi[r, c] += sum_k qd(r, k) * field(hi, k, c)           r < qh_rows
// in int32 with wraparound (mod 2^32), where qd holds int8 query digits,
// lo is the biased int8 low-byte plane and field() the high field of the
// packed hi plane (ops/packed.py): PACK fields of 8/PACK bits per byte,
// block-interleaved (field j of packed word t is column j*pc + t), read
// exactly as respond_packed.cu reads them; PACK = 1 bytes are read as
// int8 and PACK = 0 means no hi plane. qh_rows = qd_rows - qd_rows / 4.
//
// Replaces the Pallas kernels that take the query digits in the
// tile-contiguous 3-D layout (n_tiles, qd_rows, tile_k):
// scripts/diag_scan_qdlayout.py `_kernel_q3d` / `run_q3d` (K4, PACK 0),
// scripts/diag_scan_qdsweep.py `_k3d_lo` / `run3d_lo` (K5, PACK 0) and
// `_k3d_hi` / `run3d_hi` (K6, PACK > 0). The digits are addressed through
// explicit strides, qd(r, k) = qd[(k / tile_k) * tile_stride + r * row_stride
// + k % tile_k], so the same kernel also reads the strided 2-D layout
// (qd_rows, m_pad) of chalametpir_tpu/ops/respond_pallas.py's K1/K2: the
// pair the JAX scan diagnostics compare.
//
// Bound: a scan reads every plane byte once and does qd_rows (lo) plus
// qh_rows (hi) int8 multiply-adds per element; at qd_rows = 32 that is 56
// per element, so plain CUDA-core multiply-adds would make it
// compute-bound. Design, simple first: the TPU's int8 matrix unit maps to
// dp4a here (four int8 products and an int32 add with wraparound per
// instruction). dp4a wants four consecutive k of one column in a word,
// while the planes are row-major (k, c), so each thread loads one 32-bit
// word (4 columns) from each of 4 rows and transposes the 4x4 bytes in
// registers with byte permutes: no shared memory. A warp owns 128 columns
// and 8 digit rows (8 x 4 lo and 8 x 4 hi accumulators per thread); the
// warps of a block take the next row groups of the same columns, so they
// read the same plane words, which the L1 serves after the first. Digit
// words are the same address across a warp (broadcast loads). The TPU
// walks its m-tiles in order into one output block; here blocks run in
// parallel over row splits, and their partial sums meet in the outputs
// through u32 atomicAdd (associative mod 2^32: bit-identical in any
// order). The outputs are accumulated into, so the caller zeroes them.
// A tensor-core (mma.sync s8) version is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 4;         // columns per thread
constexpr int kRowsPerWarp = 8;  // digit rows per warp
constexpr int kMaxWarps = 8;

// w[i] holds columns 0..3 of row k+i; t[c] gets rows k..k+3 of column c
__device__ __forceinline__ void transpose4x4(const uint32_t w[4], int t[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
  t[0] = (int)__byte_perm(a, c, 0x5410);
  t[1] = (int)__byte_perm(a, c, 0x7632);
  t[2] = (int)__byte_perm(b, d, 0x5410);
  t[3] = (int)__byte_perm(b, d, 0x7632);
}

template <int PACK>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
respond_digits_kernel(const int8_t* __restrict__ qd, int64_t qd_rows, int64_t tile_k,
                      int64_t tile_stride, int64_t row_stride, const int8_t* __restrict__ lo,
                      const uint8_t* __restrict__ hi, int64_t m, int64_t c_pad, int64_t pc,
                      int64_t rows_per_split, uint32_t* __restrict__ out_lo,
                      uint32_t* __restrict__ out_hi) {
  constexpr int kBits = PACK > 1 ? 8 / PACK : 8;
  constexpr uint32_t kFieldMask = ((1u << kBits) - 1u) * 0x01010101u;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t r0 = ((int64_t)blockIdx.z * (blockDim.x / kWarp) + warp) * kRowsPerWarp;
  const int64_t k_begin = (int64_t)blockIdx.y * rows_per_split;
  const int64_t k_end = min(m, k_begin + rows_per_split);
  if (r0 >= qd_rows || k_begin >= k_end) return;  // no barriers below
  // qd_rows is a multiple of 32, so a warp's 8 rows all meet hi or none do
  const bool with_hi = PACK != 0 && r0 < qd_rows - qd_rows / 4;
  const int64_t col = ((int64_t)blockIdx.x * kWarp + lane) * kCols;

  // hi plane address of this thread's 4 columns, as in respond_packed.cu
  int64_t hi_ld = 0, hi_col = 0;
  int shift = 0;
  if (PACK > 1) {
    const int64_t j = col / pc;
    hi_ld = pc;
    hi_col = col - j * pc;
    shift = (int)j * kBits;
  } else if (PACK == 1) {
    hi_ld = c_pad;
    hi_col = col;
  }

  int acc_lo[kRowsPerWarp][kCols];
  int acc_hi[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc_lo[r][i] = acc_hi[r][i] = 0;

  // k_begin and tile_k are multiples of 4, so k..k+3 never straddle tiles
  const int64_t tile = k_begin / tile_k;
  int64_t kk = k_begin - tile * tile_k;
  const int8_t* qbase = qd + tile * tile_stride + r0 * row_stride;
  for (int64_t k = k_begin; k < k_end; k += 4) {
    int qw[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      qw[r] = __ldg(reinterpret_cast<const int*>(qbase + r * row_stride + kk));
    uint32_t w[4];
    int t[kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(lo + (k + i) * c_pad + col));
    transpose4x4(w, t);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc_lo[r][i] = __dp4a(qw[r], t[i], acc_lo[r][i]);
    if (PACK != 0 && with_hi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t hw = __ldg(reinterpret_cast<const uint32_t*>(hi + (k + i) * hi_ld + hi_col));
        w[i] = PACK > 1 ? (hw >> shift) & kFieldMask : hw;
      }
      transpose4x4(w, t);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc_hi[r][i] = __dp4a(qw[r], t[i], acc_hi[r][i]);
    }
    kk += 4;
    if (kk == tile_k) {
      kk = 0;
      qbase += tile_stride;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    uint32_t* dst = out_lo + (r0 + r) * c_pad + col;
#pragma unroll
    for (int i = 0; i < kCols; ++i) atomicAdd(dst + i, (uint32_t)acc_lo[r][i]);
  }
  if (with_hi) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      uint32_t* dst = out_hi + (r0 + r) * c_pad + col;
#pragma unroll
      for (int i = 0; i < kCols; ++i) atomicAdd(dst + i, (uint32_t)acc_hi[r][i]);
    }
  }
}

template <int PACK>
cudaError_t launch(const int8_t* qd, int64_t qd_rows, int64_t tile_k, int64_t tile_stride,
                   int64_t row_stride, const int8_t* lo, const uint8_t* hi, int64_t m,
                   int64_t c_pad, int64_t pc, int64_t splits, int64_t rows_per_split, int warps,
                   uint32_t* out_lo, uint32_t* out_hi, cudaStream_t stream) {
  const int64_t groups = qd_rows / kRowsPerWarp;
  const dim3 grid((unsigned)(c_pad / (kWarp * kCols)), (unsigned)splits,
                  (unsigned)((groups + warps - 1) / warps));
  respond_digits_kernel<PACK><<<grid, warps * kWarp, 0, stream>>>(
      qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, rows_per_split, out_lo,
      out_hi);
  return cudaGetLastError();
}

}  // namespace

// Accumulates the digit products into out_lo (qd_rows x c_pad) and, when
// pack > 0, out_hi (qh_rows x c_pad), both contiguous u32. qd(r, k) is
// qd[(k / tile_k) * tile_stride + r * row_stride + k % tile_k] for k < m;
// m, tile_k and both strides are multiples of 4 and qd_rows of 32; c_pad
// is a multiple of 128. lo is (>= m, c_pad) int8, hi (>= m, pc) uint8
// (pc = c_pad / pack, or c_pad when pack == 1) or null when pack == 0.
// The rows are split into `splits` ranges of rows_per_split (a multiple of
// 4); `warps` (1..8) row groups of 8 share a block. Launches on `stream`;
// returns the launch status.
extern "C" int respond_digits_launch(const int8_t* qd, int64_t qd_rows, int64_t tile_k,
                                     int64_t tile_stride, int64_t row_stride, const int8_t* lo,
                                     const uint8_t* hi, int64_t m, int64_t c_pad, int64_t pc,
                                     int pack, int64_t splits, int64_t rows_per_split, int warps,
                                     uint32_t* out_lo, uint32_t* out_hi, void* stream) {
  if (qd_rows <= 0 || m <= 0 || c_pad <= 0) return (int)cudaSuccess;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pack) {
    case 0: return (int)launch<0>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, out_lo, out_hi, s);
    case 1: return (int)launch<1>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, out_lo, out_hi, s);
    case 2: return (int)launch<2>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, out_lo, out_hi, s);
    case 4: return (int)launch<4>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, out_lo, out_hi, s);
    case 8: return (int)launch<8>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, out_lo, out_hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
