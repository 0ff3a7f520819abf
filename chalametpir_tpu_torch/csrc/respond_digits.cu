// Digit-layout packed respond kernel:
//   out_lo[r, c] += sum_k qd(r, k) * lo[k, c]                  r < qd_rows
//   out_hi[r, c] += sum_k qd(r, k) * field(hi, k, c)           r < qh_rows
// in int32 with wraparound (mod 2^32), where qd holds int8 query digits,
// lo is the biased int8 low-byte plane (read as signed int8) and field()
// the high field of the packed hi plane (ops/packed.py): PACK fields of
// 8/PACK bits per byte, block-interleaved (field j of packed byte t is
// column j*pc + t), read exactly as respond_packed.cu reads them; PACK = 1
// bytes are read as int8 and PACK = 0 means no hi plane.
// qh_rows = qd_rows - qd_rows / 4.
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
// Bound: device memory. A scan reads every plane byte once; its 32 + 24
// int8 multiply-adds per plane element are a sixth of the bytes' time on
// the int8 tensor cores, so what the design has to keep up is bytes in
// flight, not the product rate.
//
// Products: `mma.sync.m16n8k32`, s8 digits x s8 lo (and PACK 1 bytes), s8
// x u8 for the fields of PACK 2/4/8, s32 accumulators. The digit rows are
// the M side: a block owns 32 digit rows (two m16 tiles) and every warp
// multiplies both tiles with its own 32 columns. Digits on M because they
// are what every warp shares, so one A fragment load serves 8 products,
// and because the wide side of the work (columns) then sits on N, where a
// warp's tile can be any multiple of 8. The second m16 tile meets hi with 8
// idle rows (24 of 32 digit rows carry a hi product); the time is the
// memory's, so they cost nothing.
//
// Operands: both int8 operands are K-major. The digits are K-major in
// memory in both layouts; the planes are row-major with row = k. A ring of
// kStages stages of 64 plane rows in shared memory is filled by cp.async,
// 16 bytes a copy: the raw digit rows (32 x 64 bytes), the raw lo rows and
// the raw hi bytes, three stages in flight while one is multiplied. The A
// fragments are `ldmatrix` on the raw digit rows, so their k order is the
// natural one (word t of a half step = k 4t .. 4t + 3). The B fragments are
// `ldmatrix.trans` on the raw plane rows, which hands a lane two rows of
// each 8-row matrix; to make those rows k 4t .. 4t + 3 too, the copies put
// plane row k of each 16 into slot (k & 1) + 2 (k >> 2) + 8 ((k >> 1) & 1)
// of shared memory, and the matrices are read from consecutive slots:
// the transposition is free in the copy's destination address, and the
// 2-D and the 3-D digit layouts differ only in the source addresses of
// the 128 digit copies of a stage.
//
// Columns: a block of W warps owns 32 W columns. For PACK > 1 these are
// the columns of F of the PACK fields of the hi bytes [h0, h0 + w), w = 32
// W / F: columns j pc + h0 + [0, w) for F adjacent j. With F = PACK a block
// needs every hi byte it reads in full, so the hi plane is read once, and
// the lo plane in runs of w bytes; with fewer fields a block the runs are
// longer and PACK / F blocks, neighbours in the grid, read the same hi
// bytes (once from device memory, then from the L2). kernels.py picks W and
// F per plane geometry from what diag/digits_sweep.py measured. For PACK
// <= 1 the columns are a run of 32 W adjacent ones. A chunk of 16 columns
// past the planes' width (c_pad not a multiple of the block's width) is
// neither copied nor multiplied.
//
// The TPU walks its m-tiles in order into one output block; here blocks run
// in parallel over row splits, digit-row groups the fastest grid dimension
// and column blocks the next (so the blocks that share digits and plane
// rows run together), and the partial sums meet in the outputs through u32
// atomicAdd (associative mod 2^32: bit-identical in any order), a row of
// 16 adjacent columns at a time. The grid is whole rounds of the card's
// block slots (kernels.digit_geometry), so no SM is a block behind. A split is
// at most 65,536 rows, so |partial| <= 65,536 x 128 x 255 < 2^31 and no s32
// accumulator overflows. The outputs are accumulated into, so the caller
// zeroes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kRows = 32;           // digit rows per block: two m16 tiles
constexpr int kKT = 64;             // plane rows per stage: two k32 steps
constexpr int kStages = 4;          // stages in flight (cp.async ring)
constexpr int kDigitLd = kKT + 16;  // digit row stride in bytes: ldmatrix rows hit 8 bank groups
constexpr int kSumLd = 33;          // row stride in words of a warp's 32 x 32 sums in the epilogue
constexpr int kMaxSplitRows = 1 << 16;

// shared-memory geometry, in bytes, of a block of `warps` warps that owns
// `fields` of the PACK fields of its hi bytes
struct Tile {
  int cols;    // lo columns of the block
  int hi_w;    // hi bytes per row of the block
  int lo_ld;   // row strides: an odd number of 16-byte groups each
  int hi_ld;
  int stage;   // one stage: digits, lo rows, hi rows
};

__host__ __device__ inline Tile tile_of(int pack, int warps, int fields) {
  Tile t;
  t.cols = 32 * warps;
  t.hi_w = pack > 1 ? t.cols / fields : t.cols;
  t.lo_ld = t.cols + 16;
  t.hi_ld = t.hi_w + ((t.hi_w / 16) % 2 ? 32 : 16);
  t.stage = kRows * kDigitLd + kKT * t.lo_ld + (pack ? kKT * t.hi_ld : 0);
  return t;
}

// shared-memory slot of plane row k (0..63) of a stage
__device__ __forceinline__ int slot_of(int k) {
  return (k & 48) | (((k >> 1) & 1) << 3) | (((k >> 2) & 3) << 1) | (k & 1);
}

template <int PACK>
__global__ void __launch_bounds__(kMaxWarps * 32)
respond_digits_kernel(const int8_t* __restrict__ qd, int64_t qd_rows, int64_t tile_k,
                      int64_t tile_stride, int64_t row_stride, const int8_t* __restrict__ lo,
                      const uint8_t* __restrict__ hi, int64_t m, int64_t c_pad, int64_t pc,
                      int64_t rows_per_split, int fields, uint32_t* __restrict__ out_lo,
                      uint32_t* __restrict__ out_hi) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const Tile tile = tile_of(PACK, warps, fields);
  const int w = tile.hi_w;  // columns of one field that the block owns
  // width of one field block of the planes: column j * seg + x, x < seg
  const int64_t seg = PACK > 1 ? pc : c_pad;
  // the PACK / fields blocks that share hi bytes are neighbours in the grid
  const int sharers = PACK > 1 ? PACK / fields : 1;
  const int64_t h0 = (int64_t)(blockIdx.y / sharers) * w;
  const int j0 = (int)(blockIdx.y % sharers) * fields;  // the block's first field
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t qh_rows = qd_rows - qd_rows / 4;
  const int64_t k_begin = (int64_t)blockIdx.z * rows_per_split;
  const int64_t k_end = min(m, k_begin + rows_per_split);
  const int nstages = (int)((k_end - k_begin + kKT - 1) / kKT);
  // which of the block's two m16 tiles have rows that meet hi
  const bool hi_mt[2] = {PACK != 0 && r0 < qh_rows, PACK != 0 && r0 + 16 < qh_rows};
  const bool with_hi = hi_mt[0];

  auto digit_raw = [&](int slot) { return smem + slot * tile.stage; };
  auto lo_raw = [&](int slot) { return smem + slot * tile.stage + kRows * kDigitLd; };
  auto hi_raw = [&](int slot) {
    return smem + slot * tile.stage + kRows * kDigitLd + kKT * tile.lo_ld;
  };

  // -- this thread's copies of a stage ---------------------------------------
  // lo: 64 rows x 2 W chunks of 16 bytes; rows (tid / 2W) + 16 i, one chunk
  const int lo_chunk = tid % (2 * warps), lo_row0 = tid / (2 * warps);
  const int lo_s = 16 * lo_chunk;  // the chunk's column in the block's tile
  const bool lo_ok = h0 + lo_s % w < seg;
  const int64_t lo_col = (int64_t)(j0 + lo_s / w) * seg + h0 + lo_s % w;
  const int lo_dst = slot_of(lo_row0) * tile.lo_ld + lo_s;
  // hi: 64 rows x w / 16 chunks; rows (tid / chunks) + hi_step i
  const int hi_chunks = w / 16;
  const int hi_chunk = tid % hi_chunks, hi_row0 = tid / hi_chunks;
  const int hi_step = nthreads / hi_chunks;  // rows a pass: 16 per field of the block
  const bool hi_ok = with_hi && h0 + 16 * hi_chunk < seg;
  const int64_t hi_col = h0 + 16 * hi_chunk;
  // digits: 32 rows x 4 chunks, the first 128 threads
  const int dg_row = tid >> 2, dg_chunk = tid & 3;
  const bool dg_ok = tid < kRows * 4;
  // the digits of stage s start at k_begin + 64 s: tile and offset within it
  int64_t dg_kk = k_begin % tile_k;
  const int8_t* dg_src = qd + (k_begin / tile_k) * tile_stride + (r0 + dg_row) * row_stride +
                         16 * dg_chunk;

  auto copy_stage = [&](int s) {  // called with s = 0, 1, 2, ... in order
    const int slot = s % kStages;
    const int64_t k0 = k_begin + (int64_t)s * kKT;
    if (dg_ok) {
      const bool ok = k0 + 16 * dg_chunk < k_end;  // m and the splits are multiples of 16
      cp_async16(digit_raw(slot) + dg_row * kDigitLd + 16 * dg_chunk, ok ? dg_src + dg_kk : qd, ok);
    }
    dg_kk += kKT;
    if (dg_kk >= tile_k) {  // tile_k is a multiple of 64: no stage straddles tiles
      dg_kk = 0;
      dg_src += tile_stride;
    }
    if (lo_ok) {
      const int8_t* src = lo + (k0 + lo_row0) * c_pad + lo_col;
      uint8_t* dst = lo_raw(slot) + lo_dst;
#pragma unroll
      for (int i = 0; i < kKT / 16; ++i) {
        const bool ok = k0 + lo_row0 + 16 * i < k_end;
        cp_async16(dst + 16 * i * tile.lo_ld, ok ? src + (int64_t)16 * i * c_pad : lo, ok);
      }
    }
    if (PACK != 0 && hi_ok) {
      for (int row = hi_row0; row < kKT; row += hi_step) {
        const bool ok = k0 + row < k_end;
        cp_async16(hi_raw(slot) + slot_of(row) * tile.hi_ld + 16 * hi_chunk,
                   ok ? hi + (k0 + row) * seg + hi_col : hi, ok);
      }
    }
  };

  // -- this warp's two chunks of 16 columns ----------------------------------
  bool ok[2];
  int hi_s[2], shift[2];
  int64_t col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = 32 * warp + 16 * h;
    ok[h] = h0 + s % w < seg;
    hi_s[h] = s % w;
    shift[h] = PACK > 1 ? (j0 + s / w) * Fields<PACK>::kBits : 0;
    col[h] = (int64_t)(j0 + s / w) * seg + h0 + s % w;
  }

  int32_t acc_lo[2][4][4];  // [m16 tile][n8 tile: chunk h, parity p -> 2h + p][fragment]
  int32_t acc_hi[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc_lo[mt][n][f] = acc_hi[mt][n][f] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) copy_stage(s);
    cp_async_commit();
  }
  // lane 8j + i names row i of ldmatrix's matrix j
  const int a_off = ((lane >> 3 & 1) * 8 + (lane & 7)) * kDigitLd + (lane >> 4) * 16;
  const int b_row = 8 * (lane >> 3) + (lane & 7);
  for (int s = 0; s < nstages; ++s) {
    const int slot = s % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed for all; stage s - 1 is consumed
    if (s + kStages - 1 < nstages) copy_stage(s + kStages - 1);
    cp_async_commit();

    const uint8_t* dg_t = digit_raw(slot);
    const uint8_t* lo_t = lo_raw(slot);
    const uint8_t* hi_t = hi_raw(slot);
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {
      // every fragment of the step first, so the loads are in flight together
      uint32_t a[2][4], rl[2][4], rh[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix4(a[mt], dg_t + mt * 16 * kDigitLd + a_off + ks * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        ldmatrix_t4(rl[h], lo_t + (ks * 32 + b_row) * tile.lo_ld + 32 * warp + 16 * h);
        if (PACK != 0 && with_hi)
          ldmatrix_t4(rh[h], hi_t + (ks * 32 + b_row) * tile.hi_ld + hi_s[h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        uint32_t b[2][2];
        split_columns(rl[h], b[0], b[1]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_s8s8(acc_lo[mt][2 * h + p], a[mt], b[p][0], b[p][1]);
        if (PACK != 0 && with_hi) {
          uint32_t r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            r[j] = PACK > 1 ? (rh[h][j] >> shift[h]) & Fields<PACK>::kRep : rh[h][j];
          split_columns(r, b[0], b[1]);
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (!hi_mt[mt]) continue;
              if (PACK == 1) mma_s8s8(acc_hi[mt][2 * h + p], a[mt], b[p][0], b[p][1]);
              else mma_s8u8(acc_hi[mt][2 * h + p], a[mt], b[p][0], b[p][1]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring; each now takes a piece of it

  // The warp's 32 x 32 sums go through shared memory, so that each atomic
  // instruction adds 2 x 16 adjacent columns of one row (4 sectors) and not
  // 8 rows x 4 separate columns. n8 tile 2h + p, fragment f: digit row g
  // (f < 2) or g + 8 of the m16 tile; n index 2t + (f & 1) is column 2n + p
  // of chunk h.
  uint32_t* sum_lo = reinterpret_cast<uint32_t*>(smem) + warp * (PACK != 0 ? 2 : 1) * kRows * kSumLd;
  uint32_t* sum_hi = sum_lo + kRows * kSumLd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int at = (16 * mt + g + (f >= 2 ? 8 : 0)) * kSumLd + 16 * (n >> 1) +
                       2 * (2 * t + (f & 1)) + (n & 1);
        sum_lo[at] = (uint32_t)acc_lo[mt][n][f];
        if (PACK != 0) sum_hi[at] = (uint32_t)acc_hi[mt][n][f];
      }
  __syncwarp();
  const int h = lane >> 4;
  if (!(h ? ok[1] : ok[0])) return;
  const int64_t c = (h ? col[1] : col[0]) + (lane & 15);
  for (int row = 0; row < kRows; ++row) {
    const int64_t r = r0 + row;
    atomicAdd(out_lo + r * c_pad + c, sum_lo[row * kSumLd + lane]);
    if (PACK != 0 && r < qh_rows) atomicAdd(out_hi + r * c_pad + c, sum_hi[row * kSumLd + lane]);
  }
}

template <int PACK>
cudaError_t launch(const int8_t* qd, int64_t qd_rows, int64_t tile_k, int64_t tile_stride,
                   int64_t row_stride, const int8_t* lo, const uint8_t* hi, int64_t m,
                   int64_t c_pad, int64_t pc, int64_t splits, int64_t rows_per_split, int warps,
                   int fields, uint32_t* out_lo, uint32_t* out_hi, cudaStream_t stream) {
  const Tile tile = tile_of(PACK, warps, fields);
  const int bytes = kStages * tile.stage;  // above the 48 KB a launch gets unasked
  const cudaError_t attr = cudaFuncSetAttribute(
      respond_digits_kernel<PACK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int64_t seg = PACK > 1 ? pc : c_pad;
  const int64_t sharers = PACK > 1 ? PACK / fields : 1;
  const dim3 grid((unsigned)(qd_rows / kRows),
                  (unsigned)((seg + tile.hi_w - 1) / tile.hi_w * sharers), (unsigned)splits);
  respond_digits_kernel<PACK><<<grid, warps * 32, bytes, stream>>>(
      qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, rows_per_split, fields,
      out_lo, out_hi);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of `warps` warps that owns `fields`
// fields at this pack, in bytes (what kernels.digit_geometry computes on
// the host).
extern "C" int respond_digits_smem_bytes(int pack, int warps, int fields) {
  return kStages * tile_of(pack, warps, fields).stage;
}

// Accumulates the digit products into out_lo (qd_rows x c_pad) and, when
// pack > 0, out_hi (qh_rows x c_pad), both contiguous u32. qd(r, k) is
// qd[(k / tile_k) * tile_stride + r * row_stride + k % tile_k] for k < m;
// qd, both strides and the planes are 16-byte aligned, m is a multiple of
// 16, tile_k of 64 (for the 2-D layout: any multiple of 64 >= m, with
// tile_stride 0) and qd_rows of 32; c_pad is a multiple of 128. lo is
// (>= m, c_pad) int8, hi (>= m, pc) uint8 (pc = c_pad / pack, or c_pad when
// pack == 1) or null when pack == 0. The rows are split into `splits`
// ranges of rows_per_split (a multiple of 64, at most 65,536); a block has
// `warps` warps (1..16) and owns 32 warps columns: `fields` of the pack
// fields (a divisor of pack; 1 when pack <= 1) of 32 warps / fields hi
// bytes, a multiple of 16. Launches on `stream`; returns the launch status.
extern "C" int respond_digits_launch(const int8_t* qd, int64_t qd_rows, int64_t tile_k,
                                     int64_t tile_stride, int64_t row_stride, const int8_t* lo,
                                     const uint8_t* hi, int64_t m, int64_t c_pad, int64_t pc,
                                     int pack, int64_t splits, int64_t rows_per_split, int warps,
                                     int fields, uint32_t* out_lo, uint32_t* out_hi,
                                     void* stream) {
  if (qd_rows <= 0 || m <= 0 || c_pad <= 0) return (int)cudaSuccess;
  if (warps < 1 || warps > kMaxWarps || fields < 1 || (pack <= 1 ? fields != 1 : pack % fields) ||
      32 * warps % (16 * fields) ||
      rows_per_split % kKT || rows_per_split > kMaxSplitRows || tile_k % kKT || m % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pack) {
    case 0: return (int)launch<0>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, fields, out_lo, out_hi, s);
    case 1: return (int)launch<1>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, fields, out_lo, out_hi, s);
    case 2: return (int)launch<2>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, fields, out_lo, out_hi, s);
    case 4: return (int)launch<4>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, fields, out_lo, out_hi, s);
    case 8: return (int)launch<8>(qd, qd_rows, tile_k, tile_stride, row_stride, lo, hi, m, c_pad, pc, splits, rows_per_split, warps, fields, out_lo, out_hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
