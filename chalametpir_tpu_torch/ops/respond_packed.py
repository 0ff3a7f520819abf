"""Respond and hint fold over the packed DB planes.

Counterpart of chalametpir_tpu/ops/respond_pallas.py. The planes keep the
JAX package's byte layout exactly (ops/packed.py): lo (m_pad, c_pad) int8
holds (el & 255) - 128, hi (m_pad, pc) uint8 holds el >> 8 packed
block-interleaved, or is None for b <= 8. Padded rows and columns hold
lo = -128, i.e. value zero, so they add nothing for any query — the ctr
hint fold multiplies nonzero A values against padded rows.

`respond_packed_core` is the wrapper: the hand-written kernel
(csrc/respond_packed.cu) for planes on a CUDA device, the plain version
`respond_packed_ref` only for planes on the CPU. u32 values travel as
int32 tensors holding the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from chalametpir_tpu.ops.packed import hi_bits, hi_pack_factor

from .. import kernels

LANE = 128  # c_pad is a multiple of this (the JAX package's lane width)
# the JAX package's default tile: rows are padded to whole tiles, so the
# two packages build byte-identical planes
M_ALIGN = 2048


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_geometry(b: int, c_pad: int) -> tuple[int, int, int]:
    """(pack, bits, pc) for element width b: values per hi byte (0 = no
    hi plane), bits per field, and packed hi words per row."""
    pack = hi_pack_factor(b) if hi_bits(b) > 0 else 0
    bits = (8 // pack if pack > 1 else 8) if pack else 0
    pc = (c_pad // pack if pack > 1 else c_pad) if pack else 0
    return pack, bits, pc


@dataclass
class PackedPlanes:
    """Device-resident packed DB, in the kernel's layout."""

    lo: torch.Tensor  # (m_pad, c_pad) int8, biased low bytes
    hi: torch.Tensor | None  # (m_pad, pc) uint8, block-interleaved, or None
    mat_elem_bit_len: int
    num_rows: int  # logical m
    num_cols: int  # logical c

    @property
    def device(self) -> torch.device:
        return self.lo.device

    @property
    def device_bytes(self) -> int:
        return self.lo.numel() + (self.hi.numel() if self.hi is not None else 0)


def build_packed_db(mat: np.ndarray, mat_elem_bit_len: int, device) -> PackedPlanes:
    """(m, c) uint16/uint32 encoded DB -> packed planes on `device`, built
    by the native host engine's one-pass packer."""
    from chalametpir_tpu.native import engine

    m, c = mat.shape
    m_pad = _round_up(m, M_ALIGN)
    c_pad = _round_up(c, LANE)
    pack, bits, _ = pack_geometry(mat_elem_bit_len, c_pad)
    if mat.dtype == np.uint16:
        # the engine's padded uint16 path leaves padding columns 0 (value
        # 128); pack tight and pad with -128 like the JAX package does
        lo_tight, hi = engine.build_packed_planes(mat, m_pad, c_pad, pack, bits, tight_lo=True)
        lo = np.full((m_pad, c_pad), -128, np.int8)
        lo[:m, :c] = lo_tight
    else:
        lo, hi = engine.build_packed_planes(mat, m_pad, c_pad, pack, bits)
    device = torch.device(device)
    return PackedPlanes(
        torch.from_numpy(lo).to(device),
        torch.from_numpy(hi).to(device) if hi is not None else None,
        mat_elem_bit_len, m, c,
    )


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 tensor holding their low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def hi_fields(hi: torch.Tensor, pack: int) -> torch.Tensor:
    """(rows, pc) uint8 hi plane -> (rows, c_pad) int32 fields in natural
    column order (pack == 1: the bytes themselves)."""
    h = hi.to(torch.int32)
    if pack == 1:
        return h
    # field j of word t is column j*pc + t: concatenate the field blocks
    bits = 8 // pack
    return torch.cat([(h >> (bits * j)) & ((1 << bits) - 1) for j in range(pack)], dim=1)


def unpack_elements(lo: torch.Tensor, hi: torch.Tensor | None, b: int) -> torch.Tensor:
    """(rows, c_pad) int32 element values el = (lo + 128) + (hi << 8)."""
    el = lo.to(torch.int32) + 128
    if hi is None:
        return el
    pack, _, _ = pack_geometry(b, lo.shape[1])
    return el + (hi_fields(hi, pack) << 8)


# rows per float64 product: each term is < 2^16 * 2^14, so partial sums of
# up to 2^23 rows stay exact below 2^53; 2^17 also bounds the temporaries
_REF_CHUNK_ROWS = 1 << 17


def respond_packed_ref(queries, lo, hi, mat_elem_bit_len: int, num_cols: int) -> torch.Tensor:
    """Plain version of the respond kernel: (Q, m) int32 u32-bit queries x
    planes -> (Q, num_cols) int32 u32 bits. Each query word is split into
    16-bit halves whose products with el are exact in float64 (on the CPU
    and on CUDA alike, where there is no int64 matmul), then recombined
    mod 2^32."""
    q, m = queries.shape
    q64 = queries.to(torch.int64) & 0xFFFFFFFF
    halves = [(q64 & 0xFFFF).to(torch.float64), (q64 >> 16).to(torch.float64)]
    acc = torch.zeros((q, num_cols), dtype=torch.int64, device=queries.device)
    for r0 in range(0, m, _REF_CHUNK_ROWS):
        r1 = min(m, r0 + _REF_CHUNK_ROWS)
        el = unpack_elements(lo[r0:r1], hi[r0:r1] if hi is not None else None, mat_elem_bit_len)
        el = el[:, :num_cols].to(torch.float64)
        p_lo = (halves[0][:, r0:r1] @ el).to(torch.int64)
        p_hi = (halves[1][:, r0:r1] @ el).to(torch.int64)
        acc = (acc + p_lo + ((p_hi & 0xFFFF) << 16)) & 0xFFFFFFFF
    return _wrap_i32(acc)


def respond_packed_core(queries, lo, hi, mat_elem_bit_len: int, num_cols: int, out=None):
    """(Q, m) int32 queries x planes -> (Q, num_cols) int32 u32 bits.

    With `out` ((Q, >= c_pad) int32), the product is ADDED into out and
    out is returned: the hint fold accumulates every chunk into one
    buffer. Runs the kernel for planes on CUDA, the plain version for
    planes on the CPU, and raises for any other device."""
    device = lo.device
    if queries.device != device:
        raise ValueError(f"queries on {queries.device}, planes on {device}")
    if device.type == "cpu":
        res = respond_packed_ref(queries, lo, hi, mat_elem_bit_len, num_cols)
        if out is None:
            return res
        c = num_cols
        out[:, :c] = _wrap_i32(out[:, :c].to(torch.int64) + res.to(torch.int64))
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    pack, _, _ = pack_geometry(mat_elem_bit_len, lo.shape[1])
    fresh = out is None
    if fresh:
        out = torch.zeros((queries.shape[0], lo.shape[1]), dtype=torch.int32, device=device)
    kernels.respond_packed(queries, lo, hi, pack, out)
    return out[:, :num_cols] if fresh else out


def respond_batch_packed(queries, db: PackedPlanes) -> torch.Tensor:
    """(Q, m) int32 u32-bit queries x PackedPlanes -> (Q, c) int32 bits."""
    if queries.shape[1] != db.num_rows:
        raise ValueError(f"query length {queries.shape[1]} != DB rows {db.num_rows}")
    return respond_packed_core(queries, db.lo, db.hi, db.mat_elem_bit_len, db.num_cols)


def hint_fold_partial(a_slab, lo, hi, mat_elem_bit_len: int, num_cols: int, out=None):
    """One hint chunk fold A[:, chunk] . D[chunk] over packed planes.

    a_slab: (cc, k) int32, A's fingerprint columns of the chunk as the ctr
    generator emits them (a_slab[j] = A[:, r0 + j]); lo/hi: the planes of
    the same cc DB rows. Returns (k, num_cols), or accumulates into `out`.
    All k rows fold in one launch, read fingerprint-major through a
    transposed view — the JAX package's 128-row groups and explicit
    transpose only fit the TPU's VMEM."""
    return respond_packed_core(a_slab.t(), lo, hi, mat_elem_bit_len, num_cols, out=out)
