"""Bit-packed DB layouts for the bandwidth-bound respond scan.

The port's copy of chalametpir_tpu/ops/packed.py (numpy only): the host
description of the packed layout whose device planes
ops/respond_packed.py serves.

    element el < 2^b:   el = (lo - 128) + 128 + 256 * hi
      lo_biased = (el & 255) - 128   -> full int8 plane
      hi        = el >> 8            -> small values, bit-packed:
                     b <= 8 : hi == 0, plane omitted        (1.00 B/elem)
                     b == 9 : hi in {0,1},   8 per byte     (1.125 B/elem)
                     b == 10: hi in {0,..,3}, 4 per byte    (1.25 B/elem)
                     b <= 12: hi in [0,15],   2 per byte    (1.50 B/elem)
                     b <= 14: hi in [0,63],   1 per byte    (2.00 B/elem)

Hi-plane packing is column-block interleaved: field j of packed word t
holds logical column j*pc + t (pc = packed words per row), so unpacking
(shift and mask each field, then concatenate the field blocks along the
columns) restores natural column order with no gather. `pack_db` packs at
the logical width c; the serving planes (respond_packed.build_packed_db,
the native build_packed_planes) pad the columns to 128 first, so their pc
comes from the padded width.

The bias trick uses `el & 255`, not a balanced digit, so `hi` here is the
plain high byte, unlike digits.db_digit_planes_np.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def hi_bits(mat_elem_bit_len: int) -> int:
    """Bits needed for the high byte el >> 8."""
    return max(0, mat_elem_bit_len - 8)


def hi_pack_factor(mat_elem_bit_len: int) -> int:
    """High-plane values packed per byte (a power of two; 0: no hi plane)."""
    hb = hi_bits(mat_elem_bit_len)
    if hb == 0:
        return 0
    if hb == 1:
        return 8
    if hb == 2:
        return 4
    if hb <= 4:
        return 2
    return 1


@dataclass
class PackedDB:
    """Host description of a packed encoded DB."""

    lo_biased: np.ndarray  # (m, c) int8: (el & 255) - 128
    hi_packed: np.ndarray | None  # (m, ceil(c / pack)) uint8 or None
    mat_elem_bit_len: int
    num_rows: int  # m
    num_cols: int  # c (unpadded logical columns)

    @property
    def bytes_per_element(self) -> float:
        total = self.lo_biased.size + (self.hi_packed.size if self.hi_packed is not None else 0)
        return total / (self.num_rows * self.num_cols)


def pack_db(mat: np.ndarray, mat_elem_bit_len: int) -> PackedDB:
    """(m, c) uint32 with elements < 2^b -> PackedDB."""
    mat = np.asarray(mat, np.uint32)
    m, c = mat.shape
    lo = ((mat & np.uint32(255)).astype(np.int16) - 128).astype(np.int8)
    hb = hi_bits(mat_elem_bit_len)
    if hb == 0:
        return PackedDB(lo, None, mat_elem_bit_len, m, c)
    hi = (mat >> np.uint32(8)).astype(np.uint8)
    pack = hi_pack_factor(mat_elem_bit_len)
    if pack == 1:
        return PackedDB(lo, hi, mat_elem_bit_len, m, c)
    bits = 8 // pack
    pc = -(-c // pack)
    padded = np.zeros((m, pc * pack), np.uint8)
    padded[:, :c] = hi
    # block interleave: field j of word t <- logical column j*pc + t
    packed = padded[:, :pc].copy()
    for j in range(1, pack):
        packed |= padded[:, j * pc : (j + 1) * pc] << np.uint8(bits * j)
    return PackedDB(lo, packed, mat_elem_bit_len, m, c)


def unpack_hi(packed: np.ndarray, mat_elem_bit_len: int, num_cols: int) -> np.ndarray:
    """Inverse of the hi-plane packing (testing helper) -> (m, c) uint8."""
    pack = hi_pack_factor(mat_elem_bit_len)
    if pack == 0:
        return np.zeros((packed.shape[0] if packed is not None else 0, num_cols), np.uint8)
    if pack == 1:
        return packed[:, :num_cols]
    bits = 8 // pack
    mask = np.uint8((1 << bits) - 1)
    m, pc = packed.shape
    out = np.empty((m, pc * pack), np.uint8)
    for j in range(pack):
        out[:, j * pc : (j + 1) * pc] = (packed >> np.uint8(bits * j)) & mask
    return out[:, :num_cols]


def unpack_db(db: PackedDB) -> np.ndarray:
    """Full inverse (testing helper) -> (m, c) uint32."""
    lo = db.lo_biased.astype(np.int32) + 128
    if db.hi_packed is None:
        return lo.astype(np.uint32)
    hi = unpack_hi(db.hi_packed, db.mat_elem_bit_len, db.num_cols).astype(np.int32)
    return (lo + (hi << 8)).astype(np.uint32)
