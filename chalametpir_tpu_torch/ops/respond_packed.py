"""Respond and hint fold over the packed DB planes.

Counterpart of chalametpir_tpu/ops/respond_pallas.py. The planes keep the
JAX package's byte layout exactly (ops/packed.py describes it on the
host; its `hi_bits` and `hi_pack_factor` are re-exported here): lo (m_pad, c_pad) int8
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

from .. import kernels
from ..native import engine
from .digits import NUM_U32_DIGITS, _wrap_i32  # noqa: F401  (NUM_U32_DIGITS re-exported, as in the JAX package)
from .packed import hi_bits, hi_pack_factor  # noqa: F401  (re-exported: their old home)
from .serving import ServingState

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
class PackedPlanes(ServingState):
    """Device-resident packed DB, in the kernel's layout; the packed
    layout's serving state (ops/serving.py)."""

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

    @property
    def c_pad(self) -> int:
        return self.lo.shape[1]

    def respond(self, queries_u32: torch.Tensor) -> torch.Tensor:
        return respond_batch_packed(queries_u32, self)

    def fold_rows(self, a_block: torch.Tensor, out_rows: torch.Tensor) -> None:
        """Accumulated in the kernel: out_rows is (r, c_pad)."""
        respond_packed_core(a_block, self.lo, self.hi, self.mat_elem_bit_len, self.num_cols, out=out_rows)

    def archive(self) -> dict:
        # tile_k: the planes' row alignment
        arrays = dict(lo=self.lo.cpu().numpy(), tile_k=np.array([M_ALIGN]))
        if self.hi is not None:
            arrays["hi"] = self.hi.cpu().numpy()
        return arrays

    @classmethod
    def from_archive(cls, archive, mat_elem_bit_len: int, num_rows: int, num_cols: int,
                     device: torch.device) -> "PackedPlanes":
        lo = archive["lo"]
        if lo.ndim != 2 or lo.shape[0] < num_rows or lo.shape[1] < num_cols:
            raise ValueError(f"archive planes {lo.shape} do not cover {num_rows} x {num_cols}")
        hi = archive["hi"] if "hi" in archive else None
        return cls(torch.from_numpy(lo).to(device), None if hi is None else torch.from_numpy(hi).to(device),
                   mat_elem_bit_len, num_rows, num_cols)


def build_packed_db(mat: np.ndarray, mat_elem_bit_len: int, device,
                    m_align: int = M_ALIGN) -> PackedPlanes:
    """(m, c) uint16/uint32 encoded DB -> packed planes on `device`, built
    by the native host engine's one-pass packer, m padded to a multiple of
    `m_align`."""
    m, c = mat.shape
    m_pad = _round_up(m, m_align)
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


def balanced_digits(queries: torch.Tensor) -> torch.Tensor:
    """(Q, m) int32 u32 bits -> (4, Q, m) int64 balanced digits in
    [-128, 127], x == sum_d D_d 256^d (mod 2^32): byte d of
    (x + 0x80808080) ^ 0x80808080, read as int8, as the tensor-core regime
    computes them in registers."""
    x = queries.to(torch.int64) & 0xFFFFFFFF
    d = ((x + 0x80808080) & 0xFFFFFFFF) ^ 0x80808080
    return torch.stack([(((d >> (8 * i)) & 255) ^ 128) - 128 for i in range(4)])


def respond_packed_mma_arith(queries, lo, hi, mat_elem_bit_len: int, num_cols: int,
                             split_rows: int = kernels.MMA_MAX_SPLIT_ROWS) -> torch.Tensor:
    """The tensor-core regime's arithmetic in plain torch, for the tests:
    per split of `split_rows` rows, the s32 products of the 4 balanced
    digits with the u8 low bytes (lo ^ 0x80) and of digits 0-2 with the hi
    fields, each checked to fit in int32 as the kernel's accumulators must,
    scaled by 2^(8d) and summed mod 2^32. Equals respond_packed_ref."""
    q, m = queries.shape
    digits = balanced_digits(queries)
    pack, _, _ = pack_geometry(mat_elem_bit_len, lo.shape[1])
    acc = torch.zeros((q, num_cols), dtype=torch.int64, device=queries.device)
    for r0 in range(0, m, split_rows):
        r1 = min(m, r0 + split_rows)
        terms = [(lo[r0:r1, :num_cols].to(torch.int64) + 128, range(4), 0)]
        if hi is not None:
            terms.append((hi_fields(hi[r0:r1], pack)[:, :num_cols].to(torch.int64), range(3), 8))
        for plane, ds, shift in terms:
            for d in ds:
                part = digits[d][:, r0:r1] @ plane
                if part.numel() and not -(1 << 31) <= int(part.min()) <= int(part.max()) < 1 << 31:
                    raise OverflowError("a split's digit product leaves int32")
                acc = (acc + ((part & 0xFFFFFFFF) << (8 * d + shift))) & 0xFFFFFFFF
    return _wrap_i32(acc)


def respond_packed_core(queries_u32, lo, hi, mat_elem_bit_len: int, num_cols: int, out=None):
    """(Q, m) int32 queries x planes -> (Q, num_cols) int32 u32 bits.

    With `out` ((Q, >= c_pad) int32), the product is ADDED into out and
    out is returned: the hint fold accumulates every chunk into one
    buffer. Runs the kernel for planes on CUDA, the plain version for
    planes on the CPU, and raises for any other device. The JAX
    package's `tile_k` and `interpret` are not taken: the kernel picks its
    own geometry (kernels.choose_regime), and the CPU runs the plain
    version."""
    device = lo.device
    if queries_u32.device != device:
        raise ValueError(f"queries on {queries_u32.device}, planes on {device}")
    if device.type == "cpu":
        res = respond_packed_ref(queries_u32, lo, hi, mat_elem_bit_len, num_cols)
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
        out = torch.zeros((queries_u32.shape[0], lo.shape[1]), dtype=torch.int32, device=device)
    kernels.respond_packed(queries_u32, lo, hi, pack, out)
    return out[:, :num_cols] if fresh else out


def respond_batch_packed(queries_u32, db: PackedPlanes) -> torch.Tensor:
    """(Q, m) int32 u32-bit queries x PackedPlanes -> (Q, c) int32 bits."""
    if queries_u32.shape[1] != db.num_rows:
        raise ValueError(f"query length {queries_u32.shape[1]} != DB rows {db.num_rows}")
    return respond_packed_core(queries_u32, db.lo, db.hi, db.mat_elem_bit_len, db.num_cols)


def hint_fold_partial(g, lo, hi, mat_elem_bit_len: int, num_cols: int, out=None):
    """One hint chunk fold A[:, chunk] . D[chunk] over packed planes.

    g: (k, cc) int32, A's columns of the chunk with LWE rows as rows, as
    in the JAX package (any k: its zero-padded 1792 rows give zero rows of
    the result). The ctr generator emits the chunk fingerprint-major, (cc,
    k): pass its transposed view, `slab.t()`, which the kernel reads as
    it lies, with no copy. lo/hi: the planes of the same cc DB rows.
    Returns (k, num_cols), or accumulates into `out`. All k rows fold in
    one launch: the JAX package's `rgroup` row groups (and its `tile_k`
    and `interpret`) only fit the TPU's VMEM and are not taken."""
    return respond_packed_core(g, lo, hi, mat_elem_bit_len, num_cols, out=out)
