"""Digit-layout packed respond: the TPU's int8 digit formulation of respond.

Counterpart of the Pallas kernels that multiply int8 query digits with
the packed planes: `_kernel_lo_only` / `_kernel_with_hi`
(chalametpir_tpu/ops/respond_pallas.py), which read the digits in the
strided 2-D layout (qd_rows, m_pad), and the scan diagnostics' copies of
them that read a tile-contiguous 3-D layout (n_tiles, qd_rows, tile_k):
`_kernel_q3d` (scripts/diag_scan_qdlayout.py), `_k3d_lo` and `_k3d_hi`
(scripts/diag_scan_qdsweep.py). All compute

    out_lo = qd . lo      out_hi = qd[:qh_rows] . hi_fields   (int32, wrapping)

with lo the biased int8 low bytes and hi_fields the high fields unpacked
from the block-interleaved hi plane (pack == 1: the bytes read as int8),
qh_rows = qd_rows - qd_rows // 4 (the rows of digits 0..2).

`respond_digits` is the wrapper: the hand-written kernel
(csrc/respond_digits.cu) for planes on a CUDA device, the plain version
`respond_digits_ref` only for planes on the CPU. The layout is read from
the rank of qd. The server keeps the u32 respond (ops/respond_packed.py);
this path serves the scan diagnostic (diag/scan_qd.py) and holds the two
formulations against each other (`respond_batch_digits`).
"""

from __future__ import annotations

import torch

from .. import kernels
from .digits import NUM_U32_DIGITS, combine, prepare_query_digits
from .respond_packed import _REF_CHUNK_ROWS, M_ALIGN, PackedPlanes, _wrap_i32, hi_fields, pack_geometry

LAYOUTS = ("2d", "3d")


def to_3d(qd2: torch.Tensor, tile_k: int = M_ALIGN) -> torch.Tensor:
    """(qd_rows, m_pad) digits -> (n_tiles, qd_rows, tile_k), materialised:
    a permuted view would read the same memory as the 2-D layout."""
    rows, m_pad = qd2.shape
    if m_pad % tile_k:
        raise ValueError(f"m_pad {m_pad} is not a multiple of tile_k {tile_k}")
    return qd2.reshape(rows, m_pad // tile_k, tile_k).permute(1, 0, 2).contiguous()


def _as_2d(qd: torch.Tensor) -> torch.Tensor:
    if qd.dim() == 2:
        return qd
    n_tiles, rows, tile_k = qd.shape
    return qd.permute(1, 0, 2).reshape(rows, n_tiles * tile_k)


def qh_rows_of(qd_rows: int) -> int:
    """Digit rows that meet the hi plane: 3Q of the 4Q digit rows."""
    return qd_rows - qd_rows // NUM_U32_DIGITS


def respond_digits_ref(qd, lo, hi, pack: int):
    """Plain version of the digit kernel: (out_lo (qd_rows, c_pad), out_hi
    (qh_rows, c_pad) or None) int32. Products are taken in float64 over
    row chunks, where every partial sum (< 2^17 * 2^14) is exact, and
    wrapped mod 2^32 after each chunk."""
    qd2 = _as_2d(qd)
    rows, m = qd2.shape
    qh = qh_rows_of(rows)
    c_pad = lo.shape[1]
    acc_lo = torch.zeros((rows, c_pad), dtype=torch.int64, device=lo.device)
    acc_hi = torch.zeros((qh, c_pad), dtype=torch.int64, device=lo.device) if pack else None
    for r0 in range(0, m, _REF_CHUNK_ROWS):
        r1 = min(m, r0 + _REF_CHUNK_ROWS)
        qf = qd2[:, r0:r1].to(torch.float64)
        acc_lo = (acc_lo + (qf @ lo[r0:r1].to(torch.float64)).to(torch.int64)) & 0xFFFFFFFF
        if pack:
            # pack == 1 bytes are read as int8, as the TPU kernels cast them
            h = hi[r0:r1].view(torch.int8) if pack == 1 else hi_fields(hi[r0:r1], pack)
            acc_hi = (acc_hi + (qf[:qh] @ h.to(torch.float64)).to(torch.int64)) & 0xFFFFFFFF
    return _wrap_i32(acc_lo), _wrap_i32(acc_hi) if pack else None


def respond_digits(qd, lo, hi, pack: int):
    """(qd_rows, m) or (n_tiles, qd_rows, tile_k) int8 digits x planes ->
    (out_lo, out_hi or None) int32, the shapes of the TPU kernels' outputs.
    Runs the kernel for planes on CUDA, the plain version for planes on the
    CPU, and raises for any other device."""
    device = lo.device
    if qd.device != device:
        raise ValueError(f"digits on {qd.device}, planes on {device}")
    if device.type == "cpu":
        return respond_digits_ref(qd, lo, hi, pack)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    rows = qd.shape[-2]
    c_pad = lo.shape[1]
    # both outputs in one buffer: one fill kernel zeroes them
    out = torch.zeros((rows + (qh_rows_of(rows) if pack else 0), c_pad), dtype=torch.int32, device=device)
    out_lo, out_hi = out[:rows], out[rows:] if pack else None
    kernels.respond_digits(qd, lo, hi, pack, out_lo, out_hi)
    return out_lo, out_hi


def respond_batch_digits(queries, db: PackedPlanes, layout: str = "3d") -> torch.Tensor:
    """(Q, m) int32 u32-bit queries x PackedPlanes -> (Q, c) int32 bits
    through the digit formulation: digits, the digit kernel on the chosen
    layout, then the recombination. Equals respond_packed.respond_batch_packed."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    q, m = queries.shape
    if m != db.num_rows:
        raise ValueError(f"query length {m} != DB rows {db.num_rows}")
    pack, _, _ = pack_geometry(db.mat_elem_bit_len, db.lo.shape[1])
    qd, sums = prepare_query_digits(queries, db.lo.shape[0])
    if layout == "3d":
        qd = to_3d(qd)
    out_lo, out_hi = respond_digits(qd, db.lo, db.hi, pack)
    return combine(out_lo, out_hi, sums, q, db.num_cols)
