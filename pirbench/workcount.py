"""Frozen work counts of the respond kernel at a call's shapes.

The least time one NVIDIA H100 SXM could take for one respond of nq
queries over the packed planes: the planes, the queries and the answers
moved once at the card's published 3.35 TB/s, or the int8 digit products
at its published dense 1,979 TOP/s (NVIDIA's data sheet, 700 W), the
larger. The planes' size follows from the DB's geometry as the packed
layout stores it: an int8 lo plane of (m_pad, c_pad) and, for b > 8, a hi
plane holding the high bits of `pack` values per byte.
"""

from __future__ import annotations

CARD_BYTES_PER_S = 3.35e12
CARD_INT8_OPS_PER_S = 1.979e15
LANE = 128  # c_pad is a multiple of this
M_ALIGN = 2048  # m_pad is a multiple of this


def _round_up(x: int, step: int) -> int:
    return -(-x // step) * step


def plane_geometry(m: int, c: int, b: int) -> dict:
    """m_pad, c_pad and the bytes of the lo and hi planes of an (m, c)
    D with b-bit elements."""
    m_pad, c_pad = _round_up(m, M_ALIGN), _round_up(c, LANE)
    hi_bits = max(0, b - 8)
    pack = 0 if hi_bits == 0 else 8 if hi_bits == 1 else 4 if hi_bits == 2 else 2 if hi_bits <= 4 else 1
    hi_cols = c_pad // pack if pack else 0
    return {"m": m, "c": c, "b": b, "m_pad": m_pad, "c_pad": c_pad,
            "plane_bytes": m_pad * c_pad + m_pad * hi_cols}


def bound_ms(nq: int, m: int, c_pad: int, plane_bytes: int, b: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one respond of nq queries:
    the planes and queries read once and the output written once, or 2
    operations per int8 multiply-add of the 7 (b > 8) or 4 digit rows a
    query takes."""
    moved = plane_bytes + 4 * nq * m + 4 * nq * c_pad
    digit_rows = 7 if b > 8 else 4
    by_bytes = moved / CARD_BYTES_PER_S * 1e3
    by_ops = 2 * digit_rows * nq * m * c_pad / CARD_INT8_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
