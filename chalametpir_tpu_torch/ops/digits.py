"""Balanced base-256 digits of u32 query words, and their recombination.

Counterpart of chalametpir_tpu/ops/digits.py (`recode_u32_jnp`) and of the
glue around the JAX package's Pallas respond kernels
(ops/respond_pallas.py `_prepare_query_digits`, `_combine`). A u32 x is
four digits c_i in [-128, 127] with x == sum_i c_i * 256^i (mod 2^32), so
a mod-2^32 product with the packed planes becomes int8 digit products
whose int32 partials are shifted and summed.

The port's serving respond multiplies whole u32 words and needs none of
this (csrc/respond_packed.cu); the digit form feeds the digit-layout
respond kernel (ops/respond_digits.py), which reproduces what the TPU
kernels compute. u32 words travel as int32 tensors holding the same bits;
every right shift is masked, since torch's >> is arithmetic.
"""

from __future__ import annotations

import torch

from .respond_packed import _wrap_i32

NUM_U32_DIGITS = 4
DIGIT_ROW_ALIGN = 32  # digit rows are padded to a multiple of this


def recode_u32(x: torch.Tensor) -> torch.Tensor:
    """(...) int32 holding u32 bits -> (4, ...) int8 balanced digits."""
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32 holding u32 bits, got {x.dtype}")
    digits = []
    carry = torch.zeros_like(x)
    for i in range(NUM_U32_DIGITS):
        tb = ((x >> (8 * i)) & 255) + carry + 128
        digits.append(((tb & 255) - 128).to(torch.int8))
        carry = tb >> 8  # tb is in [128, 384]: no sign bits to mask
    return torch.stack(digits)


def prepare_query_digits(queries: torch.Tensor, m_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, m) int32 u32-bit queries -> digit-major (4Q padded to 32, m_pad)
    int8 rows (row d * Q + q holds digit d of query q; padding rows and the
    columns m..m_pad hold 0) and the (4, Q) int64 digit sums that undo the
    planes' bias of 128."""
    q, m = queries.shape
    if m > m_pad:
        raise ValueError(f"query length {m} > m_pad {m_pad}")
    qd = recode_u32(queries)  # (4, Q, m)
    sums = qd.sum(dim=2, dtype=torch.int64)
    rows = -(-NUM_U32_DIGITS * q // DIGIT_ROW_ALIGN) * DIGIT_ROW_ALIGN
    qd_pad = torch.zeros((rows, m_pad), dtype=torch.int8, device=queries.device)
    qd_pad[: NUM_U32_DIGITS * q, :m] = qd.reshape(NUM_U32_DIGITS * q, m)
    return qd_pad, sums


def combine(out_lo: torch.Tensor, out_hi: torch.Tensor | None, sums: torch.Tensor,
            q: int, c: int) -> torch.Tensor:
    """Digit products -> (Q, c) int32 u32 bits: undo the bias, shift each
    digit's partials into place and sum mod 2^32. out_lo holds the digit
    rows times the biased low bytes, out_hi the first three digits' rows
    times the high fields (None for b <= 8)."""
    p_lo = out_lo[: NUM_U32_DIGITS * q, :c].to(torch.int64).reshape(NUM_U32_DIGITS, q, c)
    p_lo = p_lo + (sums * 128)[:, :, None]
    acc = p_lo[0]
    for i in range(1, NUM_U32_DIGITS):
        acc = acc + (p_lo[i] << (8 * i))
    if out_hi is not None:
        p_hi = out_hi[: 3 * q, :c].to(torch.int64).reshape(3, q, c)
        for i in range(3):
            acc = acc + (p_hi[i] << (8 * (i + 1)))
    return _wrap_i32(acc)
