"""Exact mod-2^32 matrix products through balanced int8 digits.

Counterpart of chalametpir_tpu/ops/matmul_u32.py, the arithmetic of the
digit2 layout:

    A (R,K) u32, D (K,C) u32 with D < 2^14, D = d0 + 256 d1:
    M = sum_{i<4, j<2, i+j<=3} (A_i . D_j) << 8(i+j)   (mod 2^32)

The JAX functions compute their int8 products with `lax.dot_general`
outside any kernel; here they are `torch._int_mm`, on the CPU and on CUDA
alike. What that call asks for is met here:

* on CUDA it wants more than 16 rows on the left and K and C multiples of
  8. Each product zero-pads its digit rows to `MIN_ROWS`; planes are padded
  on the fly when they must be, which copies them, so a caller that keeps
  planes (the server) pads them once with `pad_plane` and cuts the answer;
* the JAX code leans on int32 accumulators that wrap over the whole K.
  One product over K rows can reach 2^14 K, past 2^31 from K = 2^17, and
  whether a library's accumulators wrap is nothing to rest exactness on:
  K is cut in pieces of at most `K_SPLIT` rows (128 * 128 * 65,536 = 2^30)
  and the int32 partials are added with torch's `+`, which wraps.

u32 words travel as int32 tensors holding the same bits; `<<` on int32
wraps, so every dropped carry is a multiple of 2^32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .digits import NUM_U32_DIGITS, recode_u32

K_SPLIT = 1 << 16  # rows of K per product: every int32 partial stays below 2^31
MIN_ROWS = 32  # _int_mm on CUDA needs more than 16 rows on the left
PLANE_ALIGN = 8  # and K and C multiples of this


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def pad_plane(plane: torch.Tensor) -> torch.Tensor:
    """A (K, C) int8 plane with zero rows and columns up to multiples of
    PLANE_ALIGN, the shape `torch._int_mm` takes on CUDA; the plane itself
    when it already has it. Zero rows and columns add nothing."""
    k, c = plane.shape
    k_pad, c_pad = _round_up(k, PLANE_ALIGN), _round_up(c, PLANE_ALIGN)
    if (k_pad, c_pad) == (k, c):
        return plane
    return F.pad(plane, (0, c_pad - c, 0, k_pad - k))


def _dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, K) int8 x (K, C) int8 -> (R, C) int32, exact mod 2^32: K in
    pieces of K_SPLIT rows, the partials summed with a wrapping `+`. On
    CUDA the operands are zero-padded to the shapes _int_mm takes."""
    r, k = a.shape
    c = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"product of {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cuda":
        b = pad_plane(b)
        rows = max(MIN_ROWS, _round_up(r, PLANE_ALIGN))
        if (rows, b.shape[0]) != (r, k):
            a = F.pad(a, (0, b.shape[0] - k, 0, rows - r))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    for k0 in range(0, a.shape[1], K_SPLIT):
        acc += torch._int_mm(a[:, k0 : k0 + K_SPLIT], b[k0 : k0 + K_SPLIT])
    return acc[:r, :c]


def _matmul_digits(x: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """x (R, K) int32 u32 bits times D = d0 + 256 d1 -> (R, C) int32 bits:
    all four digits of x against d0 in one product (digit-major rows, row
    i * R + r digit i of row r), the first three against d1 in another
    (the fourth would shift out of the word). The planes may carry zero
    rows past K: the digits are zero there too."""
    r, k = x.shape
    if d0.shape != d1.shape or d0.shape[0] < k:
        raise ValueError(f"{k} columns against planes {tuple(d0.shape)} and {tuple(d1.shape)}")
    c = d0.shape[1]
    xd = torch.zeros((NUM_U32_DIGITS * r, d0.shape[0]), dtype=torch.int8, device=x.device)
    xd[:, :k] = recode_u32(x).reshape(NUM_U32_DIGITS * r, k)
    p0 = _dot_i8(xd, d0).reshape(NUM_U32_DIGITS, r, c)
    p1 = _dot_i8(xd[: 3 * r], d1).reshape(3, r, c)
    out = p0[0].clone()
    for i in range(1, NUM_U32_DIGITS):
        out += p0[i] << (8 * i)
    for i in range(NUM_U32_DIGITS - 1):
        out += p1[i] << (8 * (i + 1))
    return out


def digit_matmul_accumulate(acc: torch.Tensor, a_u32: torch.Tensor, d0: torch.Tensor,
                            d1: torch.Tensor) -> torch.Tensor:
    """acc (R, C) int32 + A_chunk (R, Kc) u32 bits . [d0|d1] (Kc, C) int8,
    mod 2^32, as a new tensor.

    The chunked form lets the caller stream A from the host XOF without
    ever holding the full (R, K) matrix on the device. The planes may
    carry zero rows past Kc (see `pad_plane`)."""
    return acc + _matmul_digits(a_u32, d0, d1)


def matmul_u32_x_db(a_u32: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """One-shot A (R, K) u32 bits . D (K, C), D given as its digit planes."""
    return _matmul_digits(a_u32, d0, d1)


def digit_matmul_full(a_digits: torch.Tensor, b_digits: torch.Tensor, out_rows: int) -> torch.Tensor:
    """General u32 x u32 product from the full 4-digit planes of both
    sides, a_digits (4, R, K) and b_digits (4, K, C) int8:
    sum_{i+j<=3} (A_i . B_j) << 8(i+j), for right-hand sides not bounded
    by 2^14 (the protocol's own products all have a narrow side; this is
    the general form). -> (out_rows, C) int32 u32 bits."""
    acc = torch.zeros((out_rows, b_digits.shape[-1]), dtype=torch.int32, device=a_digits.device)
    for i in range(NUM_U32_DIGITS):
        for j in range(NUM_U32_DIGITS - i):
            acc += _dot_i8(a_digits[i], b_digits[j]) << (8 * (i + j))
    return acc


def matmul_u32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host reference: exact (a @ b) mod 2^32 via uint64 wrap-around."""
    if a.shape[-1] != b.shape[0]:
        from ..errors import IncompatibleDimensionForMatrixMultiplication

        raise IncompatibleDimensionForMatrixMultiplication()
    return (a.astype(np.uint64) @ b.astype(np.uint64)).astype(np.uint32)
