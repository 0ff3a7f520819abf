"""The digit2 respond: encrypted queries times the encoded DB, mod 2^32.

Counterpart of chalametpir_tpu/ops/respond.py. The DB is two int8 digit
planes (2 bytes per element, ops/digits.py `db_digit_planes_np`) and each
query's four balanced digits multiply them:

    out[c] = sum_k q[k] * D[k, c]
           = sum_{i<4} 2^{8i} (q_i . D_0)[c] + sum_{i<3} 2^{8(i+1)} (q_i . D_1)[c]

A batch of Q queries is one (4Q, m) x (m, C) int8 product and one
(3Q, m) x (m, C). In the JAX package these are `lax.dot_general` calls
outside any kernel, so here they are `torch._int_mm` (ops/matmul_u32.py
says what that call needs and how exactness is kept). The packed layout
(ops/respond_packed.py) is the one the port serves by default, at every
element width; digit2 is kept for callers that ask for it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .digits import NUM_U32_DIGITS, db_digit_planes_np  # noqa: F401  (NUM_U32_DIGITS re-exported, as in the JAX package)
from .matmul_u32 import PLANE_ALIGN, _matmul_digits, _round_up

# rows per host recode of build_digit_planes: bounds the uint32 temporaries
_BUILD_CHUNK_ROWS = 1 << 16


@dataclass
class DigitPlanes:
    """The encoded DB on a device as its two digit planes, D = d0 + 256 d1,
    zero-padded in both dimensions to multiples of PLANE_ALIGN."""

    d0: torch.Tensor  # (m_pad, c_pad) int8 in [-128, 127]
    d1: torch.Tensor  # (m_pad, c_pad) int8 in [0, 64]
    mat_elem_bit_len: int
    num_rows: int  # logical m
    num_cols: int  # logical c

    @property
    def device(self) -> torch.device:
        return self.d0.device

    @property
    def device_bytes(self) -> int:
        return self.d0.numel() + self.d1.numel()


def _zero_planes(m: int, c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (_round_up(m, PLANE_ALIGN), _round_up(c, PLANE_ALIGN))
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device))


def build_digit_planes(mat: np.ndarray, mat_elem_bit_len: int, device) -> DigitPlanes:
    """(m, c) uint16/uint32 encoded DB -> DigitPlanes on `device`: the
    planes of `db_digit_planes_np`, recoded on the host a chunk of rows at
    a time and copied into zeroed device planes."""
    m, c = mat.shape
    d0, d1 = _zero_planes(m, c, torch.device(device))
    for r0 in range(0, m, _BUILD_CHUNK_ROWS):
        p0, p1 = db_digit_planes_np(mat[r0 : r0 + _BUILD_CHUNK_ROWS])
        d0[r0 : r0 + p0.shape[0], :c] = torch.from_numpy(p0)
        d1[r0 : r0 + p1.shape[0], :c] = torch.from_numpy(p1)
    return DigitPlanes(d0, d1, mat_elem_bit_len, m, c)


def digit_planes_from_host(p0: np.ndarray, p1: np.ndarray, mat_elem_bit_len: int, device) -> DigitPlanes:
    """DigitPlanes on `device` from the (m, c) int8 planes an archive holds."""
    m, c = p0.shape
    d0, d1 = _zero_planes(m, c, torch.device(device))
    d0[:m, :c] = torch.from_numpy(np.ascontiguousarray(p0, np.int8))
    d1[:m, :c] = torch.from_numpy(np.ascontiguousarray(p1, np.int8))
    return DigitPlanes(d0, d1, mat_elem_bit_len, m, c)


def respond_batch(queries_u32: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """(Q, m) int32 u32-bit queries x digit-plane DB -> (Q, C) int32 u32
    bits. The planes may carry zero rows past m (`matmul_u32.pad_plane`)."""
    return _matmul_digits(queries_u32, d0, d1)


def respond_batch_np(queries_u32: np.ndarray, db_u32: np.ndarray) -> np.ndarray:
    """Host reference path: (Q, m) x (m, C) mod 2^32 via uint64 wrap."""
    return (queries_u32.astype(np.uint64) @ db_u32.astype(np.uint64)).astype(np.uint32)
