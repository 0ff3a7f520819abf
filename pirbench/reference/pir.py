"""The plain reference of what a ChalametPIR server computes, at sampled
columns: the encoded DB D, the hint A . D and the responses q . D, all
mod 2^32 (FrodoPIR, ia.cr/2022/981; ChalametPIR, ia.cr/2024/092; the
reference implementation itzmeanjan/ChalametPIR v0.7.0).

D is built from the benchmark's own inputs: the keys and values, the
filter's seed generator and the element width b. Row e of the encoding
of a key is bits [e*b, e*b + b) of digest(key) || value || 0x81 || 0...,
and in reverse peel order each key's slot is assigned
D[slot] = enc - sum(D[other slots]) - murmur64(hash + column) mod 2^b
(reference: chalametpir_common/src/matrix.rs:633-945,
serialization.rs:22-116). A comes from either PRG: in ctr mode A[r, c]
is word c * 1774 + r of the stream whose block i is TurboSHAKE128(seed ||
LE64(i)); in stream mode, the reference's own, A[r, c] is word r * m + c
of the one TurboSHAKE128(seed) stream (matrix.rs:541-558), so its rows
are keccak.stream_rows(seed, m, rows). Nothing here
imports the program under test.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from . import fuse, keccak

LWE_DIMENSION = 1774
BOUNDARY = 0x81
FILTER_STRUCT = struct.Struct("<32sIIIQQQ")  # the 68-byte filter parameters on the wire


def element_bits(n: int) -> int:
    """The largest b with 2^32 >= 8 * 2^(2b) * floor(sqrt(n))."""
    root, b = math.isqrt(n), 0
    while (1 << 32) >= 8 * (1 << (2 * b)) * root:
        b += 1
    return b - 1


def row_width(value_len: int, b: int) -> int:
    """Columns of D (and words of a response) for values of value_len bytes."""
    return -(-(32 * 8 + value_len * 8 + 8) // b)


def wire_matrix(data: bytes) -> np.ndarray:
    """rows: u32 LE || cols: u32 LE || elements row-major as u32 LE."""
    rows, cols = struct.unpack_from("<II", data)
    if len(data) != 8 + 4 * rows * cols:
        raise ValueError("malformed matrix")
    return np.frombuffer(data, "<u4", offset=8).reshape(rows, cols)


@dataclass
class Encoding:
    params: bytes  # the filter parameters as the server must send them
    m: int  # rows of D: the filter's fingerprints
    c: int  # columns of D
    b: int
    cols: np.ndarray  # the sampled columns
    d: np.ndarray  # (m, len(cols)) uint32: D at those columns


def encode(keys: np.ndarray, values: np.ndarray, arity: int, b: int, rng: np.random.Generator,
           cols_rng: np.random.Generator, ncols: int, device) -> Encoding:
    """D at ncols columns drawn from cols_rng, for the DB of (n, key_len)
    keys and (n, value_len) values (uint8), with the filter's seeds from
    rng; the digests run on `device`."""
    n, value_len = values.shape
    c = row_width(value_len, b)
    cols = np.sort(cols_rng.choice(c, size=min(ncols, c), replace=False))
    digests = keccak.key_digests(keys, device)
    seed, (seg, seg_count_len, m), hashes, key_rows, order, codes = fuse.construct(digests, arity, rng)
    params = FILTER_STRUCT.pack(seed, arity, seg, seg_count_len, m, n, b)

    # each key's elements at the sampled columns: 3 bytes of its stream
    # from bit e*b on hold all b <= 14 bits
    stream_len = 32 + value_len + 1
    first = cols * b // 8
    shift = (cols * b % 8).astype(np.uint32)
    raw = np.zeros((n, len(cols)), np.uint32)
    digest_bytes = digests.view(np.uint8).reshape(n, 32)
    for k in range(3):
        pos = first + k
        byte = np.zeros((n, len(cols)), np.uint32)
        in_digest, in_value = pos < 32, (pos >= 32) & (pos < 32 + value_len)
        byte[:, in_digest] = digest_bytes[:, pos[in_digest]]
        byte[:, in_value] = values[:, pos[in_value] - 32]
        byte[:, pos == stream_len - 1] = BOUNDARY
        raw |= byte << np.uint32(8 * k)
    mask = np.uint32((1 << b) - 1)
    enc = (raw >> shift) & mask
    with np.errstate(over="ignore"):
        noise = (fuse.murmur64(hashes[:, None] + cols[None, :].astype(np.uint64)) & np.uint64((1 << b) - 1))
    # 32-bit lanes, one per sampled column, in one Python int per key:
    # bias + enc - noise - (arity - 1 others) stays in 0..2^32 and
    # borrows nothing from its neighbour; the bias is 0 mod 2^b
    bias = np.uint32(1 << 16)
    pre = (enc + bias - noise.astype(np.uint32)).astype("<u4")
    width = 4 * len(cols)
    pre_int = [int.from_bytes(x, "little") for x in pre.view(f"V{width}").ravel().tolist()]
    lane_mask = int.from_bytes(np.full(len(cols), mask, "<u4").tobytes(), "little")

    by_peel = key_rows[order]
    steps = np.arange(n)
    dst = by_peel[steps, codes].tolist()
    others = [by_peel[steps, (codes + j) % arity].tolist() for j in range(1, arity)]
    order_l = order.tolist()
    d = [0] * m
    if arity == 3:
        o1, o2 = others
        for i in range(n - 1, -1, -1):
            d[dst[i]] = (pre_int[order_l[i]] - d[o1[i]] - d[o2[i]]) & lane_mask
    else:
        o1, o2, o3 = others
        for i in range(n - 1, -1, -1):
            d[dst[i]] = (pre_int[order_l[i]] - d[o1[i]] - d[o2[i]] - d[o3[i]]) & lane_mask
    mat = np.frombuffer(b"".join(x.to_bytes(width, "little") for x in d), "<u4").reshape(m, len(cols))
    return Encoding(params, m, c, b, cols, mat.astype(np.uint32))


def a_rows(seed: bytes, m: int, r0: int, count: int, device) -> np.ndarray:
    """(count, m) uint32: rows r0 .. r0 + count - 1 of the ctr matrix A.
    Column c of those rows is stream bytes [4 (c K + r0), 4 (c K + r0 +
    count)), K = 1774: at most ceil((4 count + 167) / 168) blocks."""
    first_byte = 4 * (np.arange(m, dtype=np.int64) * LWE_DIMENSION + r0)
    first_block = first_byte // keccak.RATE
    span = -(-(4 * count + keccak.RATE - 1) // keccak.RATE)
    blocks = (first_block[:, None] + np.arange(span)).ravel()
    stream = keccak.ctr_blocks(seed, blocks, device).reshape(m, span * keccak.RATE)
    offset = (first_byte - first_block * keccak.RATE)[:, None] + np.arange(4 * count)
    words = np.take_along_axis(stream, offset, axis=1)
    return np.ascontiguousarray(words).view("<u4").T.astype(np.uint32)

def product(left: np.ndarray, right: np.ndarray, device="cpu") -> np.ndarray:
    """left . right mod 2^32, exactly: left's u32 words split into their 4
    bytes, each byte plane times right in float64 (every sum below 2^53
    while right < 2^14 and the inner dimension < 2^24), recombined mod 2^32
    in int64."""
    import torch

    if left.shape[1] >= 1 << 24 or int(right.max(initial=0)) >= 1 << 14:
        raise ValueError("past the exact range of the float64 product")
    rt = torch.from_numpy(right.astype(np.float64)).to(device)
    lt = torch.from_numpy(np.ascontiguousarray(left, np.uint32).view(np.uint8)).to(device)
    lt = lt.reshape(left.shape[0], left.shape[1], 4)
    out = torch.zeros((left.shape[0], right.shape[1]), dtype=torch.int64, device=device)
    for k in range(4):
        part = (lt[:, :, k].double() @ rt).to(torch.int64) % (1 << 32)
        out = (out + (part << (8 * k))) % (1 << 32)
    return out.cpu().numpy().astype(np.uint32)


def product_float32(left: np.ndarray, right: np.ndarray, device) -> np.ndarray:
    """The same product computed in float32 (TF32 off), mod 2^32: the
    precision below the configuration's exact u32 arithmetic."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lt = torch.from_numpy(left.astype(np.float32)).to(device)
    rt = torch.from_numpy(right.astype(np.float32)).to(device)
    out = (lt @ rt).double().cpu().numpy()
    return np.mod(np.floor(out), 2.0**32).astype(np.uint64).astype(np.uint32)
