"""The binary fuse filter of ChalametPIR, in NumPy and plain Python.

Geometry, hash family and construction as the reference describes them
(itzmeanjan/ChalametPIR chalametpir_common/src/binary_fuse_filter.rs:
52-67 geometry, 102-215 peel, 519-538 sizing, 553-635 hashing). The peel
is the sequential stack peel: degree-1 slots are pushed in slot order,
popped last-in first-out, and each key is peeled through the slot it is
popped from. Which slot a key is peeled through decides D, so the order
is part of the encoding.
"""

from __future__ import annotations

import math

import numpy as np

M1, M2 = np.uint64(0xFF51AFD7ED558CCD), np.uint64(0xC4CEB9FE1A85EC53)
MAX_ATTEMPTS = 100  # fresh filter seeds before setup gives up


def murmur64(h: np.ndarray) -> np.ndarray:
    h = np.asarray(h, np.uint64)
    h = h ^ (h >> np.uint64(33))
    h = h * M1
    h = h ^ (h >> np.uint64(33))
    h = h * M2
    return h ^ (h >> np.uint64(33))


def mix256(digests: np.ndarray, seed: bytes) -> np.ndarray:
    """The fused 64-bit hash of each (n, 4) uint64 key digest under the
    32-byte filter seed."""
    words = np.frombuffer(seed, "<u8")
    total = np.zeros(digests.shape[0], np.uint64)
    with np.errstate(over="ignore"):
        for j in range(4):
            acc = np.zeros(digests.shape[0], np.uint64)
            for w in words:
                acc = murmur64(acc + murmur64(digests[:, j] + w))
            total += acc
    return total


def _round_half_away(x: float) -> int:
    f = math.floor(x)
    return f + 1 if x - f >= 0.5 else f


def geometry(arity: int, n: int) -> tuple[int, int, int]:
    """(segment_length, segment_count_length, num_fingerprints) for n keys."""
    if arity == 3:
        seg = 1 << max(0, int(math.floor(math.log(n) / math.log(3.33) + 2.25)))
        factor = max(1.125, 0.875 + 0.25 * math.log(1e6) / math.log(n))
    elif arity == 4:
        seg = 1 << max(0, int(math.floor(math.log(n) / math.log(2.91) - 0.5)))
        factor = max(1.075, 0.77 + 0.305 * math.log(6e5) / math.log(n))
    else:
        raise ValueError(f"arity {arity}")
    seg = min(seg, 1 << 18)
    cap = min(_round_half_away(n * factor), 0xFFFFFFFF)
    count = -(-(-(-cap // seg) * seg) // seg)
    count = 1 if count < arity else count - (arity - 1)
    return seg, count * seg, (count + arity - 1) * seg


def slots(h: np.ndarray, arity: int, seg: int, seg_count_len: int) -> np.ndarray:
    """(n, arity) int64 fingerprint rows of each fused hash."""
    h = np.asarray(h, np.uint64)
    lo = (h & np.uint64(0xFFFFFFFF)) * np.uint64(seg_count_len)
    hi = (h >> np.uint64(32)) * np.uint64(seg_count_len)
    h0 = ((hi + (lo >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)
    mask = np.uint64(seg - 1)
    shifts = (18, 0) if arity == 3 else (0, 16, 32)
    out = [h0]
    for p, s in enumerate(shifts, start=1):
        out.append((h0 + p * seg) ^ ((h >> np.uint64(s)) & mask).astype(np.int64))
    return np.stack(out, axis=1)


def peel(rows: np.ndarray, num_fp: int, max_degree: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(key index, slot position) of each key in peel order, or None when
    the attempt fails (a degree past max_degree, or a stalled peel).
    rows: (n, arity) slots of each key, in the order the keys were
    sorted by fused hash."""
    n, arity = rows.shape
    count = np.bincount(rows.ravel(), minlength=num_fp)
    if count.max() > max_degree:
        return None
    key_of = np.zeros(num_fp, np.int64)
    pos_of = np.zeros(num_fp, np.int64)
    # XOR of the keys (and of their slot positions) still in each slot
    for p in range(arity):
        np.bitwise_xor.at(key_of, rows[:, p], np.arange(n, dtype=np.int64))
        np.bitwise_xor.at(pos_of, rows[:, p], np.int64(p))
    count_l, key_l, pos_l = count.tolist(), key_of.tolist(), pos_of.tolist()
    rows_l = rows.tolist()
    stack = np.flatnonzero(count == 1).tolist()
    pop, push = stack.pop, stack.append
    order, codes = [], []
    positions = range(arity)
    while stack:
        slot = pop()
        if count_l[slot] != 1:
            continue
        k, code = key_l[slot], pos_l[slot]
        order.append(k)
        codes.append(code)
        row = rows_l[k]
        for p in positions:
            if p != code:
                r = row[p]
                left = count_l[r] - 1
                count_l[r] = left
                key_l[r] ^= k
                pos_l[r] ^= p
                if left == 1:
                    push(r)
    if len(order) != n:
        return None
    return np.array(order, np.int64), np.array(codes, np.int64)


def construct(digests: np.ndarray, arity: int, rng: np.random.Generator):
    """Build the filter over (n, 4) uint64 key digests with seeds drawn
    from rng, one per attempt. Returns (seed, geometry, fused hash of each
    key, (n, arity) slots of each key, peel order as original key
    indices, slot position of each)."""
    n = digests.shape[0]
    seg, seg_count_len, num_fp = geometry(arity, n)
    max_degree = 31 if arity == 4 else 63
    for _ in range(MAX_ATTEMPTS):
        seed = rng.bytes(32)
        hashes = mix256(digests, seed)
        order = np.argsort(hashes, kind="stable")
        ordered = hashes[order]
        if n > 1 and (ordered[1:] == ordered[:-1]).any():
            continue
        rows = slots(ordered, arity, seg, seg_count_len)
        peeled = peel(rows, num_fp, max_degree)
        if peeled is None:
            continue
        by_sorted, codes = peeled
        key_rows = np.empty_like(rows)
        key_rows[order] = rows
        return seed, (seg, seg_count_len, num_fp), hashes, key_rows, order[by_sorted], codes
    raise RuntimeError(f"no filter after {MAX_ATTEMPTS} attempts")
