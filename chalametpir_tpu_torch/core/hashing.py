"""Binary-fuse-filter hash family, vectorised.

Bit-exact equivalents of the reference's murmur64 / mix / mix256 /
hash_batch functions (reference:
chalametpir_common/src/binary_fuse_filter.rs:553-635), implemented over
numpy uint64 arrays so the whole key set is hashed in a handful of
vector ops. Scalar Python-int variants are provided where a single
value is needed. The port's copy of chalametpir_tpu/core/hashing.py; the
digests and the single-key folds run in the native engine.
"""

from __future__ import annotations

import numpy as np

from ..native import engine as _native
from ..params import HASHED_KEY_BYTE_LEN  # noqa: F401  (re-exported, as in the JAX package)
from .keccak import turboshake128, turboshake128_batch  # noqa: F401  (re-exported, as in the JAX package)

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_U33 = np.uint64(33)
_U64MASK = (1 << 64) - 1


def murmur64(h: np.ndarray | int) -> np.ndarray | int:
    """MurmurHash3 64-bit finaliser (reference: binary_fuse_filter.rs:553-560)."""
    if isinstance(h, (int, np.integer)):
        h = int(h) & _U64MASK
        h ^= h >> 33
        h = (h * 0xFF51AFD7ED558CCD) & _U64MASK
        h ^= h >> 33
        h = (h * 0xC4CEB9FE1A85EC53) & _U64MASK
        h ^= h >> 33
        return h
    h = h.astype(np.uint64, copy=True)
    h ^= h >> _U33
    h *= _M1
    h ^= h >> _U33
    h *= _M2
    h ^= h >> _U33
    return h


def mix(key: np.ndarray | int, seed: np.ndarray | int):
    """murmur64(key + seed) mod 2^64 (reference: binary_fuse_filter.rs:563-565)."""
    if isinstance(key, (int, np.integer)) and isinstance(seed, (int, np.integer)):
        return murmur64((int(key) + int(seed)) & _U64MASK)
    return murmur64(np.asarray(key, np.uint64) + np.asarray(seed, np.uint64))


def hash_of_key(key: bytes) -> np.ndarray:
    """TurboSHAKE128 32-byte digest of `key` as 4 LE uint64 words
    (reference: binary_fuse_filter.rs:568-584)."""
    return _native.hash_keys([bytes(key)])[0]


def hash_of_keys_batch(keys: list[bytes]) -> np.ndarray:
    """Digests of many keys at once -> (n, 4) uint64."""
    return _native.hash_keys(keys)


def mix256(hashed_keys: np.ndarray, seed: bytes) -> np.ndarray:
    """Fold a (n, 4) or (4,) uint64 hashed key with a 32-byte seed into one
    uint64 per key (reference: binary_fuse_filter.rs:588-601)."""
    hk = np.asarray(hashed_keys, np.uint64)
    single = hk.ndim == 1
    if single:
        # scalar fast path: the online client calls this once per
        # query/response and tiny-array numpy costs ~40x more
        return np.uint64(_native.mix256_scalar(hk, seed))
    seed_words = np.frombuffer(seed, dtype="<u8")
    total = np.zeros(hk.shape[0], np.uint64)
    for j in range(4):
        acc = np.zeros(hk.shape[0], np.uint64)
        for w in seed_words:
            acc = murmur64(acc + murmur64(hk[:, j] + w))
        total += acc
    return total  # the single (1-D) case returned above


def _mulhi64(h: np.ndarray, m: int) -> np.ndarray:
    """floor((h * m) / 2^64) for uint64 h and m < 2^32, without 128-bit ints."""
    m64 = np.uint64(m)
    lo = (h & np.uint64(0xFFFFFFFF)) * m64
    hi = (h >> np.uint64(32)) * m64
    return (hi + (lo >> np.uint64(32))) >> np.uint64(32)


def hash_batch_3(hash_: np.ndarray, segment_length: int, segment_count_length: int):
    """Map fused hash(es) to three fingerprint row indices
    (reference: binary_fuse_filter.rs:605-617). Works on scalars or arrays."""
    h = np.asarray(hash_, np.uint64)
    mask = np.uint64(segment_length - 1)
    h0 = _mulhi64(h, segment_count_length).astype(np.uint32)
    h1 = (h0 + np.uint32(segment_length)) ^ ((h >> np.uint64(18)) & mask).astype(np.uint32)
    h2 = (h0 + np.uint32(2) * np.uint32(segment_length)) ^ (h & mask).astype(np.uint32)
    return h0, h1, h2


def hash_batch_4(hash_: np.ndarray, segment_length: int, segment_count_length: int):
    """Map fused hash(es) to four fingerprint row indices
    (reference: binary_fuse_filter.rs:621-635)."""
    h = np.asarray(hash_, np.uint64)
    mask = np.uint64(segment_length - 1)
    h0 = _mulhi64(h, segment_count_length).astype(np.uint32)
    h1 = (h0 + np.uint32(segment_length)) ^ (h & mask).astype(np.uint32)
    h2 = (h0 + np.uint32(2) * np.uint32(segment_length)) ^ ((h >> np.uint64(16)) & mask).astype(np.uint32)
    h3 = (h0 + np.uint32(3) * np.uint32(segment_length)) ^ ((h >> np.uint64(32)) & mask).astype(np.uint32)
    return h0, h1, h2, h3


def row_mask(hash_: int, num_cols: int, mat_elem_bit_len: int) -> np.ndarray:
    """Per-column additive mask `mix(hash, col) & (2^b - 1)` used when a row
    is encoded into / recovered from the filter matrix
    (reference: matrix.rs:736-739 and client.rs:239-240)."""
    mask = (1 << mat_elem_bit_len) - 1
    return _native.mix_row_mask(int(hash_), num_cols, mask & 0xFFFFFFFF)
