"""TurboSHAKE128 for one-block messages, batched in plain PyTorch.

Keccak-p[1600, 12] over (N, 25) int64 lane tensors (the u64 lanes'
bits), on whatever device the caller's tensors live. Used for the key
digests (TurboSHAKE128(key)[:32]) and the ctr PRG (block i of A's stream
is TurboSHAKE128(seed || LE64(i))[:168]). Messages here are at most 40
bytes, so every sponge absorbs one block and squeezes one block.
"""

from __future__ import annotations

import numpy as np
import torch

RATE = 168
DOMAIN = 0x1F
# the last 12 of Keccak-f[1600]'s 24 round constants
ROUND_CONSTANTS = (
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# rho offsets by lane x + 5y; pi sends lane (x, y) to (y, 2x + 3y)
RHO = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14)
PI_DEST = tuple(i // 5 + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5) for i in range(25))
CHUNK = 1 << 20  # sponges per permutation call


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    if s == 0:
        return x
    # >> is arithmetic on int64: mask the bits shifted in
    return (x << s) | ((x >> (64 - s)) & ((1 << s) - 1))


def keccak_p12(lanes: torch.Tensor) -> torch.Tensor:
    """Keccak-p[1600, 12] of each row of an (N, 25) int64 tensor."""
    a = [lanes[:, i] for i in range(25)]
    for rc in ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for i in range(25):
            b[PI_DEST[i]] = _rotl(a[i], RHO[i])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = a[0] ^ _signed(rc)
    return torch.stack(a, dim=1)


def turboshake_one_block(msgs: np.ndarray, out_len: int, device) -> np.ndarray:
    """TurboSHAKE128(msg)[:out_len] of each row of an (N, L) uint8 array,
    L + 1 < RATE and out_len <= RATE: (N, out_len) uint8."""
    n, length = msgs.shape
    if length + 1 >= RATE or out_len > RATE:
        raise ValueError("one-block messages and outputs only")
    out = np.empty((n, out_len), np.uint8)
    for s in range(0, n, CHUNK):
        part = msgs[s : s + CHUNK]
        block = np.zeros((part.shape[0], 200), np.uint8)
        block[:, :length] = part
        block[:, length] = DOMAIN
        block[:, RATE - 1] ^= 0x80
        lanes = torch.from_numpy(block.view(np.int64)).to(device)
        state = keccak_p12(lanes).cpu().numpy()
        out[s : s + part.shape[0]] = state.view(np.uint8).reshape(-1, 200)[:, :out_len]
    return out


def key_digests(keys: np.ndarray, device) -> np.ndarray:
    """(n, 4) uint64 little-endian words of TurboSHAKE128(key)[:32] for
    each row of an (n, key_len) uint8 array."""
    return turboshake_one_block(keys, 32, device).view("<u8")


def ctr_blocks(seed: bytes, blocks: np.ndarray, device) -> np.ndarray:
    """(len(blocks), RATE) uint8: ctr block i is TurboSHAKE128(seed ||
    LE64(i))[:RATE]."""
    msgs = np.empty((len(blocks), 40), np.uint8)
    msgs[:, :32] = np.frombuffer(seed, np.uint8)
    msgs[:, 32:] = np.asarray(blocks, "<u8").reshape(-1, 1).view(np.uint8)
    return turboshake_one_block(msgs, RATE, device)
