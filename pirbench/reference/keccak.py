"""TurboSHAKE128 for one-block messages: batched in plain PyTorch, and
one serial stream in plain C.

Keccak-p[1600, 12] over (N, 25) int64 lane tensors (the u64 lanes'
bits), on whatever device the caller's tensors live. Used for the key
digests (TurboSHAKE128(key)[:32]) and the ctr PRG (block i of A's stream
is TurboSHAKE128(seed || LE64(i))[:168]). Messages here are at most 40
bytes, so every sponge absorbs one block and squeezes one block.

The stream PRG reads one sponge's blocks one after another, each the
permutation of the last: 8.37 GB of A at 2^20 is 50 M permutations in a
chain, which only compiled code runs in seconds. xof.c is that chain,
written from the specification beside this file and sharing nothing
with the program; stream_rows calls it through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

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
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "xof.c")
# inside the checkout at a fixed path, so that later runs find the library
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CFLAGS = ("-O3", "-fPIC", "-shared", "-std=c11", "-Wall")
_lib = None


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



def _library():
    """The serial XOF (xof.c), built with the host's C compiler on first
    use into BUILD_DIR, under a name keyed by its source and flags: only
    a checkout's first run builds it."""
    global _lib
    if _lib is None:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(CFLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libpirbench_xof_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([os.environ.get("CC", "cc"), *CFLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {_SRC} failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.ts128_stream_rows.restype = ctypes.c_int
        lib.ts128_stream_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
    return _lib


def stream_rows(seed: bytes, row_words: int, rows) -> np.ndarray:
    """(len(rows), row_words) uint32: rows of one TurboSHAKE128(seed)
    stream read as little-endian words, row r being words r * row_words
    .. (r + 1) * row_words - 1, as the reference's generate_from_seed
    reads A row-major (chalametpir_common/src/matrix.rs:541-558). rows
    must rise strictly; every block up to the last row is squeezed."""
    rows = np.ascontiguousarray(rows, np.int64)
    out = np.empty((len(rows), row_words), np.uint32)
    rc = _library().ts128_stream_rows(seed, len(seed), row_words, rows.ctypes.data, len(rows), out.ctypes.data)
    if rc != 0:
        raise ValueError("a seed of one block and rows that rise strictly only")
    return out


def xof_words(seed: bytes, count: int) -> np.ndarray:
    """(count,) uint32: the first count words of TurboSHAKE128(seed)."""
    return stream_rows(seed, count, [0])[0]
