"""ctr-mode TurboSHAKE128 on the device: the LWE matrix A is generated
where it is used and never crosses the host link.

Counterpart of chalametpir_tpu/ops/prg_jax.py. Block i of the ctr stream
is TurboSHAKE128(seed || LE64(i))[:168] (the port's core/prg.py), and A is
fingerprint-major: A[r, c] is stream word c * rows + r, so any range of
fingerprint columns is one contiguous run of ctr blocks.

u32 words are carried as int32 tensors holding the same bits (torch has
no u32 arithmetic). `ctr_blocks` is the wrapper: it runs the hand-written
kernel (csrc/ctr_keccak.cu) for a CUDA device and the plain version
`ctr_blocks_ref` only for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core.keccak import KECCAK_RC, RATE, _PI_DEST, _RHO

WORDS_PER_BLOCK = RATE // 4  # 42


def seed_to_words(seed: bytes) -> tuple[int, ...]:
    """The 32-byte seed as its eight little-endian u32 words."""
    return tuple(int(w) for w in np.frombuffer(seed, "<u4"))


def _seed_lanes(seed_words) -> tuple[int, int, int, int]:
    return tuple(seed_words[2 * i] | (seed_words[2 * i + 1] << 32) for i in range(4))


def _as_i64(x: int) -> int:
    """u64 bit pattern as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    if s == 0:
        return x
    # torch >> on int64 is arithmetic: mask off the copied sign bits
    return (x << s) | ((x >> (64 - s)) & ((1 << s) - 1))


def ctr_blocks_ref(seed_words, block0: int, nblocks: int, device) -> torch.Tensor:
    """Plain version of the K3 kernel: (nblocks, 42) int32 ctr blocks
    [block0, block0 + nblocks), Keccak-p[1600,12] vectorised over blocks
    with one int64 tensor per lane."""
    device = torch.device(device)
    seed = _seed_lanes(seed_words)
    ctr = torch.arange(nblocks, dtype=torch.int64, device=device)
    zero = torch.zeros(nblocks, dtype=torch.int64, device=device)
    a = [zero] * 25
    for lane in range(4):
        a[lane] = torch.full_like(zero, _as_i64(seed[lane]))
    # block0 + i as u64 bits (block0 < 2^64, i < 2^62: the add wraps at most once)
    a[4] = ctr + _as_i64(block0)
    a[5] = torch.full_like(zero, 0x1F)
    a[20] = torch.full_like(zero, _as_i64(0x80 << 56))
    for rc in KECCAK_RC[12:]:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b: list = [None] * 25
        for i in range(25):
            b[_PI_DEST[i]] = _rotl(a[i], _RHO[i])
        a = [
            b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        a[0] = a[0] ^ _as_i64(rc)
    # the 21 rate lanes as (lo, hi) u32 pairs, viewed as int32 bits
    lanes = torch.stack(a[: RATE // 8], dim=1).contiguous()
    return lanes.view(torch.int32).reshape(nblocks, WORDS_PER_BLOCK)


def ctr_blocks(seed_words, block0: int, nblocks: int, device) -> torch.Tensor:
    """(nblocks, 42) int32 ctr blocks on `device`: the K3 kernel on a CUDA
    device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return ctr_blocks_ref(seed_words, block0, nblocks, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((nblocks, WORDS_PER_BLOCK), dtype=torch.int32, device=device)
    kernels.ctr_keccak(out, _seed_lanes(seed_words), block0)
    return out


def rows_from_blocks(seed_words, blk0_words, offset: int, nrows: int, cols: int, device="cuda"):
    """(nrows, cols) int32 slab of the ctr stream starting `offset` u32
    words into a ctr block: `blk0_words` is the block's index, an int (as
    `fp_block_start` gives it) or the JAX package's two u32 words (lo,
    hi)."""
    if isinstance(blk0_words, (int, np.integer)):
        block0 = int(blk0_words)
    else:
        lo, hi = (int(w) for w in np.asarray(blk0_words, dtype=np.uint64).reshape(2))
        block0 = lo | hi << 32
    offset = int(offset)
    nelems = nrows * cols
    # the JAX package's fixed block count for any alignment
    nblocks = nelems * 4 // RATE + 2
    words = ctr_blocks(seed_words, block0, nblocks, device).reshape(-1)
    return words[offset : offset + nelems].reshape(nrows, cols)


def fp_block_start(col0: int, lwe_rows: int) -> tuple[int, int]:
    """(block0, offset) addressing fingerprint column `col0` of ctr A."""
    word0 = col0 * lwe_rows
    block0 = (word0 * 4) // RATE
    return block0, word0 - block0 * WORDS_PER_BLOCK


def expand_fp_slab(seed_words, col0: int, ncols: int, lwe_rows: int, device) -> torch.Tensor:
    """(ncols, lwe_rows) int32 slab of ctr A: slab[j] = A[:, col0 + j]."""
    block0, offset = fp_block_start(col0, lwe_rows)
    return rows_from_blocks(seed_words, block0, offset, ncols, lwe_rows, device)
