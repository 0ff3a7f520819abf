"""Client query engines: s . A on the card, or on the host.

Counterpart of chalametpir_tpu/ops/client_device.py: the resident
DeviceQueryEngine, the StreamingQueryEngine and HostQueryEngine, the JAX
client's host engine (its `Client` with no device engine). The resident
engine keeps A as four biased int8 byte planes, planes[j][c, r] = ((A[r,
c] >> 8j) & 255) - 128, fingerprint major like the ctr stream, so each
slab of fingerprint columns is generated by the K3 kernel and recoded in place:
all of A's planes, (4, m_pad, k_pad), built from the seed on the device
(ctr mode) or from the host XOF's row blocks (stream mode,
`from_host_rows`, and `from_host_matrix` for a whole host A: the same
planes, so one product serves both modes; "km" planes, the JAX engine's
row-major layout, are laid out fingerprint-major once, at construction).
The streaming engine (ctr mode) keeps none of A and regenerates it for
every batch in the fused kernel (csrc/ctr_keccak_sa.cu), which adds each
generated word's ternary products in registers, so its device memory is
the batch's signs and result at any m. A query over the planes is four
int8 products over the k contraction, recombined mod 2^32 with the bias
correction 128 * sum(s) per plane:

    s . A = sum_j (s . plane_j + 128 * sum(s)) << 8j   (mod 2^32)

The plane products are plain int8 matrix products outside any kernel of
the JAX package (its einsum), so they go to `torch._int_mm`, which wants
more than 16 rows and k, n multiples of 8: secrets are padded to at least
32 rows and k = 1774 to 1776 with zero signs (zero signs add nothing, and
leave sum(s) unchanged).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..errors import AcceleratorError, InvalidDimensionForVector
from ..native import engine as _native
from ..params import LWE_DIMENSION
from . import prg_torch
from .respond_packed import _wrap_i32

_MIN_ROWS = 32  # _int_mm needs more than 16 rows
# A rows per uploaded block of a host A (the stream-mode client's, and
# `from_host_matrix`): the recode writes r-byte runs into the
# fingerprint-major planes, and the host holds two blocks in flight (64 x
# m x 4 bytes each, 302 MB at 2^20 entries)
STREAM_A_BLOCK_ROWS = 64
# device memory kept free beside the planes, for the slab being generated
# and the per-query temporaries
_HEADROOM_BYTES = 2 << 30


class DeviceResult:
    """A (Q, m_pad) u32 result still on the device, in the shape the
    base Client consumes: `block_until_ready()` waits for it, `np.asarray`
    copies it to the host as uint32, and slicing rows keeps it lazy."""

    def __init__(self, t: torch.Tensor):
        self._t = t

    def block_until_ready(self) -> "DeviceResult":
        if self._t.device.type == "cuda":
            torch.cuda.current_stream(self._t.device).synchronize()
        return self

    def __getitem__(self, idx) -> "DeviceResult":
        return DeviceResult(self._t[idx])

    def __array__(self, dtype=None, copy=None):
        arr = self._t.cpu().numpy().view(np.uint32)
        return arr if dtype is None else arr.astype(dtype)

    def read(self, stats: dict) -> np.ndarray:
        """The host copy; the wait the caller's host work did not hide and
        the readback go into `stats`."""
        t0 = time.perf_counter()
        self.block_until_ready()
        t1 = time.perf_counter()
        arr = np.asarray(self)
        stats.update(device_wait_s=round(t1 - t0, 3), readback_s=round(time.perf_counter() - t1, 3),
                     readback_bytes=int(arr.nbytes))
        return arr


class HostResult:
    """The host engine's (Q, m) u32 result in DeviceResult's shape, computed
    when read: the caller's host work runs first, as beside a device's."""

    def __init__(self, codes: np.ndarray, mat_a: np.ndarray):
        self._codes = codes
        self._mat_a = mat_a

    def __getitem__(self, idx) -> "HostResult":
        return HostResult(self._codes[idx], self._mat_a)

    def __array__(self, dtype=None, copy=None):
        arr = np.stack([_native.ternary_matvec(c, self._mat_a) for c in self._codes])
        return arr if dtype is None else arr.astype(dtype)

    def read(self, stats: dict) -> np.ndarray:
        t0 = time.perf_counter()
        arr = np.asarray(self)
        stats["host_matvec_s"] = round(time.perf_counter() - t0, 3)
        return arr


def _recode_planes(slab: torch.Tensor) -> torch.Tensor:
    """(r, k) int32 u32 bits -> (4, r, k) int8 biased byte planes, in one
    pass: byte j of the little-endian word is (A >> 8j) & 255, and the
    biased byte x - 128 is x ^ 0x80 read as int8."""
    r, k = slab.shape
    return (slab.view(torch.uint8).reshape(r, k, 4).permute(2, 0, 1) ^ 0x80).view(torch.int8)


def _ternary(codes: np.ndarray, k: int) -> np.ndarray:
    """(Q, k) ternary codes {0:0, 1:+1, 2:-1} -> (Q, k) int8 signs."""
    if codes.ndim != 2 or codes.shape[1] != k:
        raise InvalidDimensionForVector()
    return np.where(codes == 2, -1, codes).astype(np.int8)


def _signs(codes: np.ndarray, k: int, k_pad: int, device) -> torch.Tensor:
    """(Q, k) ternary codes -> (rows, k_pad) int8 signs on `device`,
    zero-padded to the _int_mm shape rules."""
    ternary = _ternary(codes, k)
    q = codes.shape[0]
    rows = max(_MIN_ROWS, -(-q // 8) * 8)
    signs = np.zeros((rows, k_pad), np.int8)
    signs[:q, :k] = ternary
    return torch.from_numpy(signs).to(device)


def _plane_products(s: torch.Tensor, planes: torch.Tensor, q: int) -> torch.Tensor:
    """(rows, k_pad) signs x (4, n, k_pad) byte planes -> (q, n) int32 u32
    bits of s . A over those n fingerprint columns."""
    bias = 128 * s[:q].sum(dim=1, dtype=torch.int64)[:, None]
    acc = None
    for j in range(4):
        dots = torch._int_mm(s, planes[j].t())[:q].to(torch.int64)
        term = ((dots + bias) & 0xFFFFFFFF) << (8 * j)
        acc = term if acc is None else acc + term
    return _wrap_i32(acc)


class _QueryEngine:
    """The s . A surface the Client calls; an engine sets k, m and layout
    and implements matvec_batch_async, whose result `np.asarray` reads."""

    k: int
    m: int
    layout: str
    uses_device = True  # s . A in torch on a device: all but the host engine

    def fused_launches(self, q: int) -> int:
        """Launches of the fused s . A kernel for q secrets (the launch
        span's `fused`): none but on the streaming engine."""
        return 0

    def matvec(self, codes: np.ndarray) -> np.ndarray:
        """(k,) int8 ternary codes {0:0, 1:+1, 2:-1} -> (m,) uint32 s . A."""
        if codes.shape != (self.k,):
            raise InvalidDimensionForVector()
        return self.matvec_batch(codes[None, :])[0]

    def matvec_batch(self, codes: np.ndarray) -> np.ndarray:
        """(Q, k) ternary codes -> (Q, m) uint32."""
        return np.asarray(self.matvec_batch_async(codes))[:, : self.m].astype(np.uint32)

    def matvec_batch_async(self, codes: np.ndarray) -> DeviceResult:
        raise NotImplementedError


class HostQueryEngine(_QueryEngine):
    """The JAX client's host engine: A as a (k, m) uint32 host matrix and
    s . A by the native ternary matvec, no torch tensor and no device."""

    layout = "host"
    uses_device = False
    device_bytes = 0  # setup_stats["plane_bytes"]

    def __init__(self, pub_mat_a: np.ndarray):
        self.pub_mat_a = pub_mat_a
        self.k, self.m = pub_mat_a.shape

    def matvec_batch_async(self, codes: np.ndarray) -> HostResult:
        return HostResult(codes, self.pub_mat_a)


class DeviceQueryEngine(_QueryEngine):
    """Holds A's byte planes on the device and runs s . A per query batch.

    layout "mk": planes (4, m_pad, k_pad) int8, fingerprint-major, as the
    constructors here build them. layout "km": planes (4, k_pad, m), the
    JAX engine's row-major upload, which is relaid fingerprint-major on
    the planes' device here, once: `torch._int_mm` takes its second
    operand column-major, so the products have one layout, and `layout`
    reads "mk" afterwards. Either way the planes are zero-padded to
    multiples of 8 in m and k (the _int_mm shape rules); `k_pad` is the
    padded k. The JAX `k_pad` argument is the planes' own k extent (the
    signs' width there), so it is checked against them, not stored."""

    def __init__(self, planes, k: int, m: int, layout: str = "mk", k_pad: int | None = None):
        planes = torch.as_tensor(planes)
        if planes.dtype != torch.int8 or planes.dim() != 3 or planes.shape[0] != 4:
            raise ValueError(f"planes must be (4, ., .) int8, got {tuple(planes.shape)} {planes.dtype}")
        if layout == "km":
            planes = planes.transpose(1, 2)
        elif layout != "mk":
            raise ValueError(f"unknown planes layout {layout!r} (mk/km)")
        if k_pad not in (None, planes.shape[2]) or planes.shape[2] < k or planes.shape[1] < m:
            raise ValueError(f"{layout} planes {tuple(planes.shape)} do not fit k = {k}, k_pad = {k_pad}, m = {m}")
        m8, k8 = -(-planes.shape[1] // 8) * 8, -(-planes.shape[2] // 8) * 8
        if (m8, k8) != tuple(planes.shape[1:]) or not planes.is_contiguous():
            padded = torch.zeros((4, m8, k8), dtype=torch.int8, device=planes.device)
            padded[:, : planes.shape[1], : planes.shape[2]] = planes
            planes = padded
        self._planes = planes  # (4, m_pad, k_pad) int8
        self.k = k
        self.m = m
        self.layout = "mk"
        self.k_pad = planes.shape[2]

    @property
    def device(self) -> torch.device:
        return self._planes.device

    @property
    def device_bytes(self) -> int:
        return self._planes.numel()

    @staticmethod
    def _empty_planes(m: int, device, hint: str) -> torch.Tensor:
        """Zeroed (4, m_pad, k_pad) planes on `device`; raises when they and
        the headroom do not fit the card's free memory (`hint` says what
        to do instead)."""
        k_pad = -(-LWE_DIMENSION // 8) * 8
        m_pad = -(-m // 8) * 8  # _int_mm wants the output width a multiple of 8
        need = 4 * m_pad * k_pad
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            if need + _HEADROOM_BYTES > free:
                raise AcceleratorError(
                    f"resident client A planes need {need / 2**30:.1f} GiB, "
                    f"{free / 2**30:.1f} GiB free; {hint}"
                )
        return torch.zeros((4, m_pad, k_pad), dtype=torch.int8, device=device)

    @classmethod
    def from_seed_ctr(cls, seed: bytes, m: int, cols_per_step: int = 32768,
                      device="cuda") -> "DeviceQueryEngine":
        """Generate A's planes on `device` (ctr PRG mode): each step
        generates a contiguous ctr slab of `cols_per_step` fingerprint
        columns and recodes it into the planes."""
        device = resolve_device(device)
        k = LWE_DIMENSION
        planes = cls._empty_planes(
            m, device, "use StreamingQueryEngine, which regenerates A per batch and "
            "holds none of it",
        )
        m_pad = planes.shape[1]
        seed_words = prg_torch.seed_to_words(seed)
        for c0 in range(0, m_pad, cols_per_step):
            ncols = min(cols_per_step, m_pad - c0)
            slab = prg_torch.expand_fp_slab(seed_words, c0, ncols, k, device)
            planes[:, c0 : c0 + ncols, :k] = _recode_planes(slab)
        # fingerprint columns m..m_pad hold PRG output: they are output
        # positions, sliced off by the callers
        return cls(planes, k, m)

    @classmethod
    def streaming_from_seed_ctr(cls, seed: bytes, m: int, cols_per_step: int = 65536,
                                device="cuda") -> "StreamingQueryEngine":
        """The ctr-mode engine that never holds A: each batch regenerates
        it in the fused s . A kernel (StreamingQueryEngine), no device
        memory for A at any m."""
        return StreamingQueryEngine(seed, m, cols_per_step, device)

    @classmethod
    def from_host_matrix(cls, a_host: np.ndarray, device="cuda") -> "DeviceQueryEngine":
        """The (LWE_DIMENSION, m) uint32 A from the host (stream mode,
        interop), uploaded in row blocks of STREAM_A_BLOCK_ROWS and recoded on
        the device by `from_host_rows`; the host never holds a recoded
        copy."""
        a_host = np.asarray(a_host)
        if a_host.ndim != 2:
            raise ValueError(f"A must be (k, m), got shape {a_host.shape}")
        k, m = a_host.shape
        blocks = ((r0, a_host[r0 : r0 + STREAM_A_BLOCK_ROWS]) for r0 in range(0, k, STREAM_A_BLOCK_ROWS))
        return cls.from_host_rows(blocks, m, device)

    @classmethod
    def from_host_rows(cls, row_blocks, m: int, device, stats: dict | None = None) -> "DeviceQueryEngine":
        """Build A's planes on `device` from stream-mode A, which the host
        XOF emits row-major: `row_blocks` yields (r0, (r, m) uint32 block)
        covering LWE rows 0..k in order, as `prg.iter_row_blocks` does.
        Each block is uploaded and recoded on the device into plane
        columns r0..r0+r (r-byte runs at stride k_pad), so the host holds
        only the blocks in flight, never all of A; run the iterator ahead
        with `prg.prefetch_iter` and the XOF overlaps upload and recode.
        `stats` (optional) receives alloc_s, the wall seconds of the plane
        buffer's allocation."""
        device = resolve_device(device)
        k = LWE_DIMENSION
        t0 = time.perf_counter()
        planes = cls._empty_planes(m, device, "stream-mode A has no streaming engine")
        if stats is not None:
            stats["alloc_s"] = time.perf_counter() - t0
        rows = 0
        for r0, block in row_blocks:
            r = block.shape[0]
            if block.shape != (r, m) or r0 != rows or r0 + r > k:
                raise ValueError(f"row block at {r0} of shape {block.shape}: expected row {rows}, {m} columns")
            a = torch.from_numpy(np.ascontiguousarray(block, np.uint32).view(np.int32)).to(device)
            planes[:, :m, r0 : r0 + r] = _recode_planes(a).transpose(1, 2)
            rows += r
        if rows != k:
            raise ValueError(f"row blocks covered {rows} of {k} rows of A")
        # fingerprint columns m..m_pad stay zero: output positions, sliced
        # off by the callers
        return cls(planes, k, m)

    def matvec_batch_async(self, codes: np.ndarray) -> DeviceResult:
        """Dispatch the batched matvec and return without waiting, so the
        caller overlaps its host work with the device products."""
        s = _signs(codes, self.k, self.k_pad, self.device)
        return DeviceResult(_plane_products(s, self._planes, codes.shape[0]))


class StreamingQueryEngine(_QueryEngine):
    """Drop-in for DeviceQueryEngine when A's planes would not fit: every
    batch regenerates A in the fused kernel, which generates each
    fingerprint column in registers and adds its ternary dots there
    (`prg_torch.ctr_sa`, one launch per kernels.SA_MAX_Q secrets). Nothing
    of A outlives a launch. Same matvec surface. `cols_per_step`, the JAX
    engine's slab width, is taken and checked for its call surface; the
    fused kernel covers every column in one launch, so it sets nothing."""

    def __init__(self, seed: bytes, m: int, cols_per_step: int = 65536, device="cuda"):
        if cols_per_step <= 0 or cols_per_step % 8:
            raise ValueError("cols_per_step must be a positive multiple of 8")
        self.k = LWE_DIMENSION
        self.m = m
        self.layout = "streaming"
        self._device = resolve_device(device)
        self._seed_words = prg_torch.seed_to_words(seed)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_bytes(self) -> int:
        """Device bytes held between batches: none."""
        return 0

    def fused_launches(self, q: int) -> int:
        """ceil(q / kernels.SA_MAX_Q): one launch a SA_MAX_Q secrets."""
        return -(-q // kernels.SA_MAX_Q)

    def matvec_batch_async(self, codes: np.ndarray) -> DeviceResult:
        """Dispatch the batch and return without waiting. The result has m
        rounded up to 8 columns, as the resident engine's; the columns past
        m hold PRG output, sliced off by the callers."""
        signs = torch.from_numpy(_ternary(codes, self.k)).to(self.device)
        return DeviceResult(prg_torch.ctr_sa(self._seed_words, signs, 0, -(-self.m // 8) * 8, self.k))
