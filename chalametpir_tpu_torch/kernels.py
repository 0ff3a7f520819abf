"""Build, load and launch the port's hand-written CUDA kernels.

The sources under `csrc/` have a plain C interface, so they are compiled
with `nvcc` into one shared library (no PyTorch headers: a build takes
seconds, not minutes; one nvcc per source, in parallel) and bound with
ctypes. The build happens on first use, never at import, into `_build/`
next to this file, keyed by a digest of the sources, their headers and the flags; a
second process waits on a file lock and reuses the result. Same
build-on-first-use idiom as the native host engine
(chalametpir_tpu/native/engine.py).

Each launch function checks device, dtype, shape and contiguity, launches
on PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to its entry in `LAUNCHES`. Callers allocate every
output; nothing here falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("ctr_keccak.cu", "ctr_keccak_sa.cu", "respond_packed.cu", "respond_digits.cu")
HEADERS = ("keccak_p12.cuh", "mma_common.cuh")  # included by the sources, from csrc/ alone
# each source compiles to an object in its own nvcc process, all started
# together; one more nvcc call links the objects into the library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)  # and -I csrc/

# launches per kernel since the last reset_launch_counts(); a run reads
# them to show that its path went through the kernels
LAUNCHES = {"ctr_keccak": 0, "ctr_keccak_sa": 0, "respond_packed_scan": 0, "respond_packed_mma": 0, "respond_digits": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """nvcc from $NVCC, $PATH, or the toolkit named by $CUDA_HOME (default
    /usr/local/cuda); raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the seconds
    this call spent, 0.0 when it was already loaded."""
    global _lib
    if _lib is not None:
        return 0.0
    import fcntl

    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libchalametpir_kernels_{_digest()}.so")
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            nvcc = nvcc_path()
            missing = [name for name in HEADERS if not os.path.isfile(os.path.join(_CSRC, name))]
            if missing:
                raise RuntimeError(f"kernel headers missing from {_CSRC}: {missing}")
            objs = [f"{tmp}.{name}.o" for name in SOURCES]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", os.path.join(_CSRC, name), "-o", obj],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for name, obj in zip(SOURCES, objs)
            ]
            errors = []
            for name, proc in zip(SOURCES, procs):
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    errors.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            if not errors:
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    errors.append(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            if errors:
                raise RuntimeError("\n".join(errors))
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    u64, i64, vp = ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p
    lib.ctr_keccak_launch.restype = ctypes.c_int
    lib.ctr_keccak_launch.argtypes = [u64, u64, u64, u64, u64, i64, vp, vp]
    ci = ctypes.c_int
    lib.ctr_keccak_sa_launch.restype = ci
    lib.ctr_keccak_sa_launch.argtypes = [u64, u64, u64, u64, vp, ci, ci, u64, i64, vp, i64, vp]
    lib.respond_packed_scan_launch.restype = ci
    lib.respond_packed_scan_launch.argtypes = [
        vp, i64, i64, i64, vp, vp, i64, i64, i64, ci, i64, i64, ci, ci, vp, i64, vp,
    ]
    lib.respond_packed_mma_launch.restype = ci
    lib.respond_packed_mma_launch.argtypes = [
        vp, i64, i64, i64, vp, vp, i64, i64, i64, ci, i64, i64, vp, i64, vp,
    ]
    lib.respond_digits_launch.restype = ctypes.c_int
    lib.respond_digits_launch.argtypes = [
        vp, i64, i64, i64, i64, vp, vp, i64, i64, i64, ci, i64, i64, ci, ci, vp, vp, vp,
    ]
    lib.respond_digits_smem_bytes.restype = ci
    lib.respond_digits_smem_bytes.argtypes = [ci, ci, ci]
    _lib = lib
    return time.perf_counter() - t0


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {status}")


def _require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def ctr_keccak(out: torch.Tensor, seed_lanes: tuple[int, int, int, int], block0: int) -> None:
    """Fill out (nblocks, 42) int32 with ctr blocks [block0, block0 + nblocks)."""
    _require_cuda(out, "out", torch.int32)
    if out.dim() != 2 or out.shape[1] != 42 or not out.is_contiguous():
        raise ValueError("out must be a contiguous (nblocks, 42) tensor")
    if not 0 <= block0 < 1 << 64:
        raise ValueError("block0 must fit in 64 bits")
    build()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _check(_lib.ctr_keccak_launch(*seed_lanes, block0, out.shape[0], out.data_ptr(), stream),
               "ctr_keccak")
    LAUNCHES["ctr_keccak"] += 1


# secrets the fused s.A kernel takes in one launch (its largest
# instantiation, csrc/ctr_keccak_sa.cu); prg_torch.ctr_sa launches a
# larger batch in chunks of this many
SA_MAX_Q = 32


def ctr_keccak_sa(out: torch.Tensor, seed_lanes: tuple[int, int, int, int], signs: torch.Tensor,
                  col0: int) -> None:
    """out[q, c] = signs[q] . A[:, col0 + c] (mod 2^32, int32 bits) for the
    (nq, ncols) out, A ctr-generated with signs.shape[1] rows and never
    stored (csrc/ctr_keccak_sa.cu).

    signs: (nq, rows) int8 in {-1, 0, 1}, contiguous, 1 <= nq <= SA_MAX_Q;
    out: (nq, ncols) int32 with unit column stride."""
    _require_cuda(out, "out", torch.int32)
    _require_cuda(signs, "signs", torch.int8)
    nq, rows = signs.shape if signs.dim() == 2 else (0, 0)
    if not 1 <= nq <= SA_MAX_Q or rows < 1 or not signs.is_contiguous():
        raise ValueError(f"signs must be a contiguous (nq, rows) tensor with 1 <= nq <= {SA_MAX_Q}")
    if out.dim() != 2 or out.shape[0] != nq or out.stride(1) != 1:
        raise ValueError("out must be (nq, ncols) with unit column stride")
    if out.device != signs.device:
        raise ValueError("out and signs must be on one device")
    if col0 < 0 or (col0 + out.shape[1]) * rows * 4 >= 1 << 64:
        raise ValueError("the columns' words must be addressable in 64 bits")
    build()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _check(_lib.ctr_keccak_sa_launch(*seed_lanes, signs.data_ptr(), nq, rows, col0, out.shape[1],
                                         out.data_ptr(), out.stride(0), stream), "ctr_keccak_sa")
    LAUNCHES["ctr_keccak_sa"] += 1


# rows per split never drop below this: fewer rows per block would spend
# more on the atomic epilogue than on the rows themselves
_MIN_SPLIT_ROWS = 256
# enough blocks to keep every SM of a large card busy
_TARGET_BLOCKS = 2048
# queries from which the tensor-core regime takes over from the scan
# regime (csrc/respond_packed.cu) over planes with a hi plane. Measured by
# diag/respond_regimes.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# over the served 2^20 planes (b = 9) one query scans in 0.53-0.56 ms
# against 0.68 ms on the tensor cores, two in 0.98-1.04 against 0.63-0.65
# ms. Over a lo plane alone (pack 0, b <= 8) the tensor cores win from one
# query (2^23: 3.72-3.75 against 3.89-3.97 ms), so pack 0 always takes
# them. The scan's cost grows by a plane read per query, the
# tensor cores' stays that of one read up to 16.
MMA_MIN_Q = 2
_SCAN_THREADS = 512  # threads per scan block: column groups x row lanes
_SM_THREADS = 2048  # resident threads per SM (Hopper)
# the mma block tile: queries, columns, rows per stage
_MMA_QUERIES, _MMA_COLS, _MMA_ROW_STEP = 16, 128, 64
# rows per split of the tensor-core regime: 65,536 x 128 x 255 < 2^31, so
# no s32 accumulator of a split can overflow
MMA_MAX_SPLIT_ROWS = 1 << 16


def _splits(m: int, base_blocks: int, align: int, max_rows: int | None = None,
            target: int = _TARGET_BLOCKS) -> tuple[int, int]:
    """(splits, rows_per_split) so that base_blocks x splits blocks (about
    `target`) fill the card, no split is shorter than _MIN_SPLIT_ROWS
    (unless m is) or longer than max_rows, and rows_per_split is a
    multiple of `align`."""
    lo = -(-m // max_rows) if max_rows else 1
    splits = max(lo, min(-(-target // base_blocks), m // _MIN_SPLIT_ROWS))
    per_split = -(-m // splits)
    rows = -(-per_split // align) * align
    return -(-m // rows), rows


def choose_regime(nq: int, pack: int) -> str:
    """The respond kernel's regime for nq queries over planes of this pack:
    "mma" (tensor cores) from MMA_MIN_Q queries or over a lo plane alone,
    else "scan"."""
    return "mma" if nq >= MMA_MIN_Q or pack == 0 else "scan"


def respond_packed(
    queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor | None, pack: int, out: torch.Tensor,
) -> None:
    """out[:, :c_pad] += queries . el (mod 2^32) over the packed planes, in
    the regime `choose_regime` picks.

    queries: (nq, m) int32 holding u32 bits, any strides (the hint fold
    passes a transposed view of the A slab); lo (>= m, c_pad) int8 and hi
    (>= m, pc) uint8 (None when pack == 0), contiguous and 16-byte aligned;
    out (nq, >= c_pad) int32 with unit column stride."""
    _respond_packed(queries, lo, hi, pack, out, choose_regime(queries.shape[0], pack))


def _respond_packed(
    queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor | None, pack: int,
    out: torch.Tensor, regime: str,
) -> None:
    """respond_packed in the given regime ("scan" or "mma"); the tests and
    diag/respond_regimes.py call it to hold both regimes at the same Q."""
    _require_cuda(queries, "queries", torch.int32)
    _require_cuda(lo, "lo", torch.int8)
    _require_cuda(out, "out", torch.int32)
    nq, m = queries.shape
    rows, c_pad = lo.shape
    if m > rows or not lo.is_contiguous() or c_pad % 128:
        raise ValueError("lo must be contiguous, cover the query length, and have c_pad % 128 == 0")
    if pack not in (0, 1, 2, 4, 8):
        raise ValueError(f"pack must be 0, 1, 2, 4 or 8, got {pack}")
    pc = 0
    if pack:
        if hi is None:
            raise ValueError("pack > 0 needs the hi plane")
        _require_cuda(hi, "hi", torch.uint8)
        pc = c_pad // pack if pack > 1 else c_pad
        if hi.shape != (rows, pc) or not hi.is_contiguous():
            raise ValueError(f"hi must be a contiguous ({rows}, {pc}) tensor")
    if out.dim() != 2 or out.shape[0] != nq or out.shape[1] < c_pad or out.stride(1) != 1:
        raise ValueError("out must be (nq, >= c_pad) with unit column stride")
    if any(p % 16 for p in [lo.data_ptr()] + ([hi.data_ptr()] if pack else [])):
        raise ValueError("the planes must be 16-byte aligned")
    if any(p % 4 for p in (out.data_ptr(), queries.data_ptr())):
        raise ValueError("queries and out must be 4-byte aligned")
    if regime not in ("scan", "mma"):
        raise ValueError(f"regime must be 'scan' or 'mma', got {regime!r}")
    if regime == "scan" and nq > 65535:
        raise ValueError("the scan regime takes at most 65,535 queries (one grid slice each)")
    if nq == 0 or m == 0:
        return
    build()
    args = (queries.data_ptr(), nq, queries.stride(0), queries.stride(1),
            lo.data_ptr(), hi.data_ptr() if pack else None, m, c_pad, pc, pack)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        if regime == "scan":
            groups = c_pad // 16  # 16 columns per thread
            threads = min(128, groups)  # a row of column groups, no idle thread
            lanes = _SCAN_THREADS // threads  # row lanes per block
            # every SM full and no SM a block behind: the card's block
            # slots once over (the fewer the blocks, the fewer the atomics)
            slots = torch.cuda.get_device_properties(lo.device).multi_processor_count * max(
                1, _SM_THREADS // (threads * lanes))
            splits, per_split = _splits(m, -(-groups // threads) * nq, 1, target=slots)
            status = _lib.respond_packed_scan_launch(
                *args, splits, per_split, threads, lanes, out.data_ptr(), out.stride(0), stream)
        else:
            base = -(-nq // _MMA_QUERIES) * (c_pad // _MMA_COLS)
            splits, per_split = _splits(m, base, _MMA_ROW_STEP, MMA_MAX_SPLIT_ROWS)
            status = _lib.respond_packed_mma_launch(
                *args, splits, per_split, out.data_ptr(), out.stride(0), stream)
    _check(status, f"respond_packed_{regime}")
    LAUNCHES[f"respond_packed_{regime}"] += 1


# -- the digit kernel (csrc/respond_digits.cu) --------------------------------
DIGIT_ROWS = 32  # digit rows per block: two m16 tiles
DIGIT_ROW_STEP = 64  # plane rows per stage; tile_k and the splits are multiples
_DIGIT_STAGES = 4
_DIGIT_LD = DIGIT_ROW_STEP + 16  # digit row stride in shared memory
BLOCK_SMEM_MAX = 232_448  # dynamic shared memory a block can ask for (H100)
_SM_SMEM = 233_472  # shared memory of one SM, of which each block reserves 1 KB
_SM_COUNT = 132  # H100 SXM; the launch asks the device


@dataclass(frozen=True)
class DigitGeometry:
    """How one digit-kernel launch is cut: `warps` warps a block, each block
    32 digit rows x 32 * warps columns (`fields` of the pack's fields of
    32 * warps / fields hi bytes) x one of `splits` row ranges of
    rows_per_split; grid = (row groups, column blocks, splits)."""
    warps: int
    fields: int
    splits: int
    rows_per_split: int
    grid: tuple[int, int, int]
    smem_bytes: int


def digit_smem_bytes(pack: int, warps: int, fields: int) -> int:
    """Dynamic shared memory of a digit-kernel block: the ring of stages,
    each 32 digit rows, 64 lo rows and 64 rows of the block's hi bytes."""
    cols = 32 * warps
    hi_w = cols // fields if pack > 1 else cols
    lo_ld = cols + 16
    hi_ld = hi_w + (32 if (hi_w // 16) % 2 else 16)
    stage = DIGIT_ROWS * _DIGIT_LD + DIGIT_ROW_STEP * lo_ld + (DIGIT_ROW_STEP * hi_ld if pack else 0)
    return _DIGIT_STAGES * stage


@functools.lru_cache(maxsize=None)
def digit_tiles(pack: int) -> tuple[tuple[int, int], ...]:
    """Every (warps, fields) the kernel takes at this pack: the block's hi
    bytes a multiple of 16, its shared memory within BLOCK_SMEM_MAX."""
    return tuple(
        (warps, fields)
        for warps in (16, 12, 8, 4)
        for fields in ([f for f in (1, 2, 4, 8) if pack % f == 0] if pack > 1 else [1])
        if 32 * warps % (16 * fields) == 0
        and digit_smem_bytes(pack, warps, fields) <= BLOCK_SMEM_MAX
    )


def _digit_tile(c_pad: int, pack: int) -> tuple[int, int]:
    """(warps, fields) of a block: the tile that wastes least of its column
    blocks on columns past the planes' edge, where a tile whose runs in
    the lo plane are not whole 32-byte sectors counts half; of equals the
    widest, and of those the one with the longest runs (the fewest
    fields). diag/digits_sweep.py measures every tile side by side
    (PERF.md: 16 warps of 4 fields over the 2^20 planes, 12 warps over the
    1152 columns of 2^23)."""
    seg = c_pad // pack if pack > 1 else c_pad
    best, best_used = None, 0.0
    for warps, fields in digit_tiles(pack):
        w = 32 * warps // fields
        used = seg / (-(-seg // w) * w) / (2 if w % 32 else 1)
        if used > best_used:
            best, best_used = (warps, fields), used
    return best


@functools.lru_cache(maxsize=256)  # a scan repeats one geometry: keep the launch's host time short
def digit_geometry(m: int, qd_rows: int, c_pad: int, pack: int, sm_count: int = _SM_COUNT,
                   tile: tuple[int, int] | None = None, waves: int = 1) -> DigitGeometry:
    """The launch geometry of the digit kernel for (qd_rows, m) digits over
    planes c_pad wide. The grid is whole rounds of the card's block slots
    (every SM full and none a block behind): `waves` of them, or as many as
    it takes for a split to stay within MMA_MAX_SPLIT_ROWS (no s32
    accumulator can overflow). A split is a multiple of DIGIT_ROW_STEP rows
    and, unless m is shorter, at least _MIN_SPLIT_ROWS. `tile` forces the
    block's (warps, fields)."""
    warps, fields = tile or _digit_tile(c_pad, pack)
    if (warps, fields) not in digit_tiles(pack):
        raise ValueError(f"{warps} warps of {fields} fields are no tile of pack {pack}")
    smem = digit_smem_bytes(pack, warps, fields)
    hi_w = 32 * warps // fields
    seg = c_pad // pack if pack > 1 else c_pad
    grid_xy = (qd_rows // DIGIT_ROWS, -(-seg // hi_w) * (pack // fields if pack > 1 else 1))
    base = grid_xy[0] * grid_xy[1]
    slots = sm_count * max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // (32 * warps)))
    rounds = max(waves, -(-(-(-m // MMA_MAX_SPLIT_ROWS) * base) // slots))
    splits, rows = _splits(m, base, DIGIT_ROW_STEP, MMA_MAX_SPLIT_ROWS, target=rounds * slots)
    if max(grid_xy[1], splits) > 65535:
        raise ValueError(f"grid {(*grid_xy, splits)} is past CUDA's 65,535 blocks in y or z")
    return DigitGeometry(warps, fields, splits, rows, (*grid_xy, splits), smem)


def digit_launch_args(qd, lo, hi, pack: int, out_lo, out_hi) -> tuple[int, int, int, int, int, int, int]:
    """Checks the digit kernel's contract on shapes, strides, types and
    addresses (on any device) and returns (qd_rows, m, tile_k, tile_stride,
    row_stride, c_pad, pc) as the launch wants them; raises ValueError."""
    for name, t, dtype in (("qd", qd, torch.int8), ("lo", lo, torch.int8), ("out_lo", out_lo, torch.int32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if qd.dim() == 2:
        if qd.stride(1) != 1:
            raise ValueError("2-D digits need unit column stride")
        qd_rows, m = qd.shape
        # one tile that holds every k, in whole stages
        tile_k, tile_stride, row_stride = -(-m // DIGIT_ROW_STEP) * DIGIT_ROW_STEP, 0, qd.stride(0)
    elif qd.dim() == 3:
        if qd.stride(2) != 1:
            raise ValueError("3-D digits need unit stride within a tile")
        n_tiles, qd_rows, tile_k = qd.shape
        m, tile_stride, row_stride = n_tiles * tile_k, qd.stride(0), qd.stride(1)
        if tile_k % DIGIT_ROW_STEP:
            raise ValueError(f"tile_k must be a multiple of {DIGIT_ROW_STEP}, got {tile_k}")
    else:
        raise ValueError(f"qd must be 2-D or 3-D, got {qd.dim()}-D")
    rows, c_pad = lo.shape
    if m > rows or not lo.is_contiguous() or c_pad % 128:
        raise ValueError("lo must be contiguous, cover the digit length, and have c_pad % 128 == 0")
    if qd_rows % DIGIT_ROWS or m % 16 or tile_stride % 16 or row_stride % 16:
        raise ValueError("need qd_rows % 32 == 0 and m and the digit strides % 16 == 0")
    if pack not in (0, 1, 2, 4, 8):
        raise ValueError(f"pack must be 0, 1, 2, 4 or 8, got {pack}")
    qh_rows = qd_rows - qd_rows // 4
    if out_lo.shape != (qd_rows, c_pad) or not out_lo.is_contiguous():
        raise ValueError(f"out_lo must be a contiguous ({qd_rows}, {c_pad}) tensor")
    pc = 0
    if pack:
        if hi is None or out_hi is None:
            raise ValueError("pack > 0 needs the hi plane and out_hi")
        if hi.dtype != torch.uint8 or out_hi.dtype != torch.int32:
            raise ValueError("hi must be uint8 and out_hi int32")
        pc = c_pad // pack if pack > 1 else c_pad
        if hi.shape != (rows, pc) or not hi.is_contiguous():
            raise ValueError(f"hi must be a contiguous ({rows}, {pc}) tensor")
        if out_hi.shape != (qh_rows, c_pad) or not out_hi.is_contiguous():
            raise ValueError(f"out_hi must be a contiguous ({qh_rows}, {c_pad}) tensor")
    if any(p % 16 for p in [qd.data_ptr(), lo.data_ptr()] + ([hi.data_ptr()] if pack else [])):
        raise ValueError("the digits and the planes must be 16-byte aligned")
    if any(p % 4 for p in [out_lo.data_ptr()] + ([out_hi.data_ptr()] if pack else [])):
        raise ValueError("the outputs must be 4-byte aligned")
    return qd_rows, m, tile_k, tile_stride, row_stride, c_pad, pc


def respond_digits(
    qd: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor | None, pack: int,
    out_lo: torch.Tensor, out_hi: torch.Tensor | None,
) -> None:
    """out_lo += qd . lo and out_hi += qd[:qh_rows] . hi fields (mod 2^32).

    qd: int8 digits, (qd_rows, m) with unit column stride and m % 16 == 0
    (the strided 2-D layout) or (n_tiles, qd_rows, tile_k) with unit last
    stride and tile_k % 64 == 0 (the tile-contiguous 3-D layout), read
    through its strides either way; qd_rows % 32 == 0; the other strides
    and the address are multiples of 16. lo (>= m, c_pad) int8 and hi
    (>= m, pc) uint8 (None when pack == 0), contiguous and 16-byte aligned;
    out_lo (qd_rows, c_pad) and out_hi (qh_rows, c_pad) contiguous int32,
    qh_rows = qd_rows - qd_rows // 4."""
    _respond_digits(qd, lo, hi, pack, out_lo, out_hi)


def _respond_digits(qd, lo, hi, pack, out_lo, out_hi, tile: tuple[int, int] | None = None,
                    waves: int = 1) -> None:
    """respond_digits with the block's tile (warps, fields) and the grid's
    depth forced: diag/digits_sweep.py times the choices side by side."""
    for name, t in (("qd", qd), ("lo", lo), ("out_lo", out_lo), ("hi", hi), ("out_hi", out_hi)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    qd_rows, m, tile_k, tile_stride, row_stride, c_pad, pc = digit_launch_args(
        qd, lo, hi, pack, out_lo, out_hi)
    if qd_rows == 0 or m == 0:
        return
    build()
    sm_count = torch.cuda.get_device_properties(lo.device).multi_processor_count
    geo = digit_geometry(m, qd_rows, c_pad, pack, sm_count, tile, waves)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        _check(
            _lib.respond_digits_launch(
                qd.data_ptr(), qd_rows, tile_k, tile_stride, row_stride, lo.data_ptr(),
                hi.data_ptr() if pack else None, m, c_pad, pc, pack, geo.splits,
                geo.rows_per_split, geo.warps, geo.fields, out_lo.data_ptr(),
                out_hi.data_ptr() if pack else None, stream,
            ),
            "respond_digits",
        )
    LAUNCHES["respond_digits"] += 1
