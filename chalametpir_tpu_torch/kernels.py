"""Build, load and launch the port's hand-written CUDA kernels.

The sources under `csrc/` have a plain C interface, so they are compiled
with `nvcc` into one shared library (no PyTorch headers: a build takes
seconds, not minutes; one nvcc per source, in parallel) and bound with
ctypes. The build happens on first use, never at import, into `_build/`
next to this file, keyed by a digest of the sources and the flags; a
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
import hashlib
import os
import shutil
import subprocess
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("ctr_keccak.cu", "respond_packed.cu", "respond_digits.cu")
# each source compiles to an object in its own nvcc process, all started
# together; one more nvcc call links the objects into the library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# launches per kernel since the last reset_launch_counts(); a run reads
# them to show that its path went through the kernels
LAUNCHES = {"ctr_keccak": 0, "respond_packed": 0, "respond_digits": 0}

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
    for name in SOURCES:
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
            objs = [f"{tmp}.{name}.o" for name in SOURCES]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, name), "-o", obj],
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
    lib.respond_packed_launch.restype = ctypes.c_int
    lib.respond_packed_launch.argtypes = [
        vp, i64, i64, i64, vp, vp, i64, i64, i64, ctypes.c_int, ctypes.c_int,
        i64, i64, vp, i64, vp,
    ]
    lib.respond_digits_launch.restype = ctypes.c_int
    lib.respond_digits_launch.argtypes = [
        vp, i64, i64, i64, i64, vp, vp, i64, i64, i64, ctypes.c_int, i64, i64, ctypes.c_int,
        vp, vp, vp,
    ]
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


# rows per split never drop below this: fewer rows per block would spend
# more on the atomic epilogue than on the rows themselves
_MIN_SPLIT_ROWS = 256
# enough blocks to keep every SM of a large card busy
_TARGET_BLOCKS = 2048


def _query_tile(nq: int) -> int:
    """Queries per thread block: 1 for a single query, else 16 (a tile of
    2, 4 or 8 would serve small batches, but no measurement shows it pays)."""
    return 1 if nq == 1 else 16


def respond_packed(
    queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor | None, pack: int,
    out: torch.Tensor,
) -> None:
    """out[:, :c_pad] += queries . el (mod 2^32) over the packed planes.

    queries: (nq, m) int32 holding u32 bits, any strides (the hint fold
    passes a transposed view of the A slab); lo (>= m, c_pad) int8 and hi
    (>= m, pc) uint8 (None when pack == 0), contiguous; out (nq, >= c_pad)
    int32 with unit column stride."""
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
    ptrs = [lo.data_ptr(), out.data_ptr(), queries.data_ptr()] + ([hi.data_ptr()] if pack else [])
    if any(p % 4 for p in ptrs):
        raise ValueError("planes, queries and out must be 4-byte aligned")
    if nq == 0 or m == 0:
        return
    build()
    qt = _query_tile(nq)
    blocks_xz = -(-c_pad // (4 * 128)) * -(-nq // qt)
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks_xz), m // _MIN_SPLIT_ROWS))
    per_split = -(-m // splits)
    rows_per_split = -(-per_split // 32) * 32
    splits = -(-m // rows_per_split)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        _check(
            _lib.respond_packed_launch(
                queries.data_ptr(), nq, queries.stride(0), queries.stride(1),
                lo.data_ptr(), hi.data_ptr() if pack else None, m, c_pad, pc, pack, qt,
                splits, rows_per_split, out.data_ptr(), out.stride(0), stream,
            ),
            "respond_packed",
        )
    LAUNCHES["respond_packed"] += 1


# the digit kernel's blocks carry 4-8 warps each, and every block ends in
# qd_rows x c_pad atomics: fewer, longer row splits than respond_packed
_DIGIT_TARGET_BLOCKS = 1024
_WARP_ROWS = 8  # digit rows per warp
_MAX_WARPS = 8


def respond_digits(
    qd: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor | None, pack: int,
    out_lo: torch.Tensor, out_hi: torch.Tensor | None,
) -> None:
    """out_lo += qd . lo and out_hi += qd[:qh_rows] . hi fields (mod 2^32).

    qd: int8 digits, (qd_rows, m) with unit column stride (the strided 2-D
    layout) or (n_tiles, qd_rows, tile_k) with unit last stride (the
    tile-contiguous 3-D layout), read through its strides either way;
    qd_rows % 32 == 0. lo (>= m, c_pad) int8 and hi (>= m, pc) uint8 (None
    when pack == 0), contiguous; out_lo (qd_rows, c_pad) and out_hi
    (qh_rows, c_pad) contiguous int32, qh_rows = qd_rows - qd_rows // 4."""
    _require_cuda(qd, "qd", torch.int8)
    _require_cuda(lo, "lo", torch.int8)
    _require_cuda(out_lo, "out_lo", torch.int32)
    if qd.dim() == 2:
        if qd.stride(1) != 1:
            raise ValueError("2-D digits need unit column stride")
        qd_rows, m = qd.shape
        tile_k, tile_stride, row_stride = m, 0, qd.stride(0)
    elif qd.dim() == 3:
        if qd.stride(2) != 1:
            raise ValueError("3-D digits need unit stride within a tile")
        n_tiles, qd_rows, tile_k = qd.shape
        m, tile_stride, row_stride = n_tiles * tile_k, qd.stride(0), qd.stride(1)
    else:
        raise ValueError(f"qd must be 2-D or 3-D, got {qd.dim()}-D")
    rows, c_pad = lo.shape
    if m > rows or not lo.is_contiguous() or c_pad % 128:
        raise ValueError("lo must be contiguous, cover the digit length, and have c_pad % 128 == 0")
    if qd_rows % 32 or m % 4 or tile_k % 4 or tile_stride % 4 or row_stride % 4:
        raise ValueError("need qd_rows % 32 == 0 and m, tile_k and the digit strides % 4 == 0")
    if pack not in (0, 1, 2, 4, 8):
        raise ValueError(f"pack must be 0, 1, 2, 4 or 8, got {pack}")
    qh_rows = qd_rows - qd_rows // 4
    if out_lo.shape != (qd_rows, c_pad) or not out_lo.is_contiguous():
        raise ValueError(f"out_lo must be a contiguous ({qd_rows}, {c_pad}) tensor")
    pc = 0
    if pack:
        if hi is None or out_hi is None:
            raise ValueError("pack > 0 needs the hi plane and out_hi")
        _require_cuda(hi, "hi", torch.uint8)
        _require_cuda(out_hi, "out_hi", torch.int32)
        pc = c_pad // pack if pack > 1 else c_pad
        if hi.shape != (rows, pc) or not hi.is_contiguous():
            raise ValueError(f"hi must be a contiguous ({rows}, {pc}) tensor")
        if out_hi.shape != (qh_rows, c_pad) or not out_hi.is_contiguous():
            raise ValueError(f"out_hi must be a contiguous ({qh_rows}, {c_pad}) tensor")
    ptrs = [qd.data_ptr(), lo.data_ptr(), out_lo.data_ptr()]
    ptrs += [hi.data_ptr(), out_hi.data_ptr()] if pack else []
    if any(p % 4 for p in ptrs):
        raise ValueError("digits, planes and outputs must be 4-byte aligned")
    if qd_rows == 0 or m == 0:
        return
    build()
    groups = qd_rows // _WARP_ROWS
    warps = min(groups, _MAX_WARPS)
    blocks_xz = (c_pad // 128) * -(-groups // warps)
    splits = max(1, min(-(-_DIGIT_TARGET_BLOCKS // blocks_xz), m // _MIN_SPLIT_ROWS))
    per_split = -(-m // splits)
    rows_per_split = -(-per_split // 4) * 4
    splits = -(-m // rows_per_split)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        _check(
            _lib.respond_digits_launch(
                qd.data_ptr(), qd_rows, tile_k, tile_stride, row_stride, lo.data_ptr(),
                hi.data_ptr() if pack else None, m, c_pad, pc, pack, splits, rows_per_split,
                warps, out_lo.data_ptr(), out_hi.data_ptr() if pack else None, stream,
            ),
            "respond_digits",
        )
    LAUNCHES["respond_digits"] += 1
