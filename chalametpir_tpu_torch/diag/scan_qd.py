"""Scan diagnostic: the respond scan's plane-read rate per plane height and
query-digit layout, on one CUDA card.

    python -m chalametpir_tpu_torch.diag.scan_qd [--seed 0]

Counterpart of scripts/diag_scan_qdsweep.py (which covers
scripts/diag_scan_qdlayout.py). At each height, the planes of a 2^n-entry
1 kB-value arity-3 DB (b = 9, lo + hi packed 8 to a byte, at 2^20-2^22;
b = 8, lo only, at 2^23), synthetic and generated on the card from
--seed, are scanned by

- "u32": the serving respond kernel (csrc/respond_packed.cu) at Q = 8;
- "2d": the digit kernel (csrc/respond_digits.cu) on the same 8 queries'
  32 digit rows in the strided layout (32, m_pad);
- "3d": the digit kernel on the tile-contiguous copy (n_tiles, 32, 2048).

Every result is first checked bit for bit against its plain version, and
the recombined digit products against the u32 respond. Then each is timed
with CUDA events (median of per-call times, `cuda_ms`), beside its plain
version. One JSON line per height and variant: plane GB, ms per scan,
GB/s of planes read, that rate's share of the device-to-device copy
bandwidth measured in the same run (bytes read plus written per second
by a 2 GiB copy), the plain version's ms, and the ms of
`torch._int_mm(qd, lo)`, the one library call that computes the digit
kernel's lo product. Then, per height, one line with the ratio of the 3-D
layout's time to the 2-D layout's, from calls timed in turns (2-D, 3-D,
2-D, ...), so that a drift of the card's clocks falls on both alike: the
question the diagnostic exists to answer. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from dataclasses import dataclass

import torch

from ..core import codec
from ..core.filter import filter_geometry
from ..ops.digits import combine, prepare_query_digits
from ..ops.respond_digits import respond_digits, respond_digits_ref, to_3d
from ..ops.respond_packed import (
    LANE,
    M_ALIGN,
    PackedPlanes,
    pack_geometry,
    respond_batch_packed,
    respond_packed_ref,
)
from ..params import find_mat_elem_bit_len

HEIGHTS = (20, 21, 22, 23)
VALUE_LEN, ARITY = 1024, 3
NUM_QUERIES = 8  # 32 digit rows, the JAX diagnostics' qd block
VARIANTS = ("u32", "2d", "3d")
REPS = 20  # timed calls per kernel
_FILL_ROWS = 1 << 19


@dataclass(frozen=True)
class Geometry:
    log_n: int
    b: int
    m: int  # fingerprint rows
    cols: int  # encoded row width

    @classmethod
    def of(cls, log_n: int) -> "Geometry":
        """The serving planes' geometry of a 2^log_n-entry DB."""
        b = find_mat_elem_bit_len(1 << log_n)
        _, _, m = filter_geometry(ARITY, 1 << log_n)
        return cls(log_n, b, m, codec.encoded_row_width(VALUE_LEN, b))

    @property
    def m_pad(self) -> int:
        return -(-self.m // M_ALIGN) * M_ALIGN

    @property
    def c_pad(self) -> int:
        return -(-self.cols // LANE) * LANE


def synthetic_planes(geo: Geometry, device, gen: torch.Generator) -> PackedPlanes:
    """Random planes of the exact geometry; padding rows and lo's padding
    columns hold value zero, as in served planes, and a byte-wide hi field
    (pack 1) stays below 2^(b - 8)."""
    pack, _, pc = pack_geometry(geo.b, geo.c_pad)
    hi_top = 256 if pack > 1 else 1 << max(0, geo.b - 8)
    lo = torch.full((geo.m_pad, geo.c_pad), -128, dtype=torch.int8, device=device)
    hi = torch.zeros((geo.m_pad, pc), dtype=torch.uint8, device=device) if pack else None
    for r0 in range(0, geo.m, _FILL_ROWS):
        r1 = min(geo.m, r0 + _FILL_ROWS)
        lo[r0:r1, : geo.cols] = torch.randint(
            -128, 128, (r1 - r0, geo.cols), dtype=torch.int8, device=device, generator=gen)
        if pack:
            hi[r0:r1] = torch.randint(0, hi_top, (r1 - r0, pc), dtype=torch.uint8, device=device,
                                      generator=gen)
    return PackedPlanes(lo, hi, geo.b, geo.m, geo.cols)


def _require_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"scan_qd {what}: results differ")


def check(db: PackedPlanes, queries: torch.Tensor):
    """Run every variant once on `db` and hold it against its plain
    version, bit for bit; returns (pack, 2-D digits, 3-D digits) for
    timing."""
    pack, _, _ = pack_geometry(db.mat_elem_bit_len, db.lo.shape[1])
    u32 = respond_batch_packed(queries, db)
    _require_equal(u32, respond_packed_ref(queries, db.lo, db.hi, db.mat_elem_bit_len, db.num_cols),
                   "u32 respond vs plain")
    qd2, sums = prepare_query_digits(queries, db.lo.shape[0])
    qd3 = to_3d(qd2)
    want_lo, want_hi = respond_digits_ref(qd2, db.lo, db.hi, pack)
    for name, qd in (("2d", qd2), ("3d", qd3)):
        out_lo, out_hi = respond_digits(qd, db.lo, db.hi, pack)
        _require_equal(out_lo, want_lo, f"{name} out_lo vs plain")
        if pack:
            _require_equal(out_hi, want_hi, f"{name} out_hi vs plain")
        _require_equal(combine(out_lo, out_hi, sums, queries.shape[0], db.num_cols), u32,
                       f"{name} recombined vs u32 respond")
    return pack, qd2, qd3


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of fn() in ms, one CUDA event pair per call,
    after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ratio_in_turns(fn_a, fn_b, reps: int) -> float:
    """median ms of fn_b over median ms of fn_a, the two called in turns."""
    fn_a(), fn_b()
    times = ([], [])
    for _ in range(reps):
        for fn, into in zip((fn_a, fn_b), times):
            into.append(cuda_ms(fn, 1, warmup=0))
    return statistics.median(times[1]) / statistics.median(times[0])


def int_mm_ms(qd: torch.Tensor, lo: torch.Tensor) -> float:
    """Median ms of torch._int_mm(qd, lo): the library call that computes
    the digit kernel's lo product (out_lo = qd . lo)."""
    return cuda_ms(lambda: torch._int_mm(qd, lo), REPS)


def copy_gbps(device) -> float:
    """Device-to-device copy rate of 2 GiB: bytes read plus written per
    second."""
    nbytes = 2 << 30
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), REPS)
    del src, dst
    return 2 * nbytes / ms / 1e6


def scan_height(log_n: int, device, gen: torch.Generator, copy_rate: float,
                plain_reps: int = 1) -> tuple[list[dict], float]:
    """Check and time every variant at one height; returns one row per
    variant, with its plain version's ms beside its own, and the 3-D
    layout's time over the 2-D layout's."""
    geo = Geometry.of(log_n)
    db = synthetic_planes(geo, device, gen)
    queries = torch.randint(-(1 << 31), 1 << 31, (NUM_QUERIES, geo.m), dtype=torch.int32,
                            device=device, generator=gen)
    pack, qd2, qd3 = check(db, queries)
    fns = {
        "u32": lambda: respond_batch_packed(queries, db),
        "2d": lambda: respond_digits(qd2, db.lo, db.hi, pack),
        "3d": lambda: respond_digits(qd3, db.lo, db.hi, pack),
    }
    # check() has just run both plain versions: no warm-up call
    plain_u32 = lambda: respond_packed_ref(queries, db.lo, db.hi, geo.b, geo.cols)  # noqa: E731
    plain_digits = lambda: respond_digits_ref(qd3, db.lo, db.hi, pack)  # noqa: E731
    plain_ms = {"u32": cuda_ms(plain_u32, plain_reps, warmup=0)}
    plain_ms["2d"] = plain_ms["3d"] = cuda_ms(plain_digits, plain_reps, warmup=0)
    nbytes = db.device_bytes
    int_mm = int_mm_ms(qd2, db.lo)
    rows = []
    for variant in VARIANTS:
        ms = cuda_ms(fns[variant], REPS)
        gbps = nbytes / ms / 1e6
        rows.append({"height": log_n, "b": geo.b, "layout": variant, "plane_GB": nbytes / 1e9,
                     "ms": ms, "GBps": gbps, "copy_share": gbps / copy_rate,
                     "plain_ms": plain_ms[variant], "int_mm_ms": int_mm})
    ratio = ratio_in_turns(fns["2d"], fns["3d"], 2 * REPS)
    del db, queries, qd2, qd3, fns
    torch.cuda.empty_cache()
    return rows, ratio


def run(seed: int = 0, log=print) -> dict:
    """The whole diagnostic on the current CUDA device, at every height of
    HEIGHTS; logs one JSON line per height and variant and returns
    {"copy_GBps", "rows", "ratio_3d_over_2d" by height}."""
    if not torch.cuda.is_available():
        raise RuntimeError("scan_qd needs a CUDA device")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    rate = copy_gbps(device)
    log(json.dumps({"copy_GBps": rate}))
    rows, ratios = [], {}
    for log_n in HEIGHTS:
        height_rows, ratios[log_n] = scan_height(log_n, device, gen, rate, plain_reps=2 if log_n <= 20 else 1)
        for row in height_rows:
            log(json.dumps({"scan": row}))
            rows.append(row)
        log(json.dumps({"layouts": {"height": log_n, "ratio_3d_over_2d": ratios[log_n]}}))
    return {"copy_GBps": rate, "rows": rows, "ratio_3d_over_2d": ratios}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_qd: no CUDA device", file=sys.stderr)
        return 1
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    log(f"device: {torch.cuda.get_device_name(0)}")
    run(args.seed, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
