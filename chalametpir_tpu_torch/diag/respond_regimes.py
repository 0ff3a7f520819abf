"""Respond regimes: the packed respond kernel's scan and tensor-core
regimes (csrc/respond_packed.cu) timed side by side on one CUDA card.

    python -m chalametpir_tpu_torch.diag.respond_regimes [--seed 0]

On synthetic planes of the serving geometry of a 2^20-entry 1 kB-value
arity-3 DB (b = 9, lo + hi packed 8 to a byte) and of a 2^23-entry one
(b = 8, lo only), made on the card from --seed, each regime answers Q
random queries for each Q of QUERY_COUNTS. Every result is first held bit
for bit against the plain version (`respond_packed_ref`), then timed with
CUDA events (median of REPS calls). Beside them: the ctr hint fold's shape
(the 1774 x 2^17 A slab read through its transpose, one 2^17-row chunk of
the 2^20 planes) in the tensor-core regime. One JSON line per height, Q
and regime: ms, GB/s of planes read, and `bound_ms`, the least time of
the same work on an H100: the planes, queries and output moved once at
the card's memory rate, or the 7 (b > 8) or 4 int8 digit rows per query
at its dense int8 tensor rate, whichever is larger (NVIDIA's published
peaks, CARD_BYTES_PER_S and CARD_INT8_OPS_PER_S). Beside it, for
reference, `measured_rates_ms`: the same reckoning at the device-to-device
copy rate and the int8 rate `torch._int_mm` reaches on a large square,
both measured in the same run. MMA_MIN_Q in kernels.py is the crossover
these lines show. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import kernels
from ..ops.respond_packed import hint_fold_partial, pack_geometry, respond_packed_ref
from .scan_qd import Geometry, copy_gbps, cuda_ms, synthetic_planes

HEIGHTS = (20, 23)
QUERY_COUNTS = (1, 2, 3, 4, 5, 8, 16, 64)
FOLD_ROWS, LWE_ROWS = 1 << 17, 1774
REPS = 20
# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at the 700 W limit:
# 3.35 TB/s of HBM3 and 1,979 int8 TOP/s on the tensor cores
CARD_BYTES_PER_S = 3.35e12
CARD_INT8_OPS_PER_S = 1.979e15


def int8_tops(device, n: int = 8192) -> float:
    """int8 operations per second (2 per multiply-add) of torch._int_mm on
    an n x n x n product: the tensor rate a library reaches on this card."""
    a = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device)
    b = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device).t()
    ms = cuda_ms(lambda: torch._int_mm(a, b), 10)
    return 2 * n**3 / ms / 1e9


def bound_ms(nq: int, m: int, c_pad: int, plane_bytes: int, b: int,
             bytes_per_s: float = CARD_BYTES_PER_S,
             ops_per_s: float = CARD_INT8_OPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one respond of nq queries: the
    planes and queries read once and the output written once at
    `bytes_per_s`, or the digit products at `ops_per_s` (int8, 2 per
    multiply-add); the card's published peaks unless given others."""
    moved = plane_bytes + 4 * nq * m + 4 * nq * c_pad
    digit_rows = 7 if b > 8 else 4
    by_bytes = moved / bytes_per_s * 1e3
    by_ops = 2 * digit_rows * nq * m * c_pad / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _launch(queries, db, regime):
    pack, _, _ = pack_geometry(db.mat_elem_bit_len, db.lo.shape[1])
    out = torch.zeros((queries.shape[0], db.lo.shape[1]), dtype=torch.int32, device=db.lo.device)
    kernels._respond_packed(queries, db.lo, db.hi, pack, out, regime)
    return out[:, : db.num_cols]


def run(seed: int = 0, log=print) -> dict:
    """Check and time both regimes at every height and Q; returns
    {"copy_GBps", "int8_TOPS", "rows"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("respond_regimes needs a CUDA device")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    rate, tops = copy_gbps(device), int8_tops(device)
    log(json.dumps({"copy_GBps": rate, "int8_TOPS": tops}))
    rows = []

    def bounds(*shape) -> dict:
        bound, by = bound_ms(*shape)
        return {"bound_ms": bound, "bound_by": by,
                "measured_rates_ms": bound_ms(*shape, rate * 1e9, tops * 1e12)[0]}

    def emit(row):
        log(json.dumps({"regime": row}))
        rows.append(row)

    for log_n in HEIGHTS:
        geo = Geometry.of(log_n)
        db = synthetic_planes(geo, device, gen)
        for nq in QUERY_COUNTS:
            queries = torch.randint(-(1 << 31), 1 << 31, (nq, geo.m), dtype=torch.int32,
                                    device=device, generator=gen)
            want = respond_packed_ref(queries, db.lo, db.hi, geo.b, geo.cols)
            bound = bounds(nq, geo.m, geo.c_pad, db.device_bytes, geo.b)
            for regime in ("scan", "mma"):
                if not torch.equal(_launch(queries, db, regime), want):
                    raise AssertionError(f"{regime} regime differs from plain at 2^{log_n}, Q={nq}")
                ms = cuda_ms(lambda: _launch(queries, db, regime), REPS)
                emit({"height": log_n, "b": geo.b, "q": nq, "regime": regime, "ms": ms,
                      "GBps": db.device_bytes / ms / 1e6, **bound})
            del queries, want
        if log_n == 20:
            rows_ = min(FOLD_ROWS, geo.m_pad)
            lo, hi = db.lo[:rows_], db.hi[:rows_] if db.hi is not None else None
            slab = torch.randint(-(1 << 31), 1 << 31, (rows_, LWE_ROWS), dtype=torch.int32,
                                 device=device, generator=gen)
            want = respond_packed_ref(slab.t(), lo, hi, geo.b, geo.cols)
            if not torch.equal(hint_fold_partial(slab.t(), lo, hi, geo.b, geo.cols), want):
                raise AssertionError("the hint fold differs from plain")
            plane_bytes = lo.numel() + (hi.numel() if hi is not None else 0)
            bound = bounds(LWE_ROWS, rows_, geo.c_pad, plane_bytes, geo.b)
            ms = cuda_ms(lambda: hint_fold_partial(slab.t(), lo, hi, geo.b, geo.cols), 5)
            emit({"height": log_n, "b": geo.b, "q": LWE_ROWS, "rows": rows_, "regime": "mma",
                  "shape": "ctr hint fold chunk", "ms": ms, **bound})
            del lo, hi, slab, want
        del db
        torch.cuda.empty_cache()
    return {"copy_GBps": rate, "int8_TOPS": tops, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("respond_regimes: no CUDA device", file=sys.stderr)
        return 1
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    log(f"device: {torch.cuda.get_device_name(0)}")
    run(args.seed, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
