"""Digit-kernel sweep: the block width and the grid depth of
csrc/respond_digits.cu side by side, on one CUDA card.

    python -m chalametpir_tpu_torch.diag.digits_sweep [--seed 0] [--heights 20 23]

At each height, the scan diagnostic's synthetic planes (diag/scan_qd.py)
are scanned by the digit kernel on 32 digit rows with every block tile
the pack allows (`warps` of 32 columns each, which own `fields` of the
pack's fields) at one and two rounds of the card's block slots (`waves`),
in both digit layouts. Each choice is first
checked bit for bit against the plain version, then timed with CUDA events
(median of 20). One JSON line per choice, with the time's share of the
byte bound at the H100's published memory rate; `default` marks the choice
`kernels.digit_geometry` makes unasked. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import kernels
from ..ops.digits import prepare_query_digits
from ..ops.respond_digits import qh_rows_of, respond_digits_ref, to_3d
from ..ops.respond_packed import pack_geometry
from .respond_regimes import CARD_BYTES_PER_S
from .scan_qd import NUM_QUERIES, REPS, Geometry, cuda_ms, synthetic_planes

WAVES = (1, 2)


def sweep_height(log_n: int, device, gen: torch.Generator, log=print) -> list[dict]:
    geo = Geometry.of(log_n)
    db = synthetic_planes(geo, device, gen)
    queries = torch.randint(-(1 << 31), 1 << 31, (NUM_QUERIES, geo.m), dtype=torch.int32,
                            device=device, generator=gen)
    pack, _, _ = pack_geometry(geo.b, geo.c_pad)
    qd2, _ = prepare_query_digits(queries, db.lo.shape[0])
    layouts = {"2d": qd2, "3d": to_3d(qd2)}
    rows, c_pad = qd2.shape[0], db.lo.shape[1]
    want = respond_digits_ref(qd2, db.lo, db.hi, pack)
    out_lo = torch.empty((rows, c_pad), dtype=torch.int32, device=device)
    out_hi = torch.empty((qh_rows_of(rows), c_pad), dtype=torch.int32, device=device) if pack else None
    moved = db.device_bytes + qd2.numel() + 4 * out_lo.numel() + (4 * out_hi.numel() if pack else 0)
    bound_ms = moved / CARD_BYTES_PER_S * 1e3
    default = kernels.digit_geometry(qd2.shape[1], rows, c_pad, pack,
                                     torch.cuda.get_device_properties(device).multi_processor_count)
    results = []
    for tile in kernels.digit_tiles(pack):
        for waves in WAVES:
            cut = kernels.digit_geometry(qd2.shape[1], rows, c_pad, pack, tile=tile, waves=waves)

            def scan(qd):
                out_lo.zero_()
                if pack:
                    out_hi.zero_()
                kernels._respond_digits(qd, db.lo, db.hi, pack, out_lo, out_hi, tile, waves)

            row = {"height": log_n, "b": geo.b, "warps": tile[0], "fields": tile[1], "waves": waves,
                   "grid": cut.grid,
                   "rows_per_split": cut.rows_per_split, "smem_bytes": cut.smem_bytes,
                   "bound_ms": bound_ms,
                   "default": (*tile, cut.splits) == (default.warps, default.fields, default.splits)}
            for name, qd in layouts.items():
                scan(qd)
                if not torch.equal(out_lo, want[0]) or (pack and not torch.equal(out_hi, want[1])):
                    raise AssertionError(f"digits_sweep 2^{log_n} tile={tile} waves={waves} {name}: "
                                         "kernel and plain version differ")
                row[f"ms_{name}"] = cuda_ms(lambda: scan(qd), REPS)  # noqa: B023
                row[f"bound_share_{name}"] = bound_ms / row[f"ms_{name}"]
            log(json.dumps({"sweep": row}))
            results.append(row)
    if pack:
        # the lo plane alone (as if b were 8): what the hi plane and the
        # field-strided columns add to the scan
        def scan_lo():
            out_lo.zero_()
            kernels._respond_digits(qd2, db.lo, None, 0, out_lo, None)

        scan_lo()
        if not torch.equal(out_lo, want[0]):
            raise AssertionError(f"digits_sweep 2^{log_n} lo plane alone: kernel and plain version differ")
        log(json.dumps({"lo_plane_alone_ms": cuda_ms(scan_lo, REPS), "height": log_n,
                        "bound_ms": (db.lo.numel() + qd2.numel() + 4 * out_lo.numel()) / CARD_BYTES_PER_S * 1e3}))
    # what the zeroing of the outputs inside each timed call costs
    log(json.dumps({"zeroing_ms": cuda_ms(lambda: (out_lo.zero_(), out_hi.zero_() if pack else None), REPS),
                    "height": log_n}))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heights", type=int, nargs="+", default=[20, 23])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("digits_sweep: no CUDA device", file=sys.stderr)
        return 1
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    log(f"device: {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for log_n in args.heights:
        sweep_height(log_n, device, gen, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
