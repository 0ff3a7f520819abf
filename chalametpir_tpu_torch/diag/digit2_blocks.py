"""The digit2 hint fold at several block sizes, side by side.

    python -m chalametpir_tpu_torch.diag.digit2_blocks [--log-n 20] [--seed 0]

Needs a CUDA device. Synthetic digit planes of the 2^LOG_N-entry, 1 kB
geometry (random int8 of the planes' ranges), a random block of R rows of
A on the card, and `matmul_u32.digit_matmul_accumulate` timed with CUDA
events for each R: one JSON line per R with the fold's ms, its ms per row
of A, what the 1774 rows of a hint would take at that rate, and the
device bytes one block holds (the u32 words and their digit rows). The
smallest R is checked against the uint64 numpy product on its first 64
columns. `models.server.DIGIT2_BLOCK_BYTES` was chosen from this table.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BLOCK_ROWS = (3, 8, 32, 128, 227, 512, 1024)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("digit2_blocks: no CUDA device")
    from chalametpir_tpu_torch.diag.scan_qd import Geometry, cuda_ms
    from chalametpir_tpu_torch.ops import matmul_u32
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    dev = torch.device("cuda")
    geo = Geometry.of(args.log_n)
    m, c = geo.m, geo.cols
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (-(-m // 8) * 8, -(-c // 8) * 8)
    d0 = torch.zeros(shape, dtype=torch.int8, device=dev)
    d1 = torch.zeros(shape, dtype=torch.int8, device=dev)
    d0[:m, :c] = torch.randint(-128, 128, (m, c), dtype=torch.int8, device=dev, generator=gen)
    d1[:m, :c] = torch.randint(0, 1 << max(geo.b - 8, 0), (m, c), dtype=torch.int8, device=dev, generator=gen)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "log_n": args.log_n, "m": m, "c": c, "b": geo.b}),
          flush=True)
    for r in BLOCK_ROWS:
        a = torch.randint(-(1 << 31), 1 << 31, (r, m), dtype=torch.int32, device=dev, generator=gen)
        acc = torch.zeros((r, shape[1]), dtype=torch.int32, device=dev)
        fold = lambda: matmul_u32.digit_matmul_accumulate(acc, a, d0, d1)  # noqa: E731
        if r == BLOCK_ROWS[0]:
            d = d0[:m, :64].cpu().numpy().astype(np.int64) + 256 * d1[:m, :64].cpu().numpy().astype(np.int64)
            want = matmul_u32.matmul_u32_np(a.cpu().numpy().view(np.uint32), d.astype(np.uint32))
            if not np.array_equal(fold()[:, :64].cpu().numpy().view(np.uint32), want):
                raise AssertionError("the digit2 fold disagrees with the uint64 product")
        ms = cuda_ms(fold, 5)
        print(json.dumps({"block_rows": r, "ms": round(ms, 3), "ms_per_row": round(ms / r, 4),
                          "hint_s": round(ms / r * LWE_DIMENSION / 1e3, 2),
                          "block_device_bytes": 8 * r * shape[0]}), flush=True)
        del a, acc
    return 0


if __name__ == "__main__":
    sys.exit(main())
