"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, the plain
reference (pirbench/reference) works D out again from the benchmark's own
inputs at SAMPLED_COLS columns drawn from the seed, and with it:

- the filter parameters, which must equal the bytes the setup returned;
- HINT_ROWS rows of the hint at those columns, A . D, with A from the
  configuration's PRG: in ctr mode consecutive rows from a row drawn from
  the seed; in stream mode row 0, the last row and HINT_ROWS - 2 rows
  between drawn from the seed, so that the one serial XOF is squeezed
  whole (8.37 GB at 2^20), in a thread beside the reference's encode;
- every kept answer (a sample drawn from the seed of the window's
  answers) at those columns: q . D mod 2^32 of the query as it was sent;
- every value the window retrieved, which must equal the DB's.

Each number is a count of wrong words or values; every limit is 0, since
the arithmetic is exact mod 2^32. Requests that got no answer count too.
With `control`, the reference computed in float32 stands in for the
program's hint and answers.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .reference import fuse, keccak, pir

SAMPLED_COLS = 16
HINT_ROWS = 16
JUDGE = 3  # the seed's stream of the check's draws
STREAM_ROWS = 4  # the seed's stream of the stream-mode hint rows


def stream_hint_rows(seed: int) -> np.ndarray:
    """Row 0, the last row and HINT_ROWS - 2 rows between, drawn from the
    seed, rising."""
    inner = np.random.default_rng([seed, STREAM_ROWS]).choice(
        np.arange(1, pir.LWE_DIMENSION - 1), HINT_ROWS - 2, replace=False)
    return np.concatenate(([0], np.sort(inner), [pir.LWE_DIMENSION - 1]))


def timed(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def wrong_words(got, want: np.ndarray) -> int:
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def judge(ctx, keys: np.ndarray, values: np.ndarray, cfg: dict, b: int, setup_rng, seed: int,
          control: bool) -> dict:
    """{name: {"value", "limit", "compared"}} of every number compared."""
    rng = np.random.default_rng([seed, JUDGE])
    stream = cfg["prg_mode"] == "stream"
    with ThreadPoolExecutor(1) as pool:
        if stream:
            rows = stream_hint_rows(seed)
            a_job = pool.submit(timed, keccak.stream_rows, ctx.pir_seed, fuse.geometry(cfg["arity"], len(keys))[2],
                                rows)
        enc = pir.encode(keys, values, cfg["arity"], b, setup_rng, rng, SAMPLED_COLS, ctx.dev)
        checks = {"filter_params_wrong": (int(enc.params != ctx.fparams), 1)}
        if stream:
            a, ctx.a_rows_s = a_job.result()
        else:
            r0 = int(rng.integers(0, pir.LWE_DIMENSION - HINT_ROWS + 1))
            rows = np.arange(r0, r0 + HINT_ROWS)
            a, ctx.a_rows_s = timed(pir.a_rows, ctx.pir_seed, enc.m, r0, HINT_ROWS, ctx.dev)
    want = pir.product(a, enc.d, ctx.dev)
    if control:
        got = pir.product_float32(a, enc.d, ctx.dev)
    else:
        hint = pir.wire_matrix(ctx.hint)
        got = hint[rows][:, enc.cols] if hint.shape == (pir.LWE_DIMENSION, enc.c) else None
    checks["hint_words_wrong"] = (wrong_words(got, want), want.size)

    kept = [(q, r) for q, r in ctx.kept if q.shape == (enc.m,)]
    wrong = (len(ctx.kept) - len(kept)) * len(enc.cols)
    if kept:
        queries = np.stack([q for q, _ in kept])
        want = pir.product(queries, enc.d, ctx.dev)
        if control:
            got = pir.product_float32(queries, enc.d, ctx.dev)
        else:
            got = np.stack([r[enc.cols] if r.shape == (enc.c,) else np.zeros(len(enc.cols), np.uint32)
                            for _, r in kept])
        wrong += wrong_words(got, want)
    checks["response_words_wrong"] = (wrong, len(ctx.kept) * len(enc.cols))
    if not control and ctx.values:
        bad = sum(v is None or v != values[k].tobytes() for k, v in ctx.values)
        checks["values_wrong"] = (bad, len(ctx.values))
    checks["unanswered"] = (ctx.failed, ctx.attempted)
    return {name: {"value": value, "limit": 0, "compared": compared} for name, (value, compared) in checks.items()}


def correct(checks: dict) -> bool:
    """Every number within its limit, and every check had something to compare."""
    return all(c["value"] <= c["limit"] for c in checks.values()) and all(
        c["compared"] > 0 for name, c in checks.items() if name != "unanswered")
