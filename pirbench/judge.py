"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, the plain
reference (pirbench/reference) works D out again from the benchmark's own
inputs at SAMPLED_COLS columns drawn from the seed, and with it:

- the filter parameters, which must equal the bytes the setup returned;
- HINT_ROWS consecutive rows of the hint, from a row drawn from the seed,
  at those columns: A . D from the ctr PRG;
- every kept answer (a sample drawn from the seed of the window's
  answers) at those columns: q . D mod 2^32 of the query as it was sent;
- every value the window retrieved, which must equal the DB's.

Each number is a count of wrong words or values; every limit is 0, since
the arithmetic is exact mod 2^32. Requests that got no answer count too.
With `control`, the reference computed in float32 stands in for the
program's hint and answers.
"""

from __future__ import annotations

import numpy as np

from .reference import pir

SAMPLED_COLS = 16
HINT_ROWS = 16
JUDGE = 3  # the seed's stream of the check's draws


def wrong_words(got, want: np.ndarray) -> int:
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def judge(ctx, keys: np.ndarray, values: np.ndarray, cfg: dict, b: int, setup_rng, seed: int,
          control: bool) -> dict:
    """{name: {"value", "limit", "compared"}} of every number compared."""
    rng = np.random.default_rng([seed, JUDGE])
    enc = pir.encode(keys, values, cfg["arity"], b, setup_rng, rng, SAMPLED_COLS, ctx.dev)
    checks = {"filter_params_wrong": (int(enc.params != ctx.fparams), 1)}

    r0 = int(rng.integers(0, pir.LWE_DIMENSION - HINT_ROWS + 1))
    a = pir.a_rows(ctx.pir_seed, enc.m, r0, HINT_ROWS, ctx.dev)
    want = pir.product(a, enc.d, ctx.dev)
    if control:
        got = pir.product_float32(a, enc.d, ctx.dev)
    else:
        hint = pir.wire_matrix(ctx.hint)
        got = hint[r0 : r0 + HINT_ROWS][:, enc.cols] if hint.shape == (pir.LWE_DIMENSION, enc.c) else None
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
