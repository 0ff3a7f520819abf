"""The stream PRG in the plain reference and the check: the serial XOF
against the published TurboSHAKE128 vectors, the stream matrix's rows
against the program's, a planted wrong hint word and an A that server
and client share wrongly both caught in the stream cell, and the ctr
cells' check drawing the same rows as before."""

import json
import os

import numpy as np
import pytest

from pirbench import harness, judge
from pirbench.reference import keccak, pir

SEED = 2**31 + 11
# draft-irtf-cfrg-kangarootwelve: TurboSHAKE128(M, D = 0x1F)
VECTORS = [
    (b"", 32, 0, "1e415f1c5983aff2169217277d17bb538cd945a397ddec541f1ce41af2c1b74c"),
    (b"\x00", 32, 0, "55cedd6f60af7bb29a4042ae832ef3f58db7299f893ebb9247247d856958daa9"),
    (b"", 10032, 10000, "a3b9b0385900ce761f22aed548e754da10a5242d62e8c658e3f3a923a7555607"),
]


@pytest.mark.parametrize("msg,out_len,start,want", VECTORS, ids=["empty", "ptn1", "empty_10032"])
def test_xof_words_meet_the_published_vectors(msg, out_len, start, want):
    words = keccak.xof_words(msg, out_len // 4)
    assert words.dtype == np.uint32 and words.shape == (out_len // 4,)
    assert words.astype("<u4").tobytes()[start:].hex() == want


def small_db(n: int, value_len: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    values = rng.integers(0, 256, (n, value_len), dtype=np.uint8)
    db = dict(zip(keys.view("V32").ravel().tolist(), values.view(f"V{value_len}").ravel().tolist()))
    return db, keys, values


def test_stream_rows_match_the_programs_a_and_hint():
    """Every row of A at 2^10, then rows spread over it: they cross the
    server's 16-row fold blocks and the client's 64-row blocks."""
    from chalametpir_tpu_torch import Server
    from chalametpir_tpu_torch.core import prg

    n, b = 1 << 10, 9
    db, keys, values = small_db(n, 96, 18)
    seed = bytes(range(100, 132))
    server, hint, fparams = Server.setup(seed, db, arity=3, prg_mode="stream", rng=np.random.default_rng(3),
                                         mat_elem_bit_len=b, device="cpu")
    enc = pir.encode(keys, values, 3, b, np.random.default_rng(3), np.random.default_rng(4), 16, "cpu")
    assert enc.params == fparams
    every = np.arange(pir.LWE_DIMENSION)
    a = keccak.stream_rows(seed, enc.m, every)
    assert np.array_equal(a, prg.expand_seed(pir.LWE_DIMENSION, enc.m, seed, mode="stream"))
    assert np.array_equal(pir.wire_matrix(hint)[:, enc.cols], pir.product(a, enc.d))
    rows = judge.stream_hint_rows(SEED)
    assert np.array_equal(keccak.stream_rows(seed, enc.m, rows), a[rows])
    for bad in ([3, 3], [5, 2], [-1]):
        with pytest.raises(ValueError):
            keccak.stream_rows(seed, enc.m, bad)


def test_the_stream_rows_span_a():
    rows = judge.stream_hint_rows(SEED)
    assert len(rows) == judge.HINT_ROWS and rows[0] == 0 and rows[-1] == pir.LWE_DIMENSION - 1
    assert np.all(np.diff(rows) > 0)
    assert np.array_equal(rows, judge.stream_hint_rows(SEED))
    assert not np.array_equal(rows, judge.stream_hint_rows(SEED + 1))


def hint_cols(cell: str, seed: int) -> np.ndarray:
    """The columns the check draws from the seed (judge.judge)."""
    cfg = harness.Cell(cell).cfg
    c = pir.row_width(cfg["value_len"], cfg["b"])
    rng = np.random.default_rng([seed, judge.JUDGE])
    return np.sort(rng.choice(c, size=judge.SAMPLED_COLS, replace=False)), rng


@pytest.mark.parametrize("at", [0, 7, -1], ids=["row0", "drawn", "last"])
def test_an_altered_hint_word_is_caught(monkeypatch, at):
    from chalametpir_tpu_torch import Server

    cols, _ = hint_cols("stream-2p20-a3.lookup", SEED)
    row = int(judge.stream_hint_rows(SEED)[at])
    setup = Server.setup

    def broken(*args, **kwargs):
        server, hint, fparams = setup(*args, **kwargs)
        c = int(np.frombuffer(hint, "<u4", 2)[1])
        words = np.frombuffer(hint, "<u4", offset=8).copy()
        words[row * c + int(cols[3])] ^= 1 << 20
        return server, hint[:8] + words.tobytes(), fparams

    monkeypatch.setattr(harness, "warm_up", lambda cfg, dev: None)
    monkeypatch.setattr(Server, "setup", staticmethod(broken))
    result = harness.run("stream-2p20-a3.lookup", SEED, 1.0, False, device="cpu", log_n=10)
    assert result["checks"]["hint_words_wrong"]["compared"] == judge.HINT_ROWS * judge.SAMPLED_COLS
    assert result["checks"]["hint_words_wrong"]["value"] >= 1
    assert result["correct"] is False


def test_an_a_that_server_and_client_share_is_caught_past_2_to_the_32_bytes(monkeypatch):
    """Both sides squeeze A through the program's one row-block iterator;
    a fault there past the 2^20 cell's 2^32-byte mark (row 910) leaves
    them agreeing, and every value decodes, so only the hint's rows deep
    in the stream can see it."""
    from chalametpir_tpu_torch.core import prg

    rows_of = prg.iter_row_blocks

    def shifted(rows, cols, seed, block_rows, mode="stream"):
        for r0, block in rows_of(rows, cols, seed, block_rows, mode):
            if r0 + len(block) > 911:
                block = block.copy()
                block[max(0, 911 - r0):] += np.uint32(1)
            yield r0, block

    monkeypatch.setattr(harness, "warm_up", lambda cfg, dev: None)
    monkeypatch.setattr(prg, "iter_row_blocks", shifted)
    result = harness.run("stream-2p20-a3.lookup", SEED, 1.0, False, device="cpu", log_n=10)
    assert result["checks"]["values_wrong"]["value"] == 0
    assert result["checks"]["values_wrong"]["compared"] > 0
    assert result["checks"]["hint_words_wrong"]["value"] >= judge.SAMPLED_COLS
    assert result["correct"] is False


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
                                  ["workloads"] if w["name"].startswith("ctr-2p20")])
def test_the_ctr_check_compares_the_rows_it_compared_before(monkeypatch, cell):
    """The draws of the check before the stream mode: 16 columns, then a
    row r0 in 0 .. 1758, then rows r0 .. r0 + 15 of the ctr matrix."""
    from chalametpir_tpu_torch.core import prg

    calls = []
    a_rows = pir.a_rows

    def recorded(seed, m, r0, count, device):
        out = a_rows(seed, m, r0, count, device)
        calls.append((seed, m, r0, count, out))
        return out

    monkeypatch.setattr(pir, "a_rows", recorded)
    result = harness.run(cell, SEED, 0.5, False, device="cpu", log_n=10)
    assert result["correct"] is True
    assert result["checks"]["hint_words_wrong"]["compared"] == 16 * judge.SAMPLED_COLS
    _, rng = hint_cols(cell, SEED)
    want_r0 = int(rng.integers(0, pir.LWE_DIMENSION - 16 + 1))
    [(seed, m, r0, count, out)] = calls
    assert (r0, count) == (want_r0, 16)
    assert seed == np.random.default_rng([SEED, harness.PIR_SEED]).bytes(32)
    assert np.array_equal(out, prg.expand_seed(pir.LWE_DIMENSION, m, seed, mode="ctr")[r0 : r0 + 16])
