"""The plain reference against the program at 2^10 entries on the CPU,
the frozen work counts against the values the repository recorded, and
the imports of the harness and the reference."""

import ast
import os

import numpy as np
import pytest

from pirbench import workcount
from pirbench.reference import fuse, keccak, pir

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "chalametpir_tpu"}


def small_db(n: int, value_len: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    values = rng.integers(0, 256, (n, value_len), dtype=np.uint8)
    db = dict(zip(keys.view("V32").ravel().tolist(), values.view(f"V{value_len}").ravel().tolist()))
    return db, keys, values


@pytest.mark.parametrize("arity,b", [(3, 9), (3, None), (4, 9), (4, None)])
def test_reference_encode_and_hint_match_the_program(arity, b):
    from chalametpir_tpu_torch import Server

    n = 1 << 10
    db, keys, values = small_db(n, 96, arity * 100 + (b or 0))
    b = b or pir.element_bits(n)
    seed = bytes(range(32))
    server, hint, fparams = Server.setup(seed, db, arity=arity, prg_mode="ctr", rng=np.random.default_rng(3),
                                         mat_elem_bit_len=b, device="cpu")
    enc = pir.encode(keys, values, arity, b, np.random.default_rng(3), np.random.default_rng(4), 16, "cpu")
    assert enc.params == fparams
    assert (enc.m, enc.c) == (server.num_query_cols, server.num_response_cols)

    a = pir.a_rows(seed, enc.m, 1000, 16, "cpu")
    assert np.array_equal(pir.wire_matrix(hint)[1000:1016][:, enc.cols], pir.product(a, enc.d))

    queries = np.random.default_rng(5).integers(0, 1 << 32, size=(3, enc.m), dtype=np.uint32)
    answers = server.respond_batch(queries)
    assert np.array_equal(answers[:, enc.cols], pir.product(queries, enc.d))


def test_reference_hashes_match_the_program():
    from chalametpir_tpu_torch.core import hashing, prg

    keys = np.random.default_rng(1).integers(0, 256, (64, 32), dtype=np.uint8)
    want = hashing.hash_of_keys_batch([k.tobytes() for k in keys])
    assert np.array_equal(keccak.key_digests(keys, "cpu"), want)
    seed = bytes(range(32, 64))
    assert np.array_equal(fuse.mix256(want, seed), hashing.mix256(want, seed))
    blocks = keccak.ctr_blocks(seed, np.arange(5, 9), "cpu")
    assert np.array_equal(blocks, prg._ctr_blocks(seed, 5, 4))


def test_control_in_float32_is_wrong_where_the_reference_is_exact():
    rng = np.random.default_rng(2)
    q = rng.integers(0, 1 << 32, size=(4, 4096), dtype=np.uint32)
    d = rng.integers(0, 1 << 9, size=(4096, 8), dtype=np.uint32)
    exact = pir.product(q, d)
    assert np.array_equal(exact, ((q.astype(object) @ d.astype(object)) % (1 << 32)).astype(np.uint32))
    assert np.count_nonzero(pir.product_float32(q, d, "cpu") != exact) == exact.size


@pytest.mark.parametrize("log_n,nq,want_ms,want_by", [
    (20, 1, 0.407, "bytes"), (20, 64, 0.547, "operations"), (21, 1, 0.814, "bytes")])
def test_bound_ms_is_pinned(log_n, nq, want_ms, want_by):
    m = fuse.geometry(3, 1 << log_n)[2]
    g = workcount.plane_geometry(m, pir.row_width(1024, 9), 9)
    ms, by = workcount.bound_ms(nq, g["m"], g["c_pad"], g["plane_bytes"], g["b"])
    assert (round(ms, 3), by) == (want_ms, want_by)


def imported_top_names(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    base = os.path.join(HERE, *parts)
    for dirpath, _, files in os.walk(base):
        if os.path.basename(dirpath) != "tests":
            yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    """The Python modules import the standard library, numpy and torch
    alone (ctypes, os, subprocess and hashlib build and load xof.c), and
    the C source includes stdint.h alone."""
    allowed = {"__future__", "math", "struct", "dataclasses", "numpy", "torch", "ctypes", "hashlib", "os",
               "subprocess"}
    for path in sources("reference"):
        assert imported_top_names(path) <= allowed, path
    c_files = [f for f in os.listdir(os.path.join(HERE, "reference")) if f.endswith(".c")]
    assert c_files == ["xof.c"]
    with open(os.path.join(HERE, "reference", "xof.c")) as f:
        includes = {line.split()[1] for line in f if line.startswith("#include")}
    assert includes == {"<stdint.h>"}
