"""The port's own host layer (chalametpir_tpu_torch: params, errors, core/,
native/, utils/kvdb, net/framing, and the hi-plane geometry of
ops/respond_packed) against the JAX package's modules it was copied from.
The same seeded numpy inputs go through both; every output is bytes or
integers, so the tolerance is exact equality. Each module is one test,
its checks the cases of that test."""

import asyncio

import numpy as np
import pytest

from chalametpir_tpu_torch import errors as port_errors
from chalametpir_tpu_torch import params as port_params
from chalametpir_tpu_torch.core import codec, encode_db, filter as bff, hashing, keccak, matrix_io, prg
from chalametpir_tpu_torch.native import engine
from chalametpir_tpu_torch.net import framing
from chalametpir_tpu_torch.ops import respond_packed
from chalametpir_tpu_torch.utils import kvdb


def _keys(rng, n):
    """n distinct random keys of 8-39 bytes (a filter cannot hold a key twice)."""
    keys: dict[bytes, None] = {}
    while len(keys) < n:
        keys[rng.bytes(int(rng.integers(8, 40)))] = None
    return list(keys)


def _db(seed, n, value_len=(1, 90)):
    from chalametpir_tpu.utils import generate_random_kv_database

    return generate_random_kv_database(n, rng=np.random.default_rng(seed), value_byte_len=value_len)


@pytest.mark.parametrize("case", ["values", "find_bit_len", "query_indicator"])
def test_params_match_jax(case):
    from chalametpir_tpu import params as jax_params

    if case == "values":
        names = [n for n in dir(jax_params) if n.isupper()]
        assert names and all(getattr(port_params, n) == getattr(jax_params, n) for n in names)
    elif case == "find_bit_len":
        for n in (1, 2, 100, 1 << 10, 1 << 16, 1 << 20, 1 << 23, 1 << 30):
            assert port_params.find_mat_elem_bit_len(n) == jax_params.find_mat_elem_bit_len(n)
        with pytest.raises(port_errors.KVDatabaseSizeTooLarge):
            port_params.find_mat_elem_bit_len(1 << 60)
    else:
        for b in range(4, 15):
            assert port_params.query_indicator(b) == jax_params.query_indicator(b)


@pytest.mark.parametrize("case", ["names", "hierarchy", "own_classes"])
def test_errors_match_jax(case):
    from chalametpir_tpu import errors as jax_errors

    def classes(mod):
        return {n: c for n, c in vars(mod).items() if isinstance(c, type) and issubclass(c, Exception)}

    port, jax = classes(port_errors), classes(jax_errors)
    if case == "names":
        assert set(port) == set(jax)
    elif case == "hierarchy":
        for name, cls in port.items():
            assert [b.__name__ for b in cls.__mro__] == [b.__name__ for b in jax[name].__mro__]
    else:
        assert all(port[n] is not jax[n] and not issubclass(port[n], jax["ChalametPIRError"]) for n in port)


@pytest.mark.parametrize("case", ["digest_one", "digest_batch", "mix256_scalar", "mix256_batch", "row_mask",
                                  "hash_batch_3", "hash_batch_4"])
def test_hashing_matches_jax(case, rng):
    from chalametpir_tpu.core import hashing as jax_hashing

    keys = _keys(rng, 64) + [b"", b"x"]
    seed = rng.bytes(32)
    digests = jax_hashing.hash_of_keys_batch(keys)
    h = rng.integers(0, 1 << 63, size=257, dtype=np.uint64)
    if case == "digest_one":
        assert all(np.array_equal(hashing.hash_of_key(k), jax_hashing.hash_of_key(k)) for k in keys)
    elif case == "digest_batch":
        assert np.array_equal(hashing.hash_of_keys_batch(keys), digests)
    elif case == "mix256_scalar":
        assert all(hashing.mix256(d, seed) == jax_hashing.mix256(d, seed) for d in digests)
    elif case == "mix256_batch":
        assert np.array_equal(hashing.mix256(digests, seed), jax_hashing.mix256(digests, seed))
    elif case == "row_mask":
        for b in (4, 9, 14, 32):
            assert np.array_equal(hashing.row_mask(int(h[0]), 300, b), jax_hashing.row_mask(int(h[0]), 300, b))
    else:
        fn = case
        for got, want in zip(getattr(hashing, fn)(h, 1 << 10, 1 << 14), getattr(jax_hashing, fn)(h, 1 << 10, 1 << 14)):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["geometry", "construct_3", "construct_4", "bytes_round_trip"])
def test_filter_matches_jax(case, rng):
    from chalametpir_tpu.core import filter as jax_filter
    from chalametpir_tpu.core import hashing as jax_hashing

    if case == "geometry":
        for arity in (3, 4):
            for n in (1, 2, 3, 100, 1000, 1 << 16, 1 << 20, 1 << 23):
                assert bff.filter_geometry(arity, n) == jax_filter.filter_geometry(arity, n)
        return
    if case == "bytes_round_trip":
        filt, *_ = jax_filter.construct_filter(jax_hashing.hash_of_keys_batch(_keys(rng, 50)), 3, 9, 100,
                                               np.random.default_rng(3))
        port = bff.BinaryFuseFilter.from_bytes(filt.to_bytes())
        assert port.to_bytes() == filt.to_bytes() and port.num_fingerprints == filt.num_fingerprints
        return
    arity = int(case[-1])
    digests = jax_hashing.hash_of_keys_batch(_keys(rng, 700))
    got = bff.construct_filter(digests, arity, 10, 100, np.random.default_rng(7))
    want = jax_filter.construct_filter(digests, arity, 10, 100, np.random.default_rng(7))
    assert got[0].to_bytes() == want[0].to_bytes()
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["encode_rows", "round_trip", "row_width"])
def test_codec_matches_jax(case, rng):
    from chalametpir_tpu.core import codec as jax_codec

    b = 9
    values = [rng.bytes(int(rng.integers(1, 120))) for _ in range(40)]
    digests = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    cols = codec.encoded_row_width(max(map(len, values)), b)
    if case == "row_width":
        for v in (1, 31, 32, 1000):
            for bb in (4, 9, 14):
                assert codec.encoded_row_width(v, bb) == jax_codec.encoded_row_width(v, bb)
    elif case == "encode_rows":
        assert np.array_equal(codec.encode_rows(digests, values, b, cols),
                              jax_codec.encode_rows(digests, values, b, cols))
    else:
        rows = jax_codec.encode_rows(digests, values, b, cols)
        for i in range(len(values)):
            assert codec.decode_kv_from_row(rows[i], b) == digests[i].tobytes() + values[i]


@pytest.mark.parametrize("case", ["turboshake", "batch", "permutation"])
def test_keccak_matches_jax(case, rng):
    from chalametpir_tpu.core import keccak as jax_keccak

    if case == "turboshake":
        for n in (0, 1, 167, 168, 169, 500):
            data = rng.bytes(n)
            assert keccak.turboshake128(data, 200) == jax_keccak.turboshake128(data, 200)
    elif case == "batch":
        msgs = rng.integers(0, 256, size=(9, 40), dtype=np.uint8)
        lengths = rng.integers(0, 41, size=9).astype(np.int64)
        assert np.array_equal(keccak.turboshake128_batch(msgs, lengths, 64),
                              jax_keccak.turboshake128_batch(msgs, lengths, 64))
    else:
        state = rng.integers(0, 1 << 63, size=(3, 25), dtype=np.uint64)
        assert np.array_equal(keccak.keccak_p(state.copy()), jax_keccak.keccak_p(state.copy()))


@pytest.mark.parametrize("case", ["to_bytes", "from_bytes", "compress", "decompress", "malformed"])
def test_matrix_io_matches_jax(case, rng):
    from chalametpir_tpu.core import matrix_io as jax_io

    mat = rng.integers(0, 1 << 32, size=(5, 37), dtype=np.uint32)
    if case == "to_bytes":
        assert matrix_io.matrix_to_bytes(mat) == jax_io.matrix_to_bytes(mat)
    elif case == "from_bytes":
        assert np.array_equal(matrix_io.matrix_from_bytes(jax_io.matrix_to_bytes(mat)), mat)
    elif case == "malformed":
        with pytest.raises(port_errors.ChalametPIRError):
            matrix_io.matrix_from_bytes(jax_io.matrix_to_bytes(mat)[:-1])
    else:
        for b in (4, 8, 9, 10, 14):
            small = rng.integers(0, 1 << b, size=(6, 53), dtype=np.uint32)
            packed = jax_io.row_wise_compress(small, b)
            if case == "compress":
                assert np.array_equal(matrix_io.row_wise_compress(small, b), packed)
            else:
                assert np.array_equal(matrix_io.row_wise_decompress(packed, b, 53), small)


@pytest.mark.parametrize("case", ["stream_rows", "ctr_rows", "expand_stream", "expand_ctr", "fp_block"])
def test_prg_matches_jax(case, rng):
    from chalametpir_tpu.core import prg as jax_prg

    seed = rng.bytes(32)
    rows, cols = 19, 301
    if case in ("stream_rows", "ctr_rows"):
        mode = case.split("_")[0]
        got = list(prg.iter_row_blocks(rows, cols, seed, 5, mode=mode))
        want = list(jax_prg.iter_row_blocks(rows, cols, seed, 5, mode=mode))
        assert [r for r, _ in got] == [r for r, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
        prefetched = list(prg.prefetch_iter(prg.iter_row_blocks(rows, cols, seed, 5, mode=mode)))
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(prefetched, want))
    elif case.startswith("expand"):
        mode = case.split("_")[1]
        assert np.array_equal(prg.expand_seed(rows, cols, seed, mode=mode),
                              jax_prg.expand_seed(rows, cols, seed, mode=mode))
    else:
        for col0, n in ((0, 3), (5, 7), (97, 2)):
            assert np.array_equal(prg.expand_fp_block(1774, col0, n, seed),
                                  jax_prg.expand_fp_block(1774, col0, n, seed))


@pytest.mark.parametrize("case", ["matrix", "streaming", "empty_value"])
def test_encode_db_matches_jax(case):
    from chalametpir_tpu.core import encode_db as jax_encode

    db = _db(11, 600)
    if case == "empty_value":
        with pytest.raises(ValueError):
            encode_db.from_kv_database({b"k": b""}, 3, 9)
        return
    want, want_filt = jax_encode.from_kv_database(db, 3, 9, rng=np.random.default_rng(5))
    if case == "matrix":
        got, filt = encode_db.from_kv_database(db, 3, 9, rng=np.random.default_rng(5))
    else:
        got, filt, chunks = encode_db.from_kv_database_streaming(db, 3, 9, 256, rng=np.random.default_rng(5))
        assert list(chunks) == list(range(got.shape[0] // 256))
        got = got[: want.shape[0]]
    assert filt.to_bytes() == want_filt.to_bytes()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["packed_planes_u16", "packed_planes_u32", "ctr_expand", "hash_keys",
                                  "chacha8_ternary", "ternary_matvec", "xof_stream"])
def test_native_engine_matches_jax(case, rng):
    from chalametpir_tpu.native import engine as jax_engine

    if case.startswith("packed_planes"):
        dtype = np.uint16 if case.endswith("u16") else np.uint32
        for b in (8, 9, 10, 12, 14):
            mat = rng.integers(0, 1 << b, size=(300, 150)).astype(dtype)
            pack, bits, _ = respond_packed.pack_geometry(b, 256)
            got = engine.build_packed_planes(mat, 2048, 256, pack, bits)
            want = jax_engine.build_packed_planes(mat, 2048, 256, pack, bits)
            for a, w in zip(got, want):
                assert (a is None and w is None) or np.array_equal(a, w)
    elif case == "ctr_expand":
        seed = rng.bytes(32)
        for block0 in (0, 0xFFFFFFF0, (1 << 33) + 5):
            assert np.array_equal(engine.ctr_expand(seed, block0, 40), jax_engine.ctr_expand(seed, block0, 40))
    elif case == "hash_keys":
        keys = _keys(rng, 30) + [b"", b"x"]
        assert np.array_equal(engine.hash_keys(keys), jax_engine.hash_keys(keys))
    elif case == "chacha8_ternary":
        entropy = rng.bytes(32)
        assert np.array_equal(engine.chacha8_ternary(entropy, 1774), jax_engine.chacha8_ternary(entropy, 1774))
    elif case == "ternary_matvec":
        codes = rng.integers(0, 3, size=40).astype(np.int8)
        mat = rng.integers(0, 1 << 32, size=(40, 77), dtype=np.uint32)
        assert np.array_equal(engine.ternary_matvec(codes, mat), jax_engine.ternary_matvec(codes, mat))
    else:
        seed = rng.bytes(32)
        assert np.array_equal(engine.XofStream(seed).squeeze(1000), jax_engine.XofStream(seed).squeeze(1000))


@pytest.mark.parametrize("case", ["turboshake128", "encode_rows", "assemble_rows", "decrypt_decode_row",
                                  "client_process_response", "recover_value"])
def test_remaining_native_bindings_match_jax(case, rng):
    """The bindings the port's engine.py lacked though its engine.cpp had
    their symbols, and core/encode_db.recover_value: each against the JAX
    package's on the same bytes."""
    from chalametpir_tpu.core import encode_db as jax_encode
    from chalametpir_tpu.native import engine as jax_engine

    b, arity = 10, 3
    db = _db(23, 400)
    keys, values = list(db), list(db.values())
    digests = hashing.hash_of_keys_batch(keys)
    digest_bytes = np.ascontiguousarray(digests).view(np.uint8).reshape(len(keys), 32)
    cols = codec.encoded_row_width(max(map(len, values)), b)
    if case == "turboshake128":
        for data, n in ((b"", 1), (b"abc", 32), (rng.bytes(500), 1000)):
            assert engine.turboshake128(data, n) == jax_engine.turboshake128(data, n)
        assert engine.turboshake128(b"abc", 200)[:32] == keccak.turboshake128(b"abc", 32)
    elif case == "encode_rows":
        got = engine.encode_rows(digest_bytes, values, b, cols)
        assert got.dtype == np.uint32 and np.array_equal(got, jax_engine.encode_rows(digest_bytes, values, b, cols))
        assert np.array_equal(got, codec.encode_rows(digest_bytes, values, b, cols))
        with pytest.raises(ValueError):
            engine.encode_rows(digest_bytes, values, b, cols - 8)
    elif case == "assemble_rows":
        filt, reverse_order, reverse_h, key_index = bff.construct_filter(digests, arity, b, 100, np.random.default_rng(5))
        enc = engine.encode_rows(digest_bytes[key_index], [values[i] for i in key_index], b, cols)
        geometry = dict(arity=filt.arity, seg_len=filt.segment_length, seg_cnt_len=filt.segment_count_length)
        mats = []
        for eng in (engine, jax_engine):
            mat = np.zeros((filt.num_fingerprints, cols), np.uint32)
            assert eng.assemble_rows(mat, enc, reverse_order, reverse_h, None, b, **geometry) is mat
            mats.append(mat)
        assert np.array_equal(mats[0], mats[1]) and mats[0].any()
        fused = engine.encode_assemble_rows16(digest_bytes, values, key_index, reverse_order, reverse_h, b, cols,
                                              filt.num_fingerprints, filt.arity, filt.segment_length,
                                              filt.segment_count_length)
        assert np.array_equal(mats[0].astype(np.uint16), fused)
        with pytest.raises(ValueError):
            engine.assemble_rows(mats[0], enc, reverse_order, reverse_h, None, b, **{**geometry, "arity": 5})
    elif case == "recover_value":
        mat, filt = encode_db.from_kv_database(db, arity, b, rng=np.random.default_rng(5))
        for key in keys[:5]:
            assert encode_db.recover_value(mat, key, filt) == db[key] == jax_encode.recover_value(mat, key, filt)
        with pytest.raises(Exception) as port_exc:
            encode_db.recover_value(mat, b"not a key of this DB", filt)
        with pytest.raises(Exception) as jax_exc:
            jax_encode.recover_value(mat, b"not a key of this DB", filt)
        assert type(port_exc.value).__name__ == type(jax_exc.value).__name__
    else:
        # a real response and its unblinding vector, from the numpy oracle
        from chalametpir_tpu_torch import Client, Server

        seed = rng.bytes(32)
        server, hint, fparams = Server.setup(seed, db, arity=arity, backend="numpy", mat_elem_bit_len=b,
                                             rng=np.random.default_rng(5))
        client = Client.setup(seed, hint, fparams, device="cpu")
        key = keys[7]
        while True:
            try:
                query = client.query(key)
                break
            except port_errors.ArithmeticOverflowAddingQueryIndicator:
                continue
        resp = matrix_io.matrix_from_bytes(server.respond(query))[0]
        vec_c, filt = client._pending[key].vec_c, client._filter
        h = int(hashing.mix256(hashing.hash_of_key(key), filt.seed))
        noise = rng.integers(0, 1 << 32, size=resp.shape, dtype=np.uint32)
        if case == "decrypt_decode_row":
            kv = engine.decrypt_decode_row(resp, vec_c, b, h)
            assert kv == jax_engine.decrypt_decode_row(resp, vec_c, b, h)
            assert kv[:32] == digest_bytes[7].tobytes() and kv[32:] == db[key]
            assert engine.decrypt_decode_row(noise, vec_c, b, h) == jax_engine.decrypt_decode_row(noise, vec_c, b, h)
        else:
            got = engine.client_process_response(key, filt.seed, resp, vec_c, b)
            assert got == jax_engine.client_process_response(key, filt.seed, resp, vec_c, b) == db[key]
            for other_key, row in ((keys[8], resp), (key, noise)):
                assert engine.client_process_response(other_key, filt.seed, row, vec_c, b) == \
                    jax_engine.client_process_response(other_key, filt.seed, row, vec_c, b)
            assert engine.client_process_response(keys[8], filt.seed, resp, vec_c, b) in (-1, -2)
            with pytest.raises(ValueError):
                engine.client_process_response(key, b"short", resp, vec_c, b)
        assert client.process_response(key, server.respond(query)) == db[key]


@pytest.mark.parametrize("case", ["hi_bits", "hi_pack_factor"])
def test_hi_plane_geometry_matches_jax(case):
    from chalametpir_tpu.ops import packed

    assert all(getattr(respond_packed, case)(b) == getattr(packed, case)(b) for b in range(4, 15))


@pytest.mark.parametrize("case", ["fixture", "bounds"])
def test_kvdb_matches_jax(case):
    if case == "fixture":
        assert kvdb.generate_random_kv_database(50, rng=np.random.default_rng(2)) == _db(2, 50, (1, 512))
    else:
        db = kvdb.generate_random_kv_database(40, rng=np.random.default_rng(3), value_byte_len=(5, 6))
        assert all(16 <= len(k) <= 32 and 5 <= len(v) <= 6 for k, v in db.items())


@pytest.mark.parametrize("case", ["write", "read", "oversized"])
def test_framing_matches_jax(case):
    from chalametpir_tpu.net import framing as jax_framing

    class Sink:
        def __init__(self):
            self.data = b""

        def write(self, b):
            self.data += b

    payloads = [b"", b"x", bytes(range(256)) * 3]

    async def read(mod, data, max_len=framing.MAX_FRAME_LEN):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return [await mod.read_frame(reader, max_len) for _ in payloads]

    port_sink, jax_sink = Sink(), Sink()
    for p in payloads:
        framing.write_frame(port_sink, p)
        jax_framing.write_frame(jax_sink, p)
    if case == "write":
        assert port_sink.data == jax_sink.data
    elif case == "read":
        assert asyncio.run(read(framing, jax_sink.data)) == payloads
    else:
        with pytest.raises(ValueError):
            asyncio.run(read(framing, jax_sink.data, max_len=100))
