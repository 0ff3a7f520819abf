"""The port's call surface against the JAX package's, module by module.

Every module of chalametpir_tpu has its counterpart in chalametpir_tpu_torch
under the same name, or under the name DECIDED gives it. For every public
name a JAX module defines or re-exports (its classes and functions, and
its plain data constants) the counterpart has the name, a constant with an
equal value. For every public function, class and method (inherited ones
included) the JAX positional parameters are a prefix of the port's, by
name and order, with equal defaults; every further positional parameter of
the port (`device`, `out`) has a default, and every JAX keyword-only
parameter is there with its default. So a caller of the JAX package makes
the same call, positional order included, through the port. The tests at
the end make such calls through both packages and compare the bytes.

DECIDED is the one table of the differences the port keeps, each with its
reason. A difference that is not in it fails, and so does an entry that no
longer differs. Its keys and kinds:

* "chalametpir_tpu.x.y" ("module"): the port module that stands for a JAX
  module, or None where there is none;
* "chalametpir_tpu.x.y:Name" or ":Class.method", under the module that
  defines the name (its re-exports share the entry): "rename" (the port's
  name; the object has the port's own signature), "absent", "drops" (JAX
  parameters the port does not take), "default" (JAX parameters whose
  defaults differ);
* "chalametpir_tpu.x.y:Name[what]" ("behaviour"): a difference in what a
  call does, with the test that pins it (the test fails when the
  difference goes);
* "tests/<file>::<test id>" ("protocol"): a test of the JAX package's
  client-protocol suites that does not pass through the port, with the
  exception it ends in (tests/test_torch_protocol_parity.py runs them).

The JAX package is imported inside the tests, so `make check-cuda`
(`--noconftest`, on a host without jax) still collects this file.
"""

from __future__ import annotations

import __future__
import ast
import importlib
import importlib.util
import inspect
import pkgutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

JAX = "chalametpir_tpu"
PORT = "chalametpir_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent

_TPU_KNOBS = (
    "the TPU grid's tiling and the Pallas interpreter switch: the CUDA kernels choose their "
    "geometry (kernels.choose_regime, kernels.digit_geometry) and the CPU runs the plain version"
)
_DEVICE_DEFAULT = (
    '"cuda" where the JAX client says "auto": the port takes its device once, as asked, and '
    "never falls back"
)

DECIDED: dict[str, tuple[str, object, str]] = {
    # modules
    "chalametpir_tpu.ops.prg_jax": (
        "module", "chalametpir_tpu_torch.ops.prg_torch", "ctr A generated on torch, not on jax"),
    "chalametpir_tpu.ops.respond_pallas": (
        "module", "chalametpir_tpu_torch.ops.respond_packed", "the packed respond on a CUDA kernel, not Pallas"),
    "chalametpir_tpu.utils.compile_cache": (
        "module", None, "an XLA compile cache: the port compiles nothing per shape, and its kernels and "
        "native engine build once into the digest-keyed _build/ (kernels.build, native.engine.build)"),
    "chalametpir_tpu.native.libchalametpir_native": (
        "module", None, "the JAX native engine's shared library, loaded by ctypes and not a Python "
        "module; the port's builds into _build/"),
    # names
    "chalametpir_tpu.ops.respond_pallas:PallasDB": (
        "rename", "PackedPlanes", "the same plane bytes as torch tensors, with no TPU tile field"),
    "chalametpir_tpu.ops.respond_pallas:build_pallas_db": (
        "rename", "build_packed_db", "packs into torch tensors on a named device"),
    "chalametpir_tpu.ops.respond_pallas:DEFAULT_TILE_K": (
        "rename", "M_ALIGN", "a TPU tile; the port keeps only its role, the planes' row alignment"),
    "chalametpir_tpu.ops.digits:recode_u32_jnp": (
        "rename", "recode_u32", "the digit recode on torch tensors"),
    "chalametpir_tpu.ops.prg_jax:ctr_blocks_u32": (
        "rename", "ctr_blocks_ref", "the plain version of the ctr Keccak kernel, on 64-bit lanes"),
    "chalametpir_tpu.ops.prg_jax:ctr_blocks_pallas": (
        "rename", "ctr_blocks", "the kernel's wrapper: CUDA on a card, the plain version on the CPU"),
    "chalametpir_tpu.ops.prg_jax:expand_fp_slab_device": (
        "rename", "expand_fp_slab", "every slab of the port is made on a named torch device"),
    "chalametpir_tpu.utils.compile_cache:enable_compile_cache": (
        "absent", None, "see chalametpir_tpu.utils.compile_cache"),
    # parameters
    "chalametpir_tpu.ops.respond_pallas:respond_packed_core": ("drops", ("tile_k", "interpret"), _TPU_KNOBS),
    "chalametpir_tpu.ops.respond_pallas:respond_batch_packed": ("drops", ("interpret",), _TPU_KNOBS),
    "chalametpir_tpu.ops.respond_pallas:hint_fold_partial": (
        "drops", ("tile_k", "rgroup", "interpret"), _TPU_KNOBS + "; all rows fold in one launch"),
    "chalametpir_tpu.models.client:Client.setup": ("default", ("device",), _DEVICE_DEFAULT),
    "chalametpir_tpu.models.client:Client.load": ("default", ("device",), _DEVICE_DEFAULT),
    "chalametpir_tpu.net.client:fetch": ("default", ("device",), _DEVICE_DEFAULT),
    "chalametpir_tpu.ops.client_device:DeviceQueryEngine": (
        "default", ("layout",), '"mk", the layout of the port\'s own constructors; the JAX engine has no '
        "default, so every JAX call names the layout and means the same"),
    # behaviour
    "chalametpir_tpu.ops.client_device:DeviceQueryEngine[layout='km']": (
        "behaviour", "tests/test_torch_api_parity.py::test_km_planes_are_laid_out_fingerprint_major",
        '"km" planes are relaid fingerprint-major once, at construction, and `layout` reads "mk": '
        "torch._int_mm wants its second operand column-major, so the products keep one layout"),
    "chalametpir_tpu.models.server:Server[backend='jax']": (
        "behaviour", "tests/test_torch_api_parity.py::test_server_backend_names",
        'the device backend is "torch"; "jax" raises ValueError naming it, in the constructor and in '
        "setup; archives still say \"jax\" for a device server, so each package loads the other's"),
    "chalametpir_tpu.models.server:Server.setup[backend='jax']": (
        "behaviour",
        "tests/test_torch_backends.py::test_unknown_names_raise_what_and_when_the_jax_server_raises",
        "as for the constructor"),
    "chalametpir_tpu.models.server:Server.setup[layout='auto']": (
        "behaviour", "tests/test_torch_backends.py::test_auto_layout_stays_packed_and_serves_the_jax_bytes",
        "packed at every element width, b 13-14 included, where the JAX package takes digit2: the "
        "packed kernel serves every b; the same hint and responses"),
    "chalametpir_tpu.models.server:Server.setup[device='cuda']": (
        "behaviour", "tests/test_torch_slice.py::test_cuda_request_without_cuda_raises",
        "a CUDA request without CUDA raises AcceleratorError: no fallback to the CPU"),
    "chalametpir_tpu.net.server:BatchDispatcher[pad_batches=None]": (
        "behaviour", "tests/test_torch_parity_repairs.py::test_pad_batches_is_accepted_and_off_by_default",
        "None pads nothing on any backend: the JAX package pads for its jax backend, which compiles "
        "per batch shape, and no backend of the port does"),
    # the JAX client-protocol suites through the port
    "tests/test_prg_modes.py::test_ctr_device_matches_host": (
        "protocol", "ImportError",
        "ops.prg_jax is ops.prg_torch, and expand_fp_slab_device is expand_fp_slab with a device "
        "(tests/test_torch_prg.py holds them to the JAX functions)"),
    "tests/test_pir_integration.py::test_malformed_response_error_type_matches_native": (
        "protocol", "AttributeError",
        "a missing native engine raises in the port, where the JAX package falls back to numpy"),
    "tests/test_persistence.py::test_save_load_from_sharded_server": (
        "protocol", "AcceleratorError",
        "make_mesh() takes the visible CUDA devices, and there are none on the CPU (the port's "
        "sharded save and load run in tests/test_torch_sharding.py on meshes of CPU devices)"),
}

KINDS = ("module", "rename", "absent", "drops", "default", "behaviour", "protocol")


def _module_names(root: Path, name: str) -> list[str]:
    """`name` and every module below it, found on disk without importing
    any (pkgutil over the package's directories)."""
    names = [name]
    for info in pkgutil.iter_modules([str(root)], name + "."):
        if info.ispkg:
            names += _module_names(root / info.name.rsplit(".", 1)[1], info.name)
        else:
            names.append(info.name)
    return names


MODULES = sorted(set(_module_names(ROOT / JAX, JAX)) | {k for k, v in DECIDED.items() if v[0] == "module"})


def _port_module_name(name: str) -> str | None:
    entry = DECIDED.get(name)
    return entry[1] if entry else PORT + name[len(JAX):]


def _is_constant(obj) -> bool:
    return isinstance(obj, (bool, int, float, str, bytes, tuple, frozenset)) or obj is None


def _public(module) -> dict:
    """name -> object for the names the module defines or re-exports: its
    package's classes and functions, and plain data constants. What it
    imports from elsewhere (numpy, jax, the standard library) is not its
    surface."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType) or obj is __future__.annotations:
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if (obj.__module__ or "").split(".")[0] != JAX:
                continue
        elif not _is_constant(obj):
            continue
        out[name] = obj
    return out


def _key(module_name: str, name: str, obj) -> str:
    """The table key of `name`: under the module that defines the object."""
    origin = getattr(obj, "__module__", None) if (inspect.isclass(obj) or inspect.isfunction(obj)) else None
    return f"{origin or module_name}:{name}"


def _params(fn) -> list[inspect.Parameter] | None:
    try:
        return list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):  # a builtin without a signature
        return None


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    return type(a) is type(b) and a == b


def signature_problems(jax_fn, port_fn, drops=(), defaults=()) -> list[str]:
    """What keeps a JAX-style call of `jax_fn` from meaning the same
    through `port_fn`, with the parameters in `drops` taken out of the JAX
    signature and the defaults of those in `defaults` not compared."""
    jp, pp = _params(jax_fn), _params(port_fn)
    if jp is None or pp is None:
        return []
    jp = [p for p in jp if p.name not in drops]
    jpos = [p for p in jp if p.kind in _POSITIONAL]
    ppos = [p for p in pp if p.kind in _POSITIONAL]
    problems = []
    if [p.name for p in ppos[: len(jpos)]] != [p.name for p in jpos]:
        problems.append(f"positional {[p.name for p in jpos]} is no prefix of {[p.name for p in ppos]}")
    else:
        for j, p in zip(jpos, ppos):
            if j.name not in defaults and not _same_default(j.default, p.default):
                problems.append(f"default of {j.name}: {j.default!r} against {p.default!r}")
    problems += [f"{p.name} has no default" for p in ppos[len(jpos):] if p.default is inspect.Parameter.empty]
    port_by_name = {p.name: p for p in pp}
    for j in jp:
        if j.kind is inspect.Parameter.KEYWORD_ONLY:
            p = port_by_name.get(j.name)
            if p is None or p.kind is inspect.Parameter.POSITIONAL_ONLY:
                problems.append(f"keyword {j.name} missing")
            elif j.name not in defaults and not _same_default(j.default, p.default):
                problems.append(f"default of {j.name}: {j.default!r} against {p.default!r}")
        elif j.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            if not any(p.kind is j.kind for p in pp):
                problems.append(f"*{j.name} missing")
    return problems


def _check_callable(key: str, jax_fn, port_fn, failures: list[str]) -> None:
    entry = DECIDED.get(key)
    kind, detail = (entry[0], entry[1]) if entry else (None, ())
    drops = detail if kind == "drops" else ()
    defaults = detail if kind == "default" else ()
    problems = signature_problems(jax_fn, port_fn, drops, defaults)
    if problems:
        failures.append(f"{key}: " + "; ".join(problems))
    port_names = {p.name: p for p in _params(port_fn) or ()}
    jax_names = {p.name: p for p in _params(jax_fn) or ()}
    if kind == "drops" and any(n in port_names for n in drops):
        failures.append(f"{key}: stale entry, the port takes {[n for n in drops if n in port_names]}")
    if kind == "default" and all(
        _same_default(jax_names[n].default, port_names[n].default) for n in defaults
    ):
        failures.append(f"{key}: stale entry, the defaults of {list(defaults)} are equal")


def _check_class(key: str, jax_cls, port_cls, failures: list[str]) -> None:
    _check_callable(key, jax_cls, port_cls, failures)
    for attr in dir(jax_cls):
        if attr.startswith("_"):
            continue
        if not hasattr(port_cls, attr):
            failures.append(f"{key}.{attr}: missing")
            continue
        raw = inspect.getattr_static(jax_cls, attr)
        if isinstance(raw, (staticmethod, classmethod)) or inspect.isfunction(raw):
            _check_callable(f"{key}.{attr}", getattr(jax_cls, attr), getattr(port_cls, attr), failures)


@pytest.mark.parametrize("module_name", MODULES)
def test_module_surface(module_name):
    """The counterpart of one JAX module has its names, its constants'
    values and its call signatures, but for the entries of DECIDED."""
    port_name = _port_module_name(module_name)
    entry = DECIDED.get(module_name)
    if port_name is None:
        assert importlib.util.find_spec(PORT + module_name[len(JAX):]) is None, (
            f"stale entry: {module_name} has a port counterpart")
        return
    if entry is not None:
        assert importlib.util.find_spec(PORT + module_name[len(JAX):]) is None, (
            f"stale entry: the port also has {module_name}'s own name")
    jax_module = importlib.import_module(module_name)
    port_module = importlib.import_module(port_name)
    failures: list[str] = []
    for name, obj in _public(jax_module).items():
        key = _key(module_name, name, obj)
        kind, detail = DECIDED.get(key, (None, None, None))[:2]
        if kind == "absent":
            if hasattr(port_module, name):
                failures.append(f"{key}: stale entry, the port has it")
            continue
        if kind == "rename":
            if hasattr(port_module, name):
                failures.append(f"{key}: stale entry, the port has the JAX name")
            # a re-export of a renamed name lives on where it is defined
            home = port_module if key.startswith(module_name + ":") else importlib.import_module(
                _port_module_name(key.split(":")[0]))
            if not hasattr(home, detail):
                failures.append(f"{key}: the port has no {detail} in {home.__name__}")
            elif _is_constant(obj) and not _same_default(obj, getattr(home, detail)):
                failures.append(f"{key}: {obj!r} against {detail} = {getattr(home, detail)!r}")
            continue
        if not hasattr(port_module, name):
            failures.append(f"{key}: missing")
            continue
        port_obj = getattr(port_module, name)
        if inspect.isclass(obj):
            _check_class(key, obj, port_obj, failures)
        elif inspect.isfunction(obj):
            _check_callable(key, obj, port_obj, failures)
        elif not _same_default(obj, port_obj):
            failures.append(f"{key}: {obj!r} against {port_obj!r}")
    assert not failures, "\n".join(failures)


def test_every_jax_module_is_a_case():
    """The cases above are the modules pkgutil.walk_packages finds, and
    every key of the table is well formed and names what the JAX package
    has and what pins it."""
    import chalametpir_tpu

    walked = {m.name for m in pkgutil.walk_packages(chalametpir_tpu.__path__, JAX + ".")} | {JAX}
    assert walked <= set(MODULES), sorted(walked - set(MODULES))
    for key, (kind, detail, reason) in DECIDED.items():
        assert kind in KINDS and reason, key
        if kind == "behaviour":
            path, func = detail.split("::")
            tree = ast.parse((ROOT / path).read_text())
            assert any(isinstance(n, ast.FunctionDef) and n.name == func for n in tree.body), (
                f"{key}: {detail} does not exist")
        elif kind != "protocol":
            module, _, qual = key.partition(":")
            assert module in MODULES, f"{key}: no module {module}"
            obj = importlib.import_module(module) if qual else None
            for part in qual.split("[")[0].split(".") if qual else ():
                assert hasattr(obj, part), f"{key}: the JAX package has no {part} there"
                obj = getattr(obj, part)


def test_surface_checks_catch_what_they_should():
    """The checker itself: each kind of difference is reported."""
    def jax_fn(a, b, c=1, *, d=2):
        pass

    def same(a, b, c=1, d=2, device="cuda"):
        pass

    def reordered(b, a, c=1, *, d=2):
        pass

    def other_default(a, b, c=2, *, d=2):
        pass

    def required_extra(a, b, c=1, device=None, out=None, *, d=2, e):
        pass

    def needs_device(a, b, c, device, *, d=2):
        pass

    assert signature_problems(jax_fn, same) == []
    assert signature_problems(jax_fn, reordered)
    assert signature_problems(jax_fn, other_default)
    assert signature_problems(jax_fn, other_default, defaults=("c",)) == []
    assert signature_problems(jax_fn, lambda a, b, c=1: None)  # no keyword d
    assert signature_problems(jax_fn, needs_device)
    assert signature_problems(jax_fn, required_extra) == []
    assert signature_problems(lambda a, tile_k, interpret: None, lambda a, out=None: None,
                              drops=("tile_k", "interpret")) == []


# -- JAX-positional calls through both packages -------------------------------

def _db(n: int, seed: int):
    from chalametpir_tpu_torch.utils import generate_random_kv_database

    return generate_random_kv_database(n, rng=np.random.default_rng(seed), value_byte_len=(1, 48))


def _queries(g: np.random.Generator, q: int, m: int) -> np.ndarray:
    return g.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)


@pytest.mark.parametrize("call", ["numpy", "ctr_arity4"])
def test_setup_in_jax_positional_form(call):
    """Server.setup(seed, db, 3, "numpy") and Server.setup(seed, db, 4,
    "auto", "auto", "ctr") mean the JAX package's calls: the same hint,
    filter and responses (`device` as a keyword: the port's own, after the
    JAX parameters)."""
    import chalametpir_tpu

    from chalametpir_tpu_torch import Server

    db = _db(300, 3)
    seed = np.random.default_rng(4).bytes(32)
    args = (3, "numpy") if call == "numpy" else (4, "auto", "auto", "ctr")
    want_server, want_hint, want_filter = chalametpir_tpu.Server.setup(
        seed, db, *args, rng=np.random.default_rng(5))
    server, hint, fparams = Server.setup(seed, db, *args, rng=np.random.default_rng(5), device="cpu")
    assert (hint, fparams) == (want_hint, want_filter)
    assert server.backend == ("numpy" if call == "numpy" else "torch")
    q = _queries(np.random.default_rng(6), 3, server.num_query_cols)
    assert np.array_equal(server.respond_batch(q), want_server.respond_batch(q))


def test_server_constructor_in_jax_positional_form():
    """Server("torch", planes, m, cols, b, "packed") serves the planes of a
    JAX packed server as Server("jax", pdb, m, cols, b, "packed") does."""
    import chalametpir_tpu

    from chalametpir_tpu_torch import Server
    from chalametpir_tpu_torch.convert import planes_from_numpy

    db = _db(300, 7)
    seed = np.random.default_rng(8).bytes(32)
    jax_server, _, _ = chalametpir_tpu.Server.setup(seed, db, 3, "jax", "packed", rng=np.random.default_rng(9))
    pdb = jax_server._planes
    m, cols, b = jax_server.num_query_cols, jax_server.num_response_cols, jax_server.mat_elem_bit_len
    want = chalametpir_tpu.Server("jax", pdb, m, cols, b, "packed")
    planes = planes_from_numpy(np.asarray(pdb.lo), None if pdb.hi is None else np.asarray(pdb.hi), b, m, cols, "cpu")
    server = Server("torch", planes, m, cols, b, "packed")
    assert (server.backend, server.layout, server.mat_elem_bit_len) == ("torch", "packed", b)
    q = _queries(np.random.default_rng(10), 4, m)
    assert np.array_equal(server.respond_batch(q), want.respond_batch(q))


def test_server_backend_names():
    """The constructor takes "torch" and "numpy" ("auto" is "torch"); the
    JAX backend name raises ValueError naming "torch", as setup does."""
    from chalametpir_tpu_torch import Server

    d = np.zeros((4, 2), np.uint16)
    assert Server("numpy", d, 4, 2, 8, "digit2").backend == "numpy"
    assert Server("auto", d, 4, 2, 8).backend == "torch"
    with pytest.raises(ValueError, match='"torch"'):
        Server("jax", d, 4, 2, 8)
    with pytest.raises(ValueError, match="layout"):
        Server("numpy", d, 4, 2, 8, "tiled")


def _sampler(monkeypatch, seed: int) -> None:
    """Both clients' secret and error sampler on one numpy stream, so two
    clients fed the same stream build the same query bytes."""
    import chalametpir_tpu.models.client as jax_client
    import chalametpir_tpu_torch.models.client as port_client

    g = np.random.default_rng(seed)
    sampler = staticmethod(lambda n: g.integers(0, 3, size=n).astype(np.int8))
    monkeypatch.setattr(jax_client.Client, "_sample_ternary", sampler)
    monkeypatch.setattr(port_client.Client, "_sample_ternary", sampler)


def _query(client, key):
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator as JaxOverflow

    from chalametpir_tpu_torch.errors import ArithmeticOverflowAddingQueryIndicator

    while True:
        try:
            return client.query(key)
        except (ArithmeticOverflowAddingQueryIndicator, JaxOverflow):
            continue


def test_host_client_is_the_jax_host_engine(monkeypatch):
    """Client(pub_mat_a, hint, filt) is the JAX client's host engine: s . A
    by the native ternary matvec, no device, `host_matvec_s` in
    prepare_stats; on the same sampled secrets it builds the JAX host
    client's query bytes, inline, from the pool and in a batch, and
    decodes the server's responses."""
    import chalametpir_tpu

    from chalametpir_tpu_torch import BinaryFuseFilter, Client, Server
    from chalametpir_tpu_torch.core import matrix_io, prg
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    db = _db(300, 11)
    seed = np.random.default_rng(12).bytes(32)
    server, hint, fparams = Server.setup(seed, db, 3, "numpy", rng=np.random.default_rng(13))
    filt = BinaryFuseFilter.from_bytes(fparams)
    a = prg.expand_seed(LWE_DIMENSION, filt.num_fingerprints, seed)
    hint_m = matrix_io.matrix_from_bytes(hint)
    client = Client(a, hint_m, filt)
    want = chalametpir_tpu.Client(a, hint_m, chalametpir_tpu.BinaryFuseFilter.from_bytes(fparams))
    assert not client.uses_device and client.setup_stats == {}
    keys = list(db)[:6]
    _sampler(monkeypatch, 14)
    want_inline = [_query(want, k) for k in keys[:2]]
    want.prepare_queries(2)
    want_pool = [_query(want, k) for k in keys[2:4]]
    want_batch = want.query_batch(keys[4:])
    _sampler(monkeypatch, 14)
    assert [_query(client, k) for k in keys[:2]] == want_inline
    client.prepare_queries(2)
    assert "host_matvec_s" in client.prepare_stats and "readback_s" not in client.prepare_stats
    assert [_query(client, k) for k in keys[2:4]] == want_pool
    assert client.query_batch(keys[4:]) == want_batch
    for key, q in zip(keys, want_inline + want_pool + want_batch):
        assert client.process_response(key, server.respond(q)) == db[key]
    with pytest.raises(ValueError, match="seed"):
        client.save("unused")


def test_client_with_a_device_engine_in_jax_positional_form(monkeypatch):
    """Client(None, hint, filt, engine, seed, "ctr"): the device engine in
    the JAX client's fourth place gives the JAX device client's bytes."""
    import chalametpir_tpu
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine as JaxEngine

    from chalametpir_tpu_torch import BinaryFuseFilter, Client, Server
    from chalametpir_tpu_torch.core import matrix_io
    from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine

    db = _db(300, 15)
    seed = np.random.default_rng(16).bytes(32)
    server, hint, fparams = Server.setup(seed, db, 3, "numpy", "auto", "ctr", rng=np.random.default_rng(17))
    hint_m = matrix_io.matrix_from_bytes(hint)
    m = server.num_query_cols
    client = Client(None, hint_m, BinaryFuseFilter.from_bytes(fparams),
                    DeviceQueryEngine.from_seed_ctr(seed, m, 256, device="cpu"), seed, "ctr")
    want = chalametpir_tpu.Client(None, hint_m, chalametpir_tpu.BinaryFuseFilter.from_bytes(fparams),
                                  JaxEngine.from_seed_ctr(seed, m, 256), seed, "ctr")
    assert client.uses_device
    key = list(db)[3]
    _sampler(monkeypatch, 18)
    q = _query(want, key)
    _sampler(monkeypatch, 18)
    assert _query(client, key) == q
    assert client.process_response(key, server.respond(q)) == db[key]


@pytest.mark.parametrize("engine", ["from_host_matrix", "streaming_from_seed_ctr", "from_seed_ctr", "km"])
def test_engines_in_jax_positional_form(engine):
    """DeviceQueryEngine.from_host_matrix(a), .streaming_from_seed_ctr(seed,
    m, 256), .from_seed_ctr(seed, m, 256) and DeviceQueryEngine(planes, k,
    m, "km") give the JAX engines' s . A bit for bit (`device` a keyword)."""
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine as JaxEngine

    from chalametpir_tpu_torch.core import prg
    from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine, StreamingQueryEngine
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    g = np.random.default_rng(19)
    m = 300
    seed = g.bytes(32)
    codes = g.integers(0, 3, size=(3, LWE_DIMENSION)).astype(np.int8)
    if engine == "from_host_matrix":
        a = prg.expand_seed(LWE_DIMENSION, m, seed)
        eng, want = DeviceQueryEngine.from_host_matrix(a, device="cpu"), JaxEngine.from_host_matrix(a)
    elif engine == "streaming_from_seed_ctr":
        eng = DeviceQueryEngine.streaming_from_seed_ctr(seed, m, 256, device="cpu")
        want = JaxEngine.streaming_from_seed_ctr(seed, m, 256)
        assert isinstance(eng, StreamingQueryEngine) and eng.layout == "streaming"
    elif engine == "from_seed_ctr":
        eng, want = DeviceQueryEngine.from_seed_ctr(seed, m, 256, device="cpu"), JaxEngine.from_seed_ctr(seed, m, 256)
    else:
        a = prg.expand_seed(LWE_DIMENSION, m, seed)
        want = JaxEngine.from_host_matrix(a)
        eng = DeviceQueryEngine(torch.from_numpy(np.array(want._planes)), LWE_DIMENSION, m, "km")
    assert np.array_equal(eng.matvec_batch(codes), want.matvec_batch(codes))
    assert np.array_equal(eng.matvec(codes[0]), want.matvec(codes[0]))


def test_km_planes_are_laid_out_fingerprint_major():
    """"km" planes (4, k_pad, m) are relaid fingerprint-major on their
    device at construction, padded to the _int_mm shape rules: `layout`
    reads "mk" and `k_pad` is the padded k. Any other layout, or a `k_pad`
    that is not the planes' k extent, raises."""
    from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine

    g = np.random.default_rng(20)
    k, m = 13, 21
    planes = torch.from_numpy(g.integers(-128, 128, size=(4, k, m), dtype=np.int8))
    eng = DeviceQueryEngine(planes, k, m, "km")
    assert (eng.layout, eng.k_pad, tuple(eng._planes.shape)) == ("mk", 16, (4, 24, 16))
    assert torch.equal(eng._planes[:, :m, :k], planes.transpose(1, 2))
    assert not eng._planes[:, m:].any() and not eng._planes[:, :, k:].any()
    codes = g.integers(0, 3, size=(2, k)).astype(np.int8)
    a = ((planes.numpy().astype(np.int64) + 128) << (8 * np.arange(4))[:, None, None]).sum(axis=0)
    signs = np.where(codes == 2, -1, codes).astype(np.int64)
    assert np.array_equal(eng.matvec_batch(codes), (signs @ a).astype(np.uint32))
    with pytest.raises(ValueError, match="layout"):
        DeviceQueryEngine(planes, k, m, "streaming")
    # the JAX k_pad is the planes' own k extent: checked, not stored
    assert DeviceQueryEngine(planes, k, m, "km", k_pad=k).k_pad == 16
    with pytest.raises(ValueError, match="k_pad"):
        DeviceQueryEngine(planes, k, m, "km", k_pad=16)


def test_ops_in_jax_positional_form():
    """The ops entry points under the JAX parameter names: respond_packed_core
    and respond_batch_packed with `queries_u32`, hint_fold_partial with the
    JAX package's (k_pad, cc) `g`, rows_from_blocks with its two-word
    `blk0_words`; the JAX package's bytes."""
    from chalametpir_tpu.ops import prg_jax, respond_pallas

    from chalametpir_tpu_torch.ops import prg_torch
    from chalametpir_tpu_torch.ops import respond_packed as rp
    from chalametpir_tpu_torch.models.server import K_PAD
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    g = np.random.default_rng(21)
    b, m, c = 10, 300, 40
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    jdb = respond_pallas.build_pallas_db(mat, b, tile_k=256)
    db = rp.build_packed_db(mat, b, "cpu", m_align=256)
    q = g.integers(0, 1 << 32, size=(3, m), dtype=np.uint32)
    qt = torch.from_numpy(q.view(np.int32))
    want = np.asarray(respond_pallas.respond_batch_packed(q, jdb, True))
    assert np.array_equal(rp.respond_batch_packed(queries_u32=qt, db=db).numpy().view(np.uint32), want)
    got = rp.respond_packed_core(queries_u32=qt, lo=db.lo, hi=db.hi, mat_elem_bit_len=b, num_cols=c)
    assert np.array_equal(got.numpy().view(np.uint32), want)

    cc = 256
    gt = np.zeros((K_PAD, cc), np.uint32)
    gt[:LWE_DIMENSION] = g.integers(0, 1 << 32, size=(LWE_DIMENSION, cc), dtype=np.uint32)
    want = np.asarray(respond_pallas.hint_fold_partial(gt, jdb.lo[:cc], jdb.hi[:cc], b, c, 256, 128, True))
    got = rp.hint_fold_partial(torch.from_numpy(gt.view(np.int32)), db.lo[:cc], db.hi[:cc], b, c)
    assert got.shape == (K_PAD, c) and np.array_equal(got.numpy().view(np.uint32), want)

    seed = g.bytes(32)
    blk0_words, offset = prg_jax.fp_block_start(7, LWE_DIMENSION)
    want = np.asarray(prg_jax.rows_from_blocks(prg_jax.seed_to_words(seed), blk0_words, offset, 5, LWE_DIMENSION))
    words = prg_torch.seed_to_words(seed)
    for blk0 in (np.asarray(blk0_words), prg_torch.fp_block_start(7, LWE_DIMENSION)[0]):
        got = prg_torch.rows_from_blocks(words, blk0, int(offset), 5, LWE_DIMENSION, "cpu")
        assert np.array_equal(got.numpy().view(np.uint32), want)
