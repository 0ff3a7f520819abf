"""The JAX package's client-protocol suites, run through the port.

The tests of tests/test_query_pool.py, test_client_concurrency.py,
test_property_randomized.py, test_pir_integration.py, test_persistence.py
and test_prg_modes.py are parametrised here, not copied: each case reads
its source file, points the file's imports at chalametpir_tpu_torch, and
runs the one test through the port's Server and Client on the CPU. Three
things of the source are translated, nothing else:

* `chalametpir_tpu` becomes `chalametpir_tpu_torch` (in the subprocess
  code of a source test too);
* a call of Server.setup / Client.setup / Server.load / Client.load that
  names no `device` gets `device="cpu"`: the port's default is "cuda",
  which raises without a card;
* the backend name "jax" becomes "torch", in `backend=` arguments and in
  the values of a `backend` parameter (the case keeps the source's id).

The source's own module fixtures run as the source defines them, once per
file; every other fixture (rng, tmp_path, monkeypatch) is pytest's.

A test that does not pass through the port is an entry of the table in
tests/test_torch_api_parity.py ("protocol"), with the exception it ends in
and why: its case passes while it ends so, and fails once it passes (the
entry is stale) or ends otherwise. The JAX files stay as they are.
"""

from __future__ import annotations

import ast
import inspect
import itertools
import re
import types
from pathlib import Path

import pytest

from test_torch_api_parity import DECIDED

TESTS = Path(__file__).resolve().parent
SOURCES = (
    "test_query_pool.py",
    "test_client_concurrency.py",
    "test_property_randomized.py",
    "test_pir_integration.py",
    "test_persistence.py",
    "test_prg_modes.py",
)
# the source tests, and how many must pass through the port
SOURCE_TESTS = 57
MIN_PASSING = 54
_BACKENDS = {"jax": "torch"}
_DEVICE_CALLS = {"setup", "load"}


def _is_mark(node: ast.expr, name: str) -> bool:
    """`node` is @pytest.mark.<name>(...) (or @pytest.<name>(...))."""
    func = node.func if isinstance(node, ast.Call) else node
    return isinstance(func, ast.Attribute) and func.attr == name


def _grid(fn: ast.FunctionDef) -> list[tuple[dict, str]]:
    """(params, id suffix) for every case of a source test, from its
    parametrize decorators, ids as pytest makes them (the decorator next
    to the function first)."""
    axes = []
    for deco in reversed(fn.decorator_list):
        if _is_mark(deco, "parametrize"):
            names = [n.strip() for n in ast.literal_eval(deco.args[0]).split(",")]
            values = ast.literal_eval(deco.args[1])
            axes.append([dict(zip(names, v if len(names) > 1 else (v,))) for v in values])
    cases = []
    for combo in itertools.product(*axes):
        params = {k: v for part in combo for k, v in part.items()}
        ident = "-".join(str(v) for part in combo for v in part.values())
        cases.append((params, f"[{ident}]" if combo else ""))
    return cases


def _cases():
    for source in SOURCES:
        tree = ast.parse((TESTS / source).read_text())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
                for params, suffix in _grid(node):
                    yield pytest.param(source, node.name, params, id=f"{source}::{node.name}{suffix}")


CASES = list(_cases())


class _ThroughThePort(ast.NodeTransformer):
    """device="cpu" into setup/load calls that name no device; backend
    "jax" to "torch"; the source's fixtures become plain functions."""

    def __init__(self):
        self.fixtures: dict[str, str] = {}  # name -> scope

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.generic_visit(node)
        for deco in list(node.decorator_list):
            if _is_mark(deco, "fixture"):
                scope = "function"
                for kw in getattr(deco, "keywords", ()):
                    if kw.arg == "scope":
                        scope = ast.literal_eval(kw.value)
                self.fixtures[node.name] = scope
                node.decorator_list.remove(deco)
        return node

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        func = node.func
        target = func.value if isinstance(func, ast.Attribute) else None
        owner = target.attr if isinstance(target, ast.Attribute) else getattr(target, "id", None)
        if func.__class__ is ast.Attribute and func.attr in _DEVICE_CALLS and owner in ("Server", "Client"):
            if not any(kw.arg == "device" for kw in node.keywords):
                node.keywords.append(ast.keyword("device", ast.Constant("cpu")))
        for kw in node.keywords:
            if kw.arg == "backend" and isinstance(kw.value, ast.Constant) and kw.value.value in _BACKENDS:
                kw.value = ast.Constant(_BACKENDS[kw.value.value])
        return node


_MODULES: dict[str, tuple[types.ModuleType, dict, dict]] = {}


def _port_module(source: str):
    """The source test file with its imports pointed at the port (module,
    its fixtures' scopes, the module-scoped fixture values), built once."""
    if source not in _MODULES:
        text = re.sub(r"\bchalametpir_tpu\b", "chalametpir_tpu_torch", (TESTS / source).read_text())
        tree = _ThroughThePort()
        module_ast = ast.fix_missing_locations(tree.visit(ast.parse(text)))
        module = types.ModuleType(f"_port_protocol_{source[:-3]}")
        module.__file__ = str(TESTS / source)
        exec(compile(module_ast, module.__file__, "exec"), module.__dict__)
        _MODULES[source] = module, tree.fixtures, {}
    return _MODULES[source]


def _fixture(source: str, name: str, request):
    module, scopes, cached = _port_module(source)
    if name not in scopes:
        return request.getfixturevalue(name)
    if name in cached:
        return cached[name]
    fn = getattr(module, name)
    value = fn(**{arg: _fixture(source, arg, request) for arg in inspect.signature(fn).parameters})
    if scopes[name] != "function":
        cached[name] = value
    return value


@pytest.mark.parametrize("source,name,params", CASES)
def test_jax_protocol_suite_through_the_port(source, name, params, request):
    module, _, _ = _port_module(source)
    fn = getattr(module, name)
    kwargs = {k: _BACKENDS.get(v, v) if k == "backend" else v for k, v in params.items()}
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = _fixture(source, arg, request)
    entry = DECIDED.get("tests/" + request.node.callspec.id)
    if entry is None:
        fn(**kwargs)
        return
    try:
        fn(**kwargs)
    except Exception as exc:  # the decided difference: it must end as the table says
        assert type(exc).__name__ == entry[1], f"ends in {exc!r}, the table says {entry[1]}"
    else:
        pytest.fail(f"stale table entry: the test passes through the port ({entry[2]})")


def test_the_suites_are_whole_and_the_table_names_only_their_tests():
    """Every test of the six source files is a case, at least MIN_PASSING
    of them are not in the table, and each protocol entry names a case."""
    ids = {"tests/" + c.id for c in CASES}
    assert len(ids) == len(CASES) == SOURCE_TESTS
    protocol = {k for k, v in DECIDED.items() if v[0] == "protocol"}
    assert protocol <= ids, sorted(protocol - ids)
    assert len(CASES) - len(protocol) >= MIN_PASSING
