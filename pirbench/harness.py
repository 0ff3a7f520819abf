"""One run of one cell of BENCHMARK.json.

Everything a cell needs is found by name: its configuration's file (the
entry's "file"), its mix in pirbench/traffic/<traffic>.json (read by
drive.py), and each per-layer metric's reader in
pirbench/layers/<metric>.py, a module with read(record) -> value or None.
A run makes the DB from the seed on the device, warms the program up on a
small DB, times Server.setup of the cell's DB, lets the mix's driver set
up and measure its window, reads the device's peak, frees the program's
state and checks what the window produced against the plain reference
(judge.py). `run` returns the result line as a dict.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import drive, judge, trace
from .reference import pir
from .workcount import plane_geometry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "chalametpir_tpu")
PIR_SEED, SETUP = 0, 1  # the seed's streams of the PIR seed and of the filter's seeds
WARM_LOG_N = 12  # entries of the warm-up DB, log2


def log(msg: str) -> None:
    print(f"[pirbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold, compared
    whole (the program's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration, its mix and the
    metrics it reports."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, found[0]
        config = next(c for c in bench["configs"] if c["name"] == self.entry["config"])
        self.cfg = load_json(os.path.join(root, config["file"]))
        self.mix = load_json(os.path.join(root, "pirbench", "traffic", f"{self.entry['traffic']}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        self.root = root

    def reader(self, metric: str):
        path = os.path.join(self.root, "pirbench", "layers", f"{metric}.py")
        spec = importlib.util.spec_from_file_location("pirbench_layer_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


class Context:
    """The run's inputs, the program's objects and what the window gave."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace_on: bool, dev, t_start: float):
        self.cell, self.cfg, self.mix = cell, cell.cfg, cell.mix
        self.seed, self.seconds, self.trace, self.dev = seed, seconds, trace_on, dev
        self.cuda = dev.type == "cuda"
        self.t_start = t_start
        self.spans = trace.Spans()
        self.setup_s = None
        self.held: dict = {}
        self.values: list = []
        self.kept: list = []
        self.counters: dict = {}
        self.win: dict = {}

    def hold(self, **objects):
        """Keep program objects until the window is done; returns the one given."""
        self.held.update(objects)
        return next(iter(objects.values()))

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def release(self) -> None:
        """Drop every program object, so that its device memory is freed."""
        self.held.clear()
        self.server = None
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def make_db(n: int, key_len: int, value_len: int, seed: int, dev):
    """n random keys and values from the seed, drawn on the device in two
    calls: (db dict, keys (n, key_len) uint8, values (n, value_len) uint8)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = torch.randint(0, 256, (n, key_len), generator=gen, dtype=torch.uint8, device=dev).cpu().numpy()
    values = torch.randint(0, 256, (n, value_len), generator=gen, dtype=torch.uint8, device=dev).cpu().numpy()
    # void views: bytes objects that keep trailing zero bytes
    key_list = keys.view(f"V{key_len}").ravel().tolist()
    db = dict(zip(key_list, values.view(f"V{value_len}").ravel().tolist()))
    if len(db) != n:
        raise RuntimeError("two keys drawn alike: use another seed")
    return db, key_list, keys, values


def warm_up(cfg: dict, dev) -> None:
    """A round trip and a batch on a small DB in the configuration's PRG
    mode and arity: the kernels are built and loaded, the card's context
    and the native engine are up before Server.setup is timed."""
    from chalametpir_tpu_torch import Client, Server

    n = 1 << WARM_LOG_N
    db, key_list, _, _ = make_db(n, cfg["key_len"], cfg["value_len"], 0, dev)
    seed = bytes(32)
    server, hint, fparams = Server.setup(seed, db, arity=cfg["arity"], prg_mode=cfg["prg_mode"],
                                         rng=np.random.default_rng(0), mat_elem_bit_len=cfg["b"], device=dev)
    client = Client.setup(seed, hint, fparams, prg_mode=cfg["prg_mode"], device=dev)
    for key in key_list[:2]:
        client.process_response(key, server.respond(drive.query_with_retry(client, key)))
    server.respond_batch(np.zeros((2, server.num_query_cols), np.uint32))


def card(dev) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": None}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "power_limit": limit}


def breakdown(rec: dict) -> dict:
    """The device ops that took the most time and the longest idle gaps,
    each labelled by the benchmark span the host was in."""
    by_name: dict[str, float] = {}
    for e0, e1, name, _ in rec["device"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e1 - e0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted((s0, s1, name) for name, rows in rec["spans"].items() for s0, s1, _ in rows)
    gaps = trace.idle_gaps(host, rec["busy"], 0.0, rec["window_us"])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label, us / 1e6] for us, label in sorted(gaps, key=lambda g: -g[0])[:10]]}


def record(ctx: Context, geometry: dict) -> dict:
    """What the per-layer readers read: the window's spans and device
    events (microseconds from the window's start), counters and shapes."""
    start = ctx.win["start"]
    spans: dict[str, list] = {}
    for s0, s1, name, q in sorted(ctx.spans.rows):
        spans.setdefault(name, []).append(((s0 - start) * 1e6, (s1 - start) * 1e6, q))
    window_us = (ctx.win["end"] - start) * 1e6
    device = (ctx.win.get("device") or None) if ctx.cuda else None
    busy = trace.merged([(e0, e1) for e0, e1, _, _ in device], 0.0, window_us) if device else None
    return {"spans": spans, "device": device, "busy": busy, "window_us": window_us, "geometry": geometry,
            "counters": ctx.counters, "setup_phases_s": ctx.setup_phases}


def run(name: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda", log_n: int | None = None,
        control: bool = False, root: str = ROOT, t_start: float | None = None) -> dict:
    """Run one cell; returns the result line. log_n shrinks the DB (the CPU
    tests); control puts the reference in float32 in the program's place
    for the outputs that the check compares."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    seed &= (1 << 64) - 1  # every stream of the run is drawn from this
    cell = Cell(name, root)
    cfg = cell.cfg
    dev = torch.device(device)
    ctx = Context(cell, seed, seconds, trace_on, dev, t_start)
    info = card(dev)
    ctx.n = n = 1 << (log_n or cfg["log_n"])
    b = cfg["b"] or pir.element_bits(n)
    warm_up(cfg, dev)
    log(f"warm-up done at {time.perf_counter() - t_start:.2f} s")
    db, ctx.key_list, keys, values = make_db(n, cfg["key_len"], cfg["value_len"], ctx.seed, dev)
    log(f"{n} entries made at {time.perf_counter() - t_start:.2f} s")
    ctx.pir_seed = np.random.default_rng([seed, PIR_SEED]).bytes(32)
    gc.freeze()  # the DB's millions of objects stay out of every collection
    try:
        from chalametpir_tpu_torch import Server

        if ctx.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        server, ctx.hint, ctx.fparams = Server.setup(
            ctx.pir_seed, db, arity=cfg["arity"], prg_mode=cfg["prg_mode"],
            rng=np.random.default_rng([seed, SETUP]), mat_elem_bit_len=cfg["b"], device=dev)
        if ctx.cuda:
            torch.cuda.synchronize()
        server_setup_s = time.perf_counter() - t0
        ctx.server = ctx.hold(server=server)
        ctx.setup_phases = dict(server.setup_stats.get("phases_s") or {})
        ctx.geometry = {"m": server.num_query_cols, "c": server.num_response_cols, "b": server.mat_elem_bit_len}
        del server
        log(f"Server.setup {server_setup_s:.3f} s, phases {ctx.setup_phases}")
        drive.DRIVERS[cell.mix["kind"]](ctx)
        log(f"set-up {ctx.setup_s:.2f} s; window {ctx.window_s:.3f} s, {ctx.attempted} requests")
        peak = torch.cuda.max_memory_allocated(dev) if ctx.cuda else None
        ctx.release()
    finally:
        gc.unfreeze()
    t0 = time.perf_counter()
    checks = judge.judge(ctx, keys, values, cfg, b, np.random.default_rng([seed, SETUP]), seed, control)
    log(f"check {time.perf_counter() - t0:.2f} s; A's rows took {ctx.a_rows_s:.2f} s")
    metrics_all = {"setup_s": ctx.setup_s, "server_setup_s": server_setup_s, **ctx.e2e}
    info["memory_peak_bytes"] = peak
    out = {"correct": judge.correct(checks), "attempted": ctx.attempted, "failed": ctx.failed}
    if not trace_on:
        out["metrics"] = {m["name"]: {"value": metrics_all[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    else:
        rec = record(ctx, plane_geometry(**ctx.geometry))
        out["metrics"] = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(rec)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if rec["device"] is not None:
            matched = sum(e[3] is not None for e in rec["device"])
            log(f"{len(rec['device'])} device events, {matched} matched to their launch")
            info["busy_s"] = sum(e1 - e0 for e0, e1 in rec["busy"]) / 1e6
            info["window_s"] = rec["window_us"] / 1e6
            out["breakdown"] = breakdown(rec)
    out["device"] = info
    out["checks"] = checks
    return out
