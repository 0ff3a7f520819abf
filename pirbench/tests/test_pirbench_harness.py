"""The harness on the CPU: every cell through the test-only entry
(harness.run with device "cpu" and a 2^10-entry DB), BENCHMARK.json
against the benchmark's contract, a cell added by files alone, the
control and the faults that must make `correct` false."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pirbench import drive, harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEVICE_SOURCES = {"device_trace"}
SEED = 2**31 + 11


def cpu_run(monkeypatch, cell, trace=False, seconds=2.0, **kw):
    """One run on the CPU at 2^10 entries; the 2^21 configuration's client
    streams A there only with the resident budget at 0."""
    if cell.startswith("ctr-2p21"):
        import chalametpir_tpu_torch.models.client as client

        monkeypatch.setattr(client, "RESIDENT_PLANES_MAX_BYTES", 0)
    return harness.run(cell, kw.pop("seed", SEED), seconds, trace, device="cpu", log_n=10, **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu_and_its_line_keeps_the_contract(monkeypatch, cell, trace):
    result = cpu_run(monkeypatch, cell, trace)
    assert set(result) - {"checks", "breakdown"} == KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu" and result["device"]["memory_peak_bytes"] is None
    c = harness.Cell(cell)
    wanted = c.per_layer if trace else c.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(result["metrics"]) <= set(units)
    for name, metric in result["metrics"].items():
        assert metric["unit"] == units[name] and isinstance(metric["value"], (int, float))
    # device metrics are never written from a CPU run; the others always are
    device = {m["name"] for m in wanted if m["source"] in DEVICE_SOURCES}
    assert not device & set(result["metrics"])
    assert set(units) - device <= set(result["metrics"])
    if not trace:
        assert all(result["metrics"][name]["value"] > 0 for name in units)


def test_rates_are_all_the_work_over_the_window(monkeypatch):
    result = cpu_run(monkeypatch, "ctr-2p20-a3.lookup", seconds=2.0)
    rounds, mean = result["attempted"], result["metrics"]["round_trip_ms"]["value"]
    assert 2.0 <= rounds * mean / 1e3 < 2.0 + 3 * mean / 1e3
    assert result["metrics"]["round_trip_p95_ms"]["value"] >= 0
    result = cpu_run(monkeypatch, "ctr-2p20-a3.batch64", seconds=2.0)
    assert result["metrics"]["serve_qps"]["value"] <= result["attempted"] / 2.0


def test_p95_is_of_all_samples():
    samples = [float(i) for i in range(1, 201)]
    assert drive.p95(samples) == 190.0
    assert drive.p95(samples[:20]) == 19.0


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pirbench"] and BENCH["command"] == ["python3", "pirbench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pirbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"] == []
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, "pirbench", "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]} if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, "pirbench", "layers", m["name"] + ".py"))
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in harness.Cell(cell).end_to_end}
    for cell in CELLS:
        c = harness.Cell(cell)
        assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2 and c.per_layer
    assert len(json.dumps(BENCH).encode()) <= 64 << 10


def checkout_with(tmp_path, configs=(), workloads=()):
    """A copy of the benchmark with more configurations and cells, added
    as files and entries only."""
    shutil.copytree(os.path.join(ROOT, "pirbench"), tmp_path / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    for name, cfg in configs:
        (tmp_path / "pirbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "https://example.org/" + name, "reduced": [],
                                 "file": f"pirbench/configs/{name}.json", "why": "a test"})
    for name, config, traffic, like in workloads:
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def test_a_cell_added_by_files_alone_runs(tmp_path):
    cfg = json.load(open(os.path.join(ROOT, "pirbench", "configs", "ctr-2p20-a3.json")))
    cfg.update(arity=4, b=None)
    root = checkout_with(tmp_path, [("ctr-2p20-a4", cfg)],
                         [("ctr-2p20-a4.lookup", "ctr-2p20-a4", "lookup", "ctr-2p20-a3.lookup")])
    result = harness.run("ctr-2p20-a4.lookup", SEED, 1.0, False, device="cpu", log_n=10, root=root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"round_trip_ms", "round_trip_p95_ms", "setup_s"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_tcp_mix_serves_over_sockets(tmp_path, trace):
    root = checkout_with(tmp_path, workloads=[("ctr-2p20-a3.serve", "ctr-2p20-a3", "serve", "ctr-2p20-a3.batch64")])
    result = harness.run("ctr-2p20-a3.serve", SEED, 2.0, trace, device="cpu", log_n=10, root=root)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["values_wrong"]["compared"] == 16
    if not trace:
        assert 0 < result["metrics"]["serve_qps"]["value"] <= result["attempted"] / 2.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(monkeypatch, cell):
    result = cpu_run(monkeypatch, cell, seconds=1.0, control=True)
    assert result["correct"] is False
    assert result["checks"]["response_words_wrong"]["value"] > 0
    assert result["checks"]["hint_words_wrong"]["value"] > 0


def flip_one_word(respond_batch):
    def broken(self, queries):
        out = respond_batch(self, queries).copy()
        out[:, 7] ^= 1 << 31
        return out
    return broken


def drop_half(respond_batch):
    def broken(self, queries):
        out = respond_batch(self, queries).copy()
        out[out.shape[0] // 2 :] = 0
        return out
    return broken


def unchanged_hint(setup):
    def broken(*args, **kwargs):
        server, hint, fparams = setup(*args, **kwargs)
        return server, hint[:8] + bytes(len(hint) - 8), fparams
    return broken


def wrong_value(process_response):
    def broken(self, key, response):
        return b"\0" + process_response(self, key, response)[1:]
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out", "state_unchanged", "value_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from chalametpir_tpu_torch import Client, Server

    monkeypatch.setattr(harness, "warm_up", lambda cfg, dev: None)  # the faults are in the cell's own path
    if fault == "answer_altered":
        monkeypatch.setattr(Server, "respond_batch", flip_one_word(Server.respond_batch))
    elif fault == "half_batch_left_out":
        monkeypatch.setattr(Server, "respond_batch", drop_half(Server.respond_batch))
    elif fault == "state_unchanged":
        monkeypatch.setattr(Server, "setup", staticmethod(unchanged_hint(Server.setup)))
    else:
        monkeypatch.setattr(Client, "process_response", wrong_value(Client.process_response))
    result = cpu_run(monkeypatch, cell, seconds=1.0)
    assert result["correct"] is False, result["checks"]


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "chalametpir_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib_not", object())
    assert harness.forbidden_modules() == ["chalametpir_tpu"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "pirbench", "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_outside_a_checkout_of_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "pirbench"), tmp_path / "pirbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "pirbench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control_on_the_card(cuda_device, monkeypatch, cell):
    import chalametpir_tpu_torch.models.client as client

    if cell.startswith("ctr-2p21"):
        monkeypatch.setattr(client, "RESIDENT_PLANES_MAX_BYTES", 0)
    assert harness.run(cell, SEED, 1.0, True, device=cuda_device, log_n=14)["correct"] is True
    assert harness.run(cell, SEED, 1.0, False, device=cuda_device, log_n=14, control=True)["correct"] is False


def test_kept_rows_are_a_sample_of_the_whole_stream():
    rng, kept = np.random.default_rng(0), []
    for i in range(10_000):
        drive.reservoir(rng, kept, 50, i, i)
    assert len(kept) == 50 and max(kept) > 5_000 and min(kept) < 5_000
