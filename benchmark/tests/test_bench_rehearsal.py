"""A rehearsal of the benchmark on the CPU: BENCHMARK.json against the
contract, each cell's files, the metrics' arithmetic, whole runs of every
cell at a tiny ring (n = 256, k = 3) through the program's plain CPU path,
the lookup of a cell added by files alone, and the check failing under the
control and under each fault a cell can have.  One test runs a cell on the
card and skips without one."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, trace, traffic

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 12345
# Noise limits at the tiny ring, set from CPU readings there (seeds 1, 2):
# multiply 2.3e11-3.5e11 with one prime a gadget digit, 1.4e20-1.9e20 with
# two (the control); dot 2.4e13-3.5e13, and with two primes a digit
# 9.2e21-9.4e21 and wrong slots.
TINY_LIMITS = {"mul_offline": {"wrong_slots": 0, "noise": 1e15},
               "dot_pt_latency": {"wrong_slots": 0, "noise": 1e17}}


# -- BENCHMARK.json against the contract --

def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py" and len(BENCH["command"]) <= 32
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_keys_names_and_units():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(x) for x in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert harness.reader_path(ROOT, m["name"]).is_file()


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_the_contract_asks(name):
    cell = harness.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    for m in cell.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in cell.traffic["metrics"]
    traffic.check_mix(cell.traffic)
    assert set(cell.limits) == {"wrong_slots", "noise"} and cell.limits["wrong_slots"] == 0


# -- the metrics' arithmetic --

def test_idle_share_and_busy_of_a_synthetic_kernel_list():
    ops = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 30.0, "a"), (40.0, 50.0, "c")]
    assert trace.merged(ops) == [(0.0, 12.0), (20.0, 30.0), (40.0, 50.0)]
    assert trace.busy_us(ops) == 32.0
    assert trace.idle_share(ops) == pytest.approx(1 - 32 / 50)
    assert trace.idle_share([]) is None
    assert trace.top_ops(ops, 2) == [["a", pytest.approx(20e-6)], ["c", pytest.approx(10e-6)]]
    assert trace.roofline_percent(2e-6, 3, trace.matching(ops, "a")) == pytest.approx(30.0)
    assert trace.roofline_percent(1e-6, 3, []) is None


def test_idle_gaps_go_to_the_innermost_host_operation():
    ops = [(0.0, 10.0, "k"), (15.0, 20.0, "k"), (30.0, 31.0, "k"), (50.0, 51.0, "k")]
    host = [(0.0, 60.0, "bench.request"), (9.0, 16.0, "aten::cat"),
            (25.0, 29.0, "aten::stack")]
    # gaps 10-15 (inside cat), 20-30 (in the request only), 31-50 (request)
    assert trace.idle_gaps(ops, host) == [["bench.request", pytest.approx(29e-6)],
                                          ["aten::cat", pytest.approx(5e-6)]]
    assert trace.idle_gaps(ops, []) == [["(host between operations)", pytest.approx(34e-6)]]


def test_span_annotations_are_not_device_work():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, start, end, device, thread=1, note=False):
        return NS(name=lambda: name, start_ns=lambda: start * 1e3, end_ns=lambda: end * 1e3,
                  device_type=lambda: device, start_thread_id=lambda: thread,
                  is_user_annotation=lambda: note)

    events = [ev("bench.multiply_batch", 0.0, 100.0, DeviceType.CUDA, note=True),
              ev("keyswitch_kernel", 10.0, 20.0, DeviceType.CUDA),
              ev("bench.multiply_batch", 0.0, 100.0, DeviceType.CPU, note=True),
              ev("aten::cat", 1.0, 2.0, DeviceType.CPU),
              ev("other", 1.0, 2.0, DeviceType.CPU, thread=2)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    dev, host = harness._device_events(prof)
    assert dev == [(10.0, 20.0, "keyswitch_kernel")]
    assert [h[2] for h in host] == ["bench.multiply_batch", "aten::cat"]


# -- whole runs at a tiny ring on the CPU --

def tiny_root(path: Path) -> Path:
    """A checkout root whose cells run the real mixes and readers on a tiny
    ring, with limits for that ring."""
    root = path / "root"
    for d in ("traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, root / "benchmark" / d)
    (root / "benchmark" / "configs").mkdir()
    (root / "benchmark" / "limits").mkdir()
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["security"].update(poly_degree=256, log_q=90)
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        (root / "benchmark" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(TINY_LIMITS[w["traffic"]]))
    mix = root / "benchmark" / "traffic" / "mul_offline.json"
    spec = json.loads(mix.read_text())
    spec["batch"] = 4
    mix.write_text(json.dumps(spec))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, name, traced=False, seconds=0.3, control=False):
    cell = harness.load_cell(name, root)
    if control:
        cell.config["security"]["ks_omega"] = 2
    return harness.run_cell(cell, SEED, seconds, traced, device="cpu")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_whole_run_prints_the_contracts_keys(root, name, traced):
    result, lines = run(root, name, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = harness.load_cell(name, root)
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU path counts no launches and traces no device: only the
        # host readers find something to read
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert any(k.startswith("host_ms_per_call") for k in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert [line.split()[0] for line in lines] == list(result["checks"])
    json.dumps(result, allow_nan=False)


def test_window_statistics_cover_every_request(root):
    cell = harness.load_cell("bfv_n32768_k29.dot_pt_latency", root)
    from fhe_tpu_torch import FHE
    from fhe_tpu_torch.params import SecurityParams, make_scheme_params
    fhe = FHE(make_scheme_params(SecurityParams(**cell.config["security"])), device="cpu")
    mix = traffic.Traffic(cell.traffic, fhe, 5)
    import torch
    gen = torch.Generator().manual_seed(5)
    pk, sk = fhe.keygen()
    mix.setup(gen, pk, sk)
    win = mix.run(0.3)
    ms = np.array(win.samples) * 1e3
    assert len(ms) == win.attempted == win.calls
    assert win.stats["latency_p50_ms"] == pytest.approx(np.percentile(ms, 50))
    assert win.stats["latency_p95_ms"] == pytest.approx(np.percentile(ms, 95))
    assert win.seconds >= sum(win.samples)


def test_rate_is_over_the_whole_window(root):
    result, _ = run(root, "bfv_n32768_k29.mul_offline", seconds=0.5)
    rate = result["metrics"]["mul_per_s"]["value"]
    assert rate * 0.5 <= result["attempted"] <= rate * 0.5 * 2


# -- a cell added by files alone --

def test_a_new_cell_needs_only_new_files(root, tmp_path):
    new = tmp_path / "root"
    shutil.copytree(root, new)
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    bench = json.loads((new / "BENCHMARK.json").read_text())
    cfg = json.loads((new / "benchmark/configs/bfv_n32768_k29.json").read_text())
    cfg["security"].update(poly_degree=512)
    (new / "benchmark/configs/throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "benchmark/traffic/dot_pt_latency.json").read_text())
    mix.update(request=["sum_slots"], pool={"ciphertexts": 4}, cache_operand=False)
    (new / "benchmark/traffic/sum_only.json").write_text(json.dumps(mix))
    (new / "benchmark/limits/throwaway.sum_only.json").write_text(
        json.dumps(TINY_LIMITS["dot_pt_latency"]))
    (new / "benchmark/metrics/requests_seen.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    bench["configs"].append({"name": "throwaway", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/throwaway.json", "why": "a test"})
    bench["workloads"].append({"name": "throwaway.sum_only", "config": "throwaway",
                               "traffic": "sum_only", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "dot_p95_ms":
            m["workloads"].append("throwaway.sum_only")
    bench["per_layer"].append({"name": "requests_seen", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "Facade",
                               "moves": "dot_p95_ms", "workloads": ["throwaway.sum_only"]})
    # a metric of the new mix that an existing reader serves, with no file
    bench["per_layer"].append({"name": "idle_share.sum", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "Device",
                               "moves": "dot_p95_ms", "workloads": ["throwaway.sum_only"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("throwaway.sum_only", new)
    assert cell.config["security"]["poly_degree"] == 512
    assert [m["name"] for m in cell.per_layer] == ["requests_seen", "idle_share.sum"]
    assert harness.reader_path(new, "idle_share.sum") == new / "benchmark/metrics/idle_share.py"
    assert harness.load_reader(cell, "idle_share.sum")(SimpleNamespace(ops=[])) is None
    result, _ = harness.run_cell(cell, SEED, 0.2, True, device="cpu")
    assert result["correct"] and result["metrics"]["requests_seen"]["value"] >= 1
    # the CPU traces no device, so the idle share finds nothing to read
    assert "idle_share.sum" not in result["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


# -- the check fails under the control and under each fault --

@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(root, name):
    """ks_omega = 2, two q primes a gadget digit: the program's own key
    switch one step coarser than the configuration states."""
    result, _ = run(root, name, control=True)
    assert result["correct"] is False
    assert result["checks"]["noise"]["value"] > result["checks"]["noise"]["limit"]


def _alter(fhe, ct):
    """One residue of c0 moved by one, where the program produced it."""
    data = ct.data.clone()
    data[0, 0, 0] = (data[0, 0, 0] + 1) % fhe.params.q_primes[0]
    return ct.replace(data=data)


def _mul_faults():
    from fhe_tpu_torch.api import FHE
    orig = FHE.multiply_batch
    return {
        "state_unchanged": lambda self, a, b, rlk: list(a),
        "half_the_batch": lambda self, a, b, rlk: (
            orig(self, a[:len(a) // 2], b[:len(b) // 2], rlk) * 2)[:len(a)],
        "answer_altered": lambda self, a, b, rlk: [_alter(self, c) for c in orig(self, a, b, rlk)],
    }


def _dot_faults():
    from fhe_tpu_torch.api import FHE
    orig = FHE.sum_slots
    return {
        "state_unchanged": ("sum_slots", lambda self, ct, keys: ct),
        # the column swap left out: half the slots, the sum doubled
        "half_the_batch": ("rotate_columns", lambda self, ct, keys: ct),
        "answer_altered": ("sum_slots", lambda self, ct, keys: _alter(self, orig(self, ct, keys))),
    }


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_each_fault_of_the_multiply_fails(root, monkeypatch, fault):
    from fhe_tpu_torch.api import FHE
    monkeypatch.setattr(FHE, "multiply_batch", _mul_faults()[fault])
    result, _ = run(root, "bfv_n32768_k29.mul_offline")
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_each_fault_of_the_dot_fails(root, monkeypatch, fault):
    from fhe_tpu_torch.api import FHE
    method, broken = _dot_faults()[fault]
    monkeypatch.setattr(FHE, method, broken)
    result, _ = run(root, "bfv_n32768_k29.dot_pt_latency")
    assert result["correct"] is False and result["checks"]["wrong_slots"]["value"] > 0


# -- the command itself --

def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bfv_n32768_k29.mul_offline", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=1200,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
