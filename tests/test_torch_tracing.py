"""fhe_tpu_torch.utils.perf's tracing at n = 256 on the CPU: the ``fhe.*``
profiler spans of the facade and the scheme and how they nest, their cost
with no profiler recording (none: no ``record_function``), the process
record of one-time work, the caches' misses as monitor counts, the
allocator fields, and the benchmark's readers of all of it."""

import importlib.util
import os
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from fhe_tpu_torch import FHE
from fhe_tpu_torch.ops import _build
from fhe_tpu_torch.utils import perf

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
# substrings the benchmark's readers match device operations by
KERNEL_NAMES = ("keyswitch", "ks_inner")
MUL_SPANS = ("stack", "products", "behz", "bconv", "relin", "add", "split")


@pytest.fixture(scope="module")
def dot():
    f = FHE(poly_degree=256, log_q=60, seed=5, device="cpu")
    pk, sk = f.keygen()
    rlk = f.relinkey_gen(sk)
    gk = f.galoiskey_gen(sk, elements=f.sum_slots_elements())
    cts = f.encrypt_batch([f.encode([i + 1, 2 * i]) for i in range(4)], pk)
    pt = f.encode(list(range(128)))
    return f, sk, rlk, gk, cts, pt


def _spans(prof) -> list[tuple[float, float, str]]:
    """(start, end, name) of every host-side fhe.* event, by start, the
    outer of two that start together first."""
    return sorted(((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("fhe.")
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda s: (s[0], -s[1]))


def _parents(spans) -> list[tuple[str, str | None]]:
    """(name, name of the innermost span enclosing it) for each span."""
    out, stack = [], []
    for start, end, name in spans:
        while stack and stack[-1][1] <= start:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((start, end, name))
    return out


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    mon = perf.PerformanceMonitor()
    assert not autograd_profiler._is_profiler_enabled
    assert perf.span("x") is perf.span("y")          # the shared no-op
    with perf.span("x"), mon.time("op"):
        pass
    assert mon.get_stats().counts == {"op": 1}


def test_spans_nest_as_the_code(dot):
    f, sk, rlk, gk, cts, pt = dot
    f.sum_slots(f.multiply_plain(cts[0], pt, cache_operand=True), gk)   # warm the caches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = f.multiply_plain(cts[0], pt, cache_operand=True)
        total = f.sum_slots(out, gk)
        prods = f.multiply_batch(cts[:2], cts[2:], rlk)
    spans = _spans(prof)
    parents = _parents(spans)
    names = [name for _, _, name in spans]
    assert not [n for n in names if any(k in n for k in KERNEL_NAMES)]

    assert ("fhe.multiply_plain", None) in parents
    assert {p for n, p in parents if n.startswith("fhe.plain.")} == {"fhe.multiply_plain"}
    assert {n for n in names if n.startswith("fhe.plain.")} >= {"fhe.plain.to_ntt", "fhe.plain.mul"}

    # 128 slots a row: radix-4 stages at 1, 4 and 16, a radix-2 one at 64
    stages = [(n, p) for n, p in parents if n == "fhe.sum_slots.stage"]
    assert stages == [("fhe.sum_slots.stage", "fhe.sum_slots")] * 3
    for step in ("digits", "inner", "accumulate"):
        assert [p for n, p in parents if n == f"fhe.hoisted.{step}"] == ["fhe.sum_slots.stage"] * 3
    starts = {name: start for start, _, name in spans}   # the last of each name
    assert (starts["fhe.hoisted.digits"] < starts["fhe.hoisted.inner"]
            < starts["fhe.hoisted.accumulate"] < starts["fhe.sum_slots.columns"])
    assert ("fhe.sum_slots.columns", "fhe.sum_slots") in parents

    mul = [(n, p) for n, p in parents if n.startswith("fhe.mul.")]
    assert mul == [(f"fhe.mul.{s}", "fhe.multiply_batch") for s in MUL_SPANS]

    want = [a * b for a, b in zip(f.decode(f.decrypt(cts[0], sk))[:2],
                                  f.decode(f.decrypt(cts[2], sk))[:2])]
    assert list(f.decode(f.decrypt(prods[0], sk))[:2]) == want
    assert f.decode(f.decrypt(total, sk)).shape == (256,)


def test_warm_request_misses_no_cache(dot):
    f, sk, rlk, gk, cts, pt = dot
    pt2 = f.encode([7] * 5)
    for request in range(2):
        f.monitor.reset()
        f.sum_slots(f.multiply_plain(cts[1], pt2, cache_operand=True), gk)
        counts = f.monitor.get_stats().counts
        assert counts["multiply_plain"] == 1 and counts["sum_slots"] == 1
        if request:
            assert "plain_ntt_operand" not in counts and "hoisted_galois_keys" not in counts
        else:
            assert counts["plain_ntt_operand"] == 1


def test_process_record_survives_reset(dot):
    f, *_ = dot
    g = FHE(poly_degree=256, log_q=60, seed=6, device="cpu")
    before = perf.PROCESS.get_stats()
    g.monitor.reset()
    f.monitor.reset()
    after = perf.PROCESS.get_stats()
    assert after == before
    assert {"tables.primes", "tables.context", "keys.keygen", "keys.relin",
            "keys.galois", "keys.hoisted"} <= set(after.counts)


def test_kernel_load_and_build_spans(tmp_path, monkeypatch):
    """A load that finds its libraries times ``kernels.load`` alone; one
    that runs the compiler also ``kernels.build`` inside it."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    record = perf.PerformanceMonitor()
    monkeypatch.setattr(_build, "PROCESS", record)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "libs")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: os.path.basename(path))
    libs = _build._load_all.__wrapped__()
    assert libs["ntt"] == "libntt.so"
    assert record.get_stats().counts == {"kernels.load": 1, "kernels.build": 1}
    _build._load_all.__wrapped__()
    assert record.get_stats().counts == {"kernels.load": 2, "kernels.build": 1}
    times = record.get_stats().times_ms
    assert times["kernels.load"] >= times["kernels.build"] > 0


def test_allocator_fields(dot, monkeypatch):
    """None where CUDA is not initialised at the reset (as on the CPU), else
    the allocator's bytes and blocks since the reset."""
    f, *_ = dot
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    f.monitor.reset()
    f.add(*dot[4][:2])
    stats = f.monitor.get_stats()
    assert stats.alloc_bytes is None and stats.allocs is None
    counters = {"allocated_bytes.all.allocated": 1000, "allocation.all.allocated": 7}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda: dict(counters))
    f.monitor.reset()
    counters.update({"allocated_bytes.all.allocated": 4096, "allocation.all.allocated": 9})
    stats = f.monitor.get_stats()
    assert (stats.alloc_bytes, stats.allocs) == (3096, 2)


def _reader(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(calls, times=None, counts=None, alloc_bytes=None):
    return types.SimpleNamespace(
        window=types.SimpleNamespace(calls=calls),
        monitor=perf.PerfStats(times_ms=times or {}, counts=counts or {},
                               alloc_bytes=alloc_bytes))


def test_facade_and_alloc_readers():
    facade, alloc = _reader("facade_host_ms.dot"), _reader("alloc_mb_per_call")
    run = _run(4, {"multiply_plain": 2.0, "sum_slots": 18.0},
               {"multiply_plain": 4, "sum_slots": 4}, alloc_bytes=12_000_000)
    assert facade(run) == pytest.approx(5.0)
    assert alloc(run) == pytest.approx(3.0)
    assert facade(_run(4, {"sum_slots": 18.0}, {"sum_slots": 4})) is None   # the parent's monitor
    assert alloc(_run(4)) is None
    assert alloc(_run(0, alloc_bytes=5)) is None


@pytest.mark.parametrize("metric, spans, want", [
    ("setup_tables_s", ("tables.primes", "tables.context"), 2),
    ("setup_kernel_load_s", ("kernels.load",), 1),
    ("setup_keys_s", ("keys.keygen", "keys.relin", "keys.galois", "keys.hoisted"), 4),
])
def test_setup_readers(monkeypatch, metric, spans, want):
    read = _reader(metric)
    record = perf.PerformanceMonitor()
    monkeypatch.setattr(perf, "PROCESS", record)
    assert read(None) is None                        # nothing of its family yet
    for op in spans + ("device.start", "kernels.build"):
        record._total_ms[op] += 500.0
        record._counts[op] += 1
    assert read(None) == pytest.approx(0.5 * want)
    monkeypatch.delitem(sys.modules, "fhe_tpu_torch.utils.perf")
    assert read(None) is None                        # a program without the record
