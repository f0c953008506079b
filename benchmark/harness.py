"""One run of one cell: look the cell up by name, set the program up, warm
up, measure a window, judge a sample of the window's outputs against the
plain reference, and assemble the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name, under the checkout root:

    BENCHMARK.json                      the cells, metrics and bounds
    benchmark/configs/<config>.json     the SecurityParams a configuration builds
    benchmark/traffic/<traffic>.json    a mix, read by traffic.py
    benchmark/limits/<workload>.json    the limits of a cell's checks
    benchmark/metrics/<metric>.py       a per-layer reader: read(run) -> float | None
                                        (or <name before the first dot>.py,
                                        shared by a metric's mixes)

so a later cell, configuration, mix or metric is a new file and a new
entry, and no edit to a file that exists.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from benchmark import reference, trace
from benchmark.traffic import Traffic

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_tpu")
OPS_MODULES = ("ntt_cuda", "rns_cuda", "galois_cuda", "decrypt_cuda")
GAP_PASS_S = 3.0    # the traced run's second pass, for the idle gaps


@dataclasses.dataclass
class Cell:
    """A cell's entries and files."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one without it is every cell's that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(name=workload, workload=w,
                config=json.loads((root / cfg["file"]).read_text()),
                traffic=json.loads((root / "benchmark" / "traffic"
                                    / f"{w['traffic']}.json").read_text()),
                limits=json.loads((root / "benchmark" / "limits"
                                   / f"{workload}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer, root=root)


def reader_path(root: Path, metric: str) -> Path:
    """benchmark/metrics/<metric>.py, or where there is none, the file of
    the metric's name before its first dot: idle_share.py reads
    idle_share.mul and idle_share.dot alike."""
    folder = root / "benchmark" / "metrics"
    own = folder / f"{metric}.py"
    return own if own.is_file() else folder / f"{metric.split('.')[0]}.py"


def load_reader(cell: Cell, metric: str):
    """The ``read`` function of the metric's reader (``reader_path``)."""
    path = reader_path(cell.root, metric)
    spec = importlib.util.spec_from_file_location(f"_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each of the run's random streams."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def make_secret(gen: torch.Generator, n: int, weight: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ternary secret: ``weight`` nonzero coefficients at uniform
    positions, each +1 or -1; (positions, signs)."""
    pos = torch.randperm(n, generator=gen, device=gen.device)[:weight]
    sign = torch.randint(0, 2, (weight,), generator=gen, device=gen.device) * 2 - 1
    return pos, sign


def keypair(fhe, gen: torch.Generator, pos: torch.Tensor, sign: torch.Tensor):
    """The program's key pair of the benchmark's secret, with a uniform a
    and a rounded Gaussian e (sigma of the configuration) drawn from
    ``gen``."""
    from fhe_tpu_torch.scheme import bfv

    p = fhe.params
    q = torch.tensor(p.q_primes, dtype=torch.int64, device=gen.device).view(-1, 1, 1)
    s = torch.zeros((1, 1, p.n), dtype=torch.int64, device=gen.device)
    s[0, 0, pos] = sign
    a = torch.randint(0, 2 ** 62, (p.k, 1, p.n), generator=gen, device=gen.device)
    e = torch.round(torch.randn((1, 1, p.n), generator=gen, device=gen.device)
                    * p.security.sigma).to(torch.int64)
    rns = [(x % q).to(torch.int32).to(fhe.device) for x in (s, a, e)]
    return bfv.keygen_from_noise(fhe.ctx, *rns)


def counters() -> dict:
    """Every ``*launches`` counter of the program's kernel wrappers."""
    out = {}
    for name in OPS_MODULES:
        module = sys.modules.get(f"fhe_tpu_torch.ops.{name}")
        for fname, fn in vars(module).items() if module else ():
            for attr, value in getattr(fn, "__dict__", {}).items():
                if attr.endswith("launches") and isinstance(value, int):
                    out[f"{name}.{fname}.{attr}"] = value
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_note() -> str:
    """The card's name, power limit and SM clock, from nvidia-smi."""
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        got = ""
    return got or "nvidia-smi gave nothing"


def _device_events(prof) -> tuple[list, list]:
    """(device operations, host operations of the busiest thread) of a
    profile, as (start_us, end_us, name), from the profiler's raw events
    (building its event tree takes minutes for a window of some hundred
    thousand operations)."""
    from torch.autograd import DeviceType

    dev, host = [], {}
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
        if e.device_type() == DeviceType.CUDA:
            # the benchmark's own spans are mirrored on the device timeline
            # as annotations; they are not work of the card
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                dev.append(item)
        else:
            host.setdefault(e.start_thread_id(), []).append(item)
    return dev, max(host.values(), key=len) if host else []


def _profiler(device: torch.device, host_ops: bool):
    """A profiler of the card's activity, and with ``host_ops`` of the
    host's operations too (on the CPU, of the host's alone)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host_ops or not activities:
        activities.append(ProfilerActivity.CPU)
    return profile(activities=activities)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None, chips: int = 1) -> tuple[dict, list[str]]:
    """One run; returns the result line's object and the check lines."""
    from fhe_tpu_torch import FHE
    from fhe_tpu_torch.params import SecurityParams, make_scheme_params

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    params = make_scheme_params(SecurityParams(**cell.config["security"]))
    fhe = FHE(params, seed=derived_seed(seed, 1), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 2))
    pos, sign = make_secret(gen, params.n, params.security.hamming_weight)
    pk, sk = keypair(fhe, gen, pos, sign)
    mix = Traffic(cell.traffic, fhe, derived_seed(seed, 3))
    mix.setup(gen, pk, sk)
    mix.warmup()
    setup_s = time.perf_counter() - t_start

    before = counters()
    fhe.monitor.reset()
    prof = None
    if traced:
        # the card's activity alone: recording every host operation as well
        # about doubles the host's time a call, and the window's readings
        # would show the profiler's cost
        prof = _profiler(device, host_ops=False)
        prof.start()
    window = mix.run(seconds)
    if prof is not None:
        prof.stop()
    print(f"window {window.seconds:.3f} s: {window.calls} calls, {sum(window.host_s):.3f} s "
          f"in them on the host, {window.wait_s:.3f} s waiting on the card", file=sys.stderr)
    launches = {k: v - before.get(k, 0) for k, v in counters().items()}
    monitor = fhe.monitor.get_stats()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        ops, _ = _device_events(prof)
        # what the host was doing in the card's idle gaps: a second, short
        # pass that records the host's operations too; only the breakdown's
        # idle_gaps come from it
        prof = _profiler(device, host_ops=True)
        prof.start()
        mix.run(min(seconds, GAP_PASS_S))
        prof.stop()
        gap_ops, host = _device_events(prof)
        del prof

    outputs = mix.sampled_outputs()
    k, t, batch = params.k, params.t, mix.batch
    ref_primes = reference.ntt_primes(params.n, k, exclude=(t,))
    mix.release()
    del fhe, pk, sk, mix
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_start = time.perf_counter()
    wrong, noise, failed = 0, 0.0, 0
    for data, want, plain_form in outputs:
        if not plain_form or tuple(ref_primes) != params.q_primes:
            wrong += params.n
            failed += 1
            continue
        w, v = reference.judge(data, want, pos, sign, ref_primes, t, device)
        wrong += w
        noise = max(noise, v)
        failed += int(w > 0 or v > cell.limits["noise"])
    print(f"the reference judged {len(outputs)} outputs in "
          f"{time.perf_counter() - ref_start:.2f} s", file=sys.stderr)
    checks = {"wrong_slots": {"value": wrong, "limit": cell.limits["wrong_slots"]},
              "noise": {"value": noise, "limit": cell.limits["noise"]}}
    correct = (bool(outputs) and wrong <= cell.limits["wrong_slots"]
               and noise <= cell.limits["noise"])

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    if traced:
        run = types.SimpleNamespace(params=params, kd=math.ceil(k / params.security.ks_omega),
                                    batch=batch, window=window, launches=launches,
                                    monitor=monitor, ops=ops)
        values = {m["name"]: (load_reader(cell, m["name"])(run), m["unit"])
                  for m in cell.per_layer}
        device_info.update(busy_s=trace.busy_us(ops) * 1e-6, window_s=window.seconds)
    else:
        values = {m["name"]: (setup_s if m["name"] == "setup_s"
                              else window.stats[cell.traffic["metrics"][m["name"]]], m["unit"])
                  for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": window.attempted, "failed": failed,
              "metrics": {name: {"value": v, "unit": unit}
                          for name, (v, unit) in values.items() if v is not None},
              "device": device_info}
    if traced:
        result["breakdown"] = {"device_ops": trace.top_ops(ops),
                               "idle_gaps": trace.idle_gaps(gap_ops, host)}
    result["checks"] = checks
    lines = [f"{name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
    return result, lines
