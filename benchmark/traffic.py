"""The general traffic generator: reads a mix file of ``benchmark/traffic/``
and drives the program's facade with it.

A mix names its loop and its request:

* ``"loop": "offline"`` -- HEBench's Offline category: calls of
  ``FHE.multiply_batch`` on ``batch`` pairs drawn from a pool of
  ``pool.pairs`` ciphertext pairs, at most ``in_flight`` calls queued on the
  card (before the next call the host waits on an event recorded after the
  oldest).  The window ends with a synchronise; its statistic is the pairs
  completed per second of the window.
* ``"loop": "closed"`` -- HEBench's Latency category, one client: a request
  takes a query from a pool of ``pool.ciphertexts`` and runs the request's
  steps on it (``multiply_plain`` by a weight vector drawn from
  ``pool.plaintexts``, whose NTT operands are cached when
  ``cache_operand``; ``sum_slots``), then synchronises; the next request
  starts after that.  Its statistics are the median and 95th percentile of
  every request's latency, start to synchronise, on the host clock.

Every pool is built from cleartext slot vectors drawn uniformly mod t from
the run's seed, every slot filled.  Whatever a request's output should
decrypt to is worked out here from those cleartexts, for the reference to
judge a sample of the outputs drawn from the seed.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time

import numpy as np
import torch
from torch.profiler import record_function

LOOPS = {"offline": ("multiply_batch",), "closed": ("multiply_plain", "sum_slots")}


@dataclasses.dataclass
class Window:
    """What a window did: its seconds, the operations it completed, its
    calls (requests), the statistics a mix maps onto end-to-end metrics,
    each call's host seconds and each request's latency."""

    seconds: float
    attempted: int
    calls: int
    stats: dict
    host_s: list
    samples: list = dataclasses.field(default_factory=list)
    wait_s: float = 0.0


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


class _NoEvent:
    """Stands in for a CUDA event where the program runs on the host."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_mix(spec: dict) -> None:
    """Raise unless ``spec`` is a mix this generator can drive."""
    loop = spec.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"traffic loop {loop!r}: expected one of {sorted(LOOPS)}")
    steps = tuple(spec["request"])
    if loop == "offline" and steps != LOOPS["offline"]:
        raise ValueError(f"an offline mix runs {LOOPS['offline']}, not {steps}")
    if loop == "closed" and (not steps or set(steps) - set(LOOPS["closed"])):
        raise ValueError(f"a closed mix chains steps of {LOOPS['closed']}, not {steps}")


class Traffic:
    """One mix on one configuration: its pools, keys, loop and expected
    outputs."""

    def __init__(self, spec: dict, fhe, seed: int):
        self.spec, self.fhe = spec, fhe
        self.n, self.t = fhe.params.n, fhe.params.t
        check_mix(spec)
        self.loop = spec["loop"]
        self.steps = tuple(spec["request"])
        self.batch = int(spec["batch"]) if self.loop == "offline" else 1
        self.device = fhe.device
        self.schedule = np.random.default_rng([seed, 1])
        self.sample = Reservoir(int(spec["check_sample"]), random.Random(seed * 2 + 1))

    # -- set-up --
    def setup(self, gen: torch.Generator, pk, sk) -> None:
        """The pools (cleartexts from ``gen``, encoded and encrypted), the
        request's keys, and the cached plaintext operands."""
        fhe, pool = self.fhe, self.spec["pool"]
        n_ct = 2 * pool["pairs"] if self.loop == "offline" else pool["ciphertexts"]
        n_pt = pool.get("plaintexts", 0) if "multiply_plain" in self.steps else 0
        clear = torch.randint(0, self.t, (n_ct + n_pt, self.n), generator=gen,
                              device=self.device, dtype=torch.int64).cpu().numpy()
        self.clear_ct, self.clear_pt = clear[:n_ct], clear[n_ct:]
        self.cts = fhe.encrypt_batch([fhe.encode(v) for v in self.clear_ct], pk)
        self.pts = [fhe.encode(v) for v in self.clear_pt]
        if self.spec.get("cache_operand"):
            for pt in self.pts:
                fhe.plain_operand(pt)
        self.rlk = fhe.relinkey_gen(sk) if "multiply_batch" in self.steps else None
        self.gal = (fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
                    if "sum_slots" in self.steps else None)

    def release(self) -> None:
        """Drop every tensor of the program that the mix holds."""
        self.cts = self.pts = self.rlk = self.gal = None

    # -- one call or request --
    def _call(self, pairs: np.ndarray):
        half = self.spec["pool"]["pairs"]
        with record_function("bench.multiply_batch"):
            return self.fhe.multiply_batch([self.cts[i] for i in pairs],
                                           [self.cts[half + i] for i in pairs], self.rlk)

    def _request(self, query: int, weight: int):
        ct = self.cts[query]
        for step in self.steps:
            with record_function(f"bench.{step}"):
                if step == "multiply_plain":
                    ct = self.fhe.multiply_plain(ct, self.pts[weight],
                                                 cache_operand=bool(self.spec.get("cache_operand")))
                else:
                    ct = self.fhe.sum_slots(ct, self.gal)
        return ct

    def _draw(self):
        if self.loop == "offline":
            return self.schedule.integers(0, self.spec["pool"]["pairs"], size=self.batch)
        return (int(self.schedule.integers(0, len(self.cts))),
                int(self.schedule.integers(0, max(len(self.pts), 1))))

    def warmup(self, rounds: int = 2) -> None:
        """Every shape of the window, ``rounds`` times, then a synchronise."""
        for _ in range(rounds):
            drawn = self._draw()
            if self.loop == "offline":
                self._call(drawn)
            else:
                self._request(*drawn)
        _sync(self.device)

    # -- the measured window --
    def run(self, seconds: float) -> Window:
        return self._offline(seconds) if self.loop == "offline" else self._closed(seconds)

    def _offline(self, seconds: float) -> Window:
        depth = int(self.spec["in_flight"])
        queued = collections.deque()
        host = []
        calls = 0
        wait = 0.0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            if len(queued) == depth:
                w0 = time.perf_counter()
                queued.popleft().synchronize()
                wait += time.perf_counter() - w0
            pairs = self._draw()
            c0 = time.perf_counter()
            outs = self._call(pairs)
            host.append(time.perf_counter() - c0)
            event = torch.cuda.Event() if self.device.type == "cuda" else _NoEvent()
            event.record()
            queued.append(event)
            self.sample.offer((outs, pairs))
            calls += 1
        with record_function("bench.synchronize"):
            _sync(self.device)
        elapsed = time.perf_counter() - t0
        done = calls * self.batch
        return Window(elapsed, done, calls, {"completed_per_s": done / elapsed}, host,
                      wait_s=wait)

    def _closed(self, seconds: float) -> Window:
        latency, host = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        end = t0
        while time.perf_counter() < deadline:
            query, weight = self._draw()
            r0 = time.perf_counter()
            out = self._request(query, weight)
            r1 = time.perf_counter()
            with record_function("bench.synchronize"):
                _sync(self.device)
            end = time.perf_counter()
            latency.append(end - r0)
            host.append(r1 - r0)
            self.sample.offer((out, (query, weight)))
        ms = np.array(latency) * 1e3
        stats = {"latency_p50_ms": float(np.percentile(ms, 50)),
                 "latency_p95_ms": float(np.percentile(ms, 95))}
        return Window(end - t0, len(latency), len(latency), stats, host, latency)

    # -- what the sampled outputs should decrypt to --
    def sampled_outputs(self) -> list[tuple]:
        """(residues, expected slots [n], whether it is a two-component
        coefficient-form ciphertext at level 0) of each sampled output,
        copied to the host; one output of each sampled call."""
        out = []
        for item, drawn in self.sample.items:
            if self.loop == "offline":
                j = self.sample.rng.randrange(len(drawn))
                i = int(drawn[j])
                half = self.spec["pool"]["pairs"]
                want = self.clear_ct[i] * self.clear_ct[half + i] % self.t
                ct = item[j] if j < len(item) else None
            else:
                want = self.clear_ct[drawn[0]]
                for step in self.steps:
                    if step == "multiply_plain":
                        want = want * self.clear_pt[drawn[1]] % self.t
                    else:
                        want = np.full(self.n, int(want.sum() % self.t), dtype=np.int64)
                ct = item
            if ct is None:                       # the call returned too few outputs
                out.append((None, want, False))
                continue
            plain_form = (not ct.is_ntt_form and ct.level == 0
                          and tuple(ct.data.shape) == (self.fhe.params.k, 2, self.n))
            out.append((ct.data.cpu().numpy(), want, plain_form))
        return out
