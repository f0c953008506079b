"""The port's randomized-circuit fuzzer (scripts/fuzz_torch.py) against the
JAX package's (scripts/fuzz.py), and a fixed circuit run op by op in both
packages from the same state.

For a seed, fuzz_torch.py must draw the circuit fuzz.py draws: the same
scheme, n, log_q and t, the same trace of ops that ran (ValueError skips
included), the same tracked noise budget, and both must pass.  Seed 1011
is BFV at n = 128, ks_omega = 1 (a multiply, a rotation, a domain toggle);
tests/test_torch_fuzz_bgv.py runs two BGV seeds at ks_omega = 2 and the
fixed circuit, which starts from JAX's keys and fresh ciphertexts, carried
into the port with convert.*_from_numpy: every intermediate ciphertext
must equal JAX's, tolerance 0 (budgets: JAX carries them in float32, 1e-4)."""

import importlib.util
import re
import sys
import warnings
from pathlib import Path

import pytest
import jax

from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params

ROOT = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_fuzzers():
    """(fuzz.py, fuzz_torch.py) as modules.  fuzz.py points JAX's compilation
    cache at its own directory when imported; the test session's setting is
    put back."""
    cache_dir = jax.config.jax_compilation_cache_dir
    jfuzz = _load("fhe_jax_fuzz", ROOT / "scripts" / "fuzz.py")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return jfuzz, _load("fuzz_torch", ROOT / "scripts" / "fuzz_torch.py")


@pytest.fixture(scope="module")
def fuzzers():
    return load_fuzzers()


_DESC = re.compile(r"seed=(\d+) (\w+) n=(\d+) logq=(\d+) t=(\d+) ops=(\[.*?\]) "
                   r"budget=\S+ tracked=(\S+)")


def check_same_circuit(fuzzers, seed: int) -> None:
    """fuzz.py's and fuzz_torch.py's circuit for ``seed``: the same
    parameters, ops and tracked budget, and both pass."""
    jfuzz, tfuzz = fuzzers
    ok_j, desc_j = jfuzz.run_circuit(seed)
    ok_t, desc_t, record = tfuzz.run_circuit(seed, "cpu")
    assert ok_j and ok_t, (desc_j, desc_t)
    _, scheme, n, log_q, t, ops, tracked = _DESC.match(desc_j).groups()
    d = tfuzz.draw(seed)
    assert (d.scheme, d.params.n, d.log_q, d.params.t) == (scheme, int(n), int(log_q), int(t))
    assert str(record.run.ops) == ops, (desc_j, desc_t)
    assert f"{float(record.run.ct.noise_budget):.2f}" == tracked
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jmake_params(JSecurity(**{f: getattr(d.params.security, f) for f in (
            "lambda_", "poly_degree", "log_q", "sigma", "hamming_weight", "plain_modulus",
            "ks_omega")}))
    assert (jp.q_primes, jp.aux_primes, jp.m_sk) == (d.params.q_primes, d.params.aux_primes,
                                                     d.params.m_sk)


def test_fuzz_draws_the_same_circuit(fuzzers):
    check_same_circuit(fuzzers, 1011)
