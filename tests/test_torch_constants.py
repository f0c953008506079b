"""The port's host constants equal the JAX package's: primes, scheme plan,
NTT tables (q primes and the encoder's t), decryption and Δ constants.
Reference functions: fhe_tpu.params.make_scheme_params,
fhe_tpu.ops.ntt.build_tables, fhe_tpu.ops.rns.make_decrypt,
fhe_tpu.scheme.context._level_host.  Integers, tolerance 0."""

import numpy as np
import pytest

from fhe_tpu import params as jparams
from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.ops import rns as jrns
from fhe_tpu.scheme import context as jcontext

from fhe_tpu_torch import params as tparams
from fhe_tpu_torch import primes as tprimes
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.scheme import context as tcontext


def _u32(x):
    """int32 tensor -> numpy uint32 with the same bits."""
    return x.numpy().view(np.uint32)


CASES = [(n, t, k) for n, t in ((256, 65537), (1024, 65537), (1024, 786433))
         for k in (2, 3)]


def _plans(n, t, k):
    kw = dict(poly_degree=n, log_q=30 * k, plain_modulus=t, lambda_=0,
              hamming_weight=16)
    return (jparams.make_scheme_params(jparams.SecurityParams(**kw)),
            tparams.make_scheme_params(tparams.SecurityParams(**kw)))


@pytest.mark.parametrize("n,t,k", CASES)
def test_scheme_plan_matches(n, t, k):
    jp, tp = _plans(n, t, k)
    for f in ("n", "t", "q_primes", "aux_primes", "m_sk", "gamma", "m_tilde"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.q == jp.q and tp.delta == jp.delta and tp.k == k
    assert tp.modulus_chain() == jp.modulus_chain()


@pytest.mark.parametrize("n,t,k", CASES)
def test_ntt_tables_match(n, t, k):
    jp, _ = _plans(n, t, k)
    for moduli in (jp.q_primes, (t,)):
        want = jntt.build_tables(n, moduli)
        got = tntt.build_tables(n, moduli, "cpu")
        assert got.primes == tuple(moduli)
        for f in tntt.FIELDS:
            np.testing.assert_array_equal(
                _u32(getattr(got, f)), np.asarray(getattr(want, f)),
                err_msg=f)


@pytest.mark.parametrize("n,t,k", CASES)
def test_decrypt_and_delta_consts_match(n, t, k):
    jp, _ = _plans(n, t, k)
    want = jrns.make_decrypt(jp.q_primes, t, jp.gamma)
    got = trns.make_decrypt(jp.q_primes, t, jp.gamma, "cpu")
    for f in want._fields:
        g = getattr(got, f)
        g = _u32(g) if f in trns.ARRAY_FIELDS else np.uint32(g)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                      err_msg=f)
    for g, w in zip(tcontext._level_host(jp.q_primes, t),
                    jcontext._level_host(jp.q_primes, t)[:2]):
        np.testing.assert_array_equal(g, w)


def test_number_theory_matches():
    for n in (256, 1024, 8192):
        ps = jprimes.find_ntt_primes(n, 4)
        assert tprimes.find_ntt_primes(n, 4) == ps
        for p in ps + [65537, 786433]:
            assert tprimes.negacyclic_psi(n, p) == jprimes.negacyclic_psi(n, p)
    for x in (0, 1, 2, 65537, 786433, (1 << 61) - 1, 1_000_000_007 * 3):
        assert tprimes.is_prime(x) == jprimes.is_prime(x)
