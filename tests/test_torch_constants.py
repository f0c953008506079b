"""The port's host constants equal the JAX package's: primes, scheme plan,
NTT tables (q primes and the encoder's t), decryption and Δ constants, and
the multiply's level-0 context fields (Bsk tables, t-folded mul tables,
SmMRq / FastFloor / Shenoy-Kumaresan constants, relinearization digits).
Reference functions: fhe_tpu.params.make_scheme_params,
fhe_tpu.ops.ntt.build_tables, fhe_tpu.ops.ntt_pallas.build_mul_tables,
fhe_tpu.ops.rns.make_decrypt, fhe_tpu.scheme.context.make_context and
_level_host.  Integers, tolerance 0."""

import numpy as np
import pytest

from fhe_tpu import params as jparams
from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.ops import ntt_pallas as jnpal
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


def _assert_consts_equal(got, want, name):
    """Every field of a JAX NamedTuple of constants (arrays, scalars or
    nested tuples) against the port's dataclass of the same field names."""
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if hasattr(w, "_fields"):
            _assert_consts_equal(g, w, f"{name}.{f}")
            continue
        g = _u32(g) if hasattr(g, "numpy") else np.uint32(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name}.{f}")


@pytest.mark.parametrize("n,t,k", CASES)
def test_multiply_context_consts_match(n, t, k):
    jp, tp = _plans(n, t, k)
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = tcontext.make_context(tp, device="cpu")
    kb = jctx.bsk_counts[0]
    assert len(tp.bsk_primes) == kb and tp.bsk_primes == jp.bsk_primes
    # the Bsk tables the t-folded ones are made from
    ntt_bsk = tntt.build_tables(n, tp.bsk_primes, "cpu")
    for f in tntt.FIELDS:
        np.testing.assert_array_equal(_u32(getattr(ntt_bsk, f)),
                                      np.asarray(getattr(jctx.ntt_bsk, f)),
                                      err_msg=f)
    # the port keeps compact twiddles: only the scalars carry the t fold,
    # and the twiddles are the q context's own tensors
    want_q, want_b = jnpal.build_mul_tables(n, jp.q_primes, jp.bsk_primes, t,
                                            k, kb)
    for got, want, base in zip(tctx.mul_tables, (want_q, want_b),
                               (tctx.ntt_q, ntt_bsk)):
        assert got.primes == base.primes
        for f in ("p", "mu", "n_inv", "n_inv_shoup"):
            np.testing.assert_array_equal(_u32(getattr(got, f)),
                                          np.asarray(getattr(want, f))[:, 0],
                                          err_msg=f)
        for f in ("psi_br", "psi_br_shoup", "ipsi_br", "ipsi_br_shoup"):
            assert np.array_equal(_u32(getattr(got, f)), _u32(getattr(base, f)))
    assert tctx.mul_tables[0].psi_br is tctx.ntt_q.psi_br
    _assert_consts_equal(tctx.smq, jctx.smq, "smq")
    _assert_consts_equal(tctx.floor_c, jctx.floor_c, "floor_c")
    _assert_consts_equal(tctx.sk_c, jctx.sk_c, "sk_c")
    np.testing.assert_array_equal(_u32(tctx.inv_qhat), np.asarray(jctx.inv_qhat))
    # the relinearization digits' Shoup companions, from the host builder
    np.testing.assert_array_equal(tcontext._level_host(jp.q_primes, t)[3],
                                  np.asarray(jctx.inv_qhat_shoup))


def test_number_theory_matches():
    for n in (256, 1024, 8192):
        ps = jprimes.find_ntt_primes(n, 4)
        assert tprimes.find_ntt_primes(n, 4) == ps
        for p in ps + [65537, 786433]:
            assert tprimes.negacyclic_psi(n, p) == jprimes.negacyclic_psi(n, p)
    for x in (0, 1, 2, 65537, 786433, (1 << 61) - 1, 1_000_000_007 * 3):
        assert tprimes.is_prime(x) == jprimes.is_prime(x)
