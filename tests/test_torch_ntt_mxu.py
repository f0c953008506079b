"""The four-step int8 GEMM engine of the port (ops/ntt_mxu.py) against
fhe_tpu.ops.ntt_mxu and the JAX multiply with use_mxu=True, tolerance 0:
tests/test_ntt_mxu.py's cases (round trip, the polymul against the
merged-psi engine, the forward against a direct negacyclic evaluation),
the table builder's bound errors, the engine's tables, digits, Horner
recombination, forward and inverse against JAX's at n = 256 and 1024, and
make_context(use_mxu=True)'s multiply_no_relin (and multiply) against
JAX's use_mxu=True multiply and the port's default multiply: BFV at
n = 256, log_q = 90 (tests/test_ntt_mxu.py's configuration) and n = 1024,
BGV at n = 256.  On the CPU the GEMMs are torch._int_mm's CPU kernel;
tests/test_torch_cuda.py holds the engine on the card against this run."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt_mxu as jmxu
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import bgv as jbgv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_mxu as tmxu
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bgv as tbgv
from fhe_tpu_torch.scheme.context import make_context


@pytest.fixture(scope="module", params=[256, 1024])
def engines(request):
    n = request.param
    ps = jprimes.find_ntt_primes(n, 2, bits=30)
    return (n, ps, jmxu.build_mxu_tables(n, ps), tmxu.build_mxu_tables(n, ps, device="cpu"),
            tntt.build_tables(n, ps, "cpu"))


def _rand(rng, ps, n, batch):
    return rng.integers(0, np.array(ps, dtype=np.uint64)[:, None, None],
                        size=(len(ps), batch, n)).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def test_roundtrip_exact(engines):
    n, ps, _, mt, _ = engines
    x = _t(_rand(np.random.default_rng(1), ps, n, 3))
    assert torch.equal(tmxu.ntt_inverse(tmxu.ntt_forward(x, mt), mt), x)


def test_polymul_matches_merged_psi_engine(engines):
    """The orders differ (four-step natural, merged-psi bit-reversed), the
    products may not: equal to ntt.polymul_negacyclic and to JAX's engine."""
    n, ps, jt, mt, tb = engines
    rng = np.random.default_rng(2)
    a, b = _rand(rng, ps, n, 2), _rand(rng, ps, n, 2)
    got = tmxu.polymul_negacyclic(_t(a), _t(b), mt)
    assert torch.equal(got, tntt.polymul_negacyclic(_t(a), _t(b), tb))
    want = jax.jit(jmxu.polymul_negacyclic)(jnp.asarray(a), jnp.asarray(b), jt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_is_negacyclic_evaluation(engines):
    """X[j2 + n2*j1] = sum_i x_i psi^i w^(i j) mod p at sampled j."""
    n, ps, _, mt, _ = engines
    p = ps[0]
    psi = jprimes.negacyclic_psi(n, p)
    w = pow(psi, 2, p)
    rng = np.random.default_rng(3)
    x = [int(v) for v in rng.integers(0, p, size=n)]
    xs = torch.tensor(x, dtype=torch.int32).view(1, 1, n).expand(len(ps), 1, n)
    got = tmxu.ntt_forward(xs.contiguous(), mt)[0, 0]
    for j in [0, n - 1] + [int(v) for v in rng.integers(0, n, size=4)]:
        want = sum(x[i] * pow(psi, i, p) % p * pow(w, i * j % n, p) for i in range(n)) % p
        assert int(got[j]) == want, j


def test_table_builder_bound_errors():
    ps = jprimes.find_ntt_primes(16384, 1, bits=30)
    # max(n1, n2) = 8192 > 4096: the shifted diagonal would not be a residue
    with pytest.raises(ValueError, match="contraction length"):
        tmxu.build_mxu_tables(16384, ps, n1=2, device="cpu")
    with pytest.raises(ValueError, match="30-bit primes"):
        tmxu.build_mxu_tables(256, [7681], device="cpu")
    with pytest.raises(ValueError, match="2\\^30"):
        tmxu._limbs_host(np.array([[1 << 30]], dtype=np.uint32))
    # the JAX builder refuses the same split
    with pytest.raises(ValueError, match="contraction length"):
        jmxu.build_mxu_tables(16384, ps, n1=2)


def _gemm_of(limbs: np.ndarray, side: str) -> np.ndarray:
    """JAX's int8 [k, 4, a, b] digit matrices in the port's GEMM layout."""
    lm = limbs if side == "right" else limbs.transpose(0, 1, 3, 2)
    k, _, c, o = lm.shape
    op = lm.transpose(0, 2, 1, 3).reshape(k, c, 4 * o)
    return np.concatenate([op, np.zeros((k, -c % 8, 4 * o), np.int8)], axis=1)


def test_tables_match_jax(engines):
    """The same primes, corrections, twiddles and matrix digits, and the
    slices of both (a level's first k primes, the Bsk base's last k)."""
    _, ps, jt, mt, _ = engines
    assert (mt.n1, mt.n2) == (jt.n1, jt.n2)
    np.testing.assert_array_equal(mt.p.numpy(), np.asarray(jt.p))
    np.testing.assert_array_equal(mt.horner_corr.numpy(), np.asarray(jt.horner_corr))
    np.testing.assert_array_equal(mt.t_mid.numpy().view(np.uint32), np.asarray(jt.t_mid))
    np.testing.assert_array_equal(mt.ti_mid.numpy().view(np.uint32), np.asarray(jt.ti_mid))
    for field, side in (("v", "right"), ("w", "left"), ("vi", "right"), ("wi", "left")):
        np.testing.assert_array_equal(getattr(mt, f"{field}_gemm").numpy(),
                                      _gemm_of(np.asarray(getattr(jt, f"{field}_limbs")), side))
    for tslice, jslice in ((tmxu.slice_tables, jmxu.slice_tables),
                           (tmxu.slice_tables_last, jmxu.slice_tables_last)):
        ts, js = tslice(mt, 1), jslice(jt, 1)
        np.testing.assert_array_equal(ts.p.numpy(), np.asarray(js.p))
        np.testing.assert_array_equal(ts.v_gemm.numpy(), _gemm_of(np.asarray(js.v_limbs), "right"))
        assert ts.primes == tuple(int(p) for p in np.asarray(js.p))


def test_digits_and_horner_match_jax(engines):
    n, ps, jt, mt, _ = engines
    rng = np.random.default_rng(4)
    x = _rand(rng, ps, n, 2)
    x[0, 0, :3] = [0, ps[0] - 1, (1 << 30) - 1]
    np.testing.assert_array_equal(tmxu._data_limbs(_t(x)).numpy(),
                                  np.asarray(jmxu._data_limbs(jnp.asarray(x))))
    lmax = max(mt.n1, mt.n2)
    bound = 49152 * lmax
    qs = rng.integers(-bound, bound + 1, size=(7, len(ps), 5, 8)).astype(np.int32)
    col = lambda v: v[:, None, None]
    want = jmxu._horner_mod([jnp.asarray(q) for q in qs], col(jt.p), col(jt.mu),
                            col(jt.horner_corr), lmax)
    got = tmxu._horner_mod(list(torch.from_numpy(qs)), col(mt.p), col(mt.horner_corr), lmax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_forward_inverse_match_jax(engines):
    n, ps, jt, mt, _ = engines
    x = _rand(np.random.default_rng(5), ps, n, 3)
    x[:, 0, :2] = 0
    for jfn, tfn in ((jmxu.ntt_forward, tmxu.ntt_forward), (jmxu.ntt_inverse, tmxu.ntt_inverse)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jt))
        np.testing.assert_array_equal(tfn(_t(x), mt).numpy().view(np.uint32), want)


def _both(scheme, n, log_q):
    """The port's default and use_mxu contexts, relinearization keys and two
    encryptions from one port facade on the CPU, and the JAX context of the
    same parameters with its engine on, with the two ciphertexts carried
    into JAX (the same inputs to both packages)."""
    kw = dict(poly_degree=n, log_q=log_q, lambda_=0, hamming_weight=8)
    fhe = FHE(make_scheme_params(SecurityParams(**kw)), seed=9, scheme=scheme, device="cpu")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in ([5, 10, 15, 20], [3, 6, 9, 12])]
    jctx = jcontext.make_context(jmake_params(JSecurity(**kw)), use_pallas=False, use_mxu=True)
    jcts = [jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(c)), level=c.level,
                              is_ntt_form=c.is_ntt_form, noise_budget=c.noise_budget,
                              scale_t=c.scale_t) for c in cts]
    port = {"mxu": make_context(fhe.params, device="cpu", use_mxu=True),
            "default": fhe.ctx}
    return jctx, jcts, port, cts, rlk, sk, fhe


@pytest.mark.parametrize("scheme,n", [("bfv", 256), ("bfv", 1024), ("bgv", 256)])
def test_mxu_multiply_matches_jax(scheme, n):
    """multiply_no_relin with the engine equals JAX's use_mxu=True one and
    the port's default; multiply and multiply_batch (one multiply per pair
    under use_mxu) equal the default multiply and decode."""
    jctx, jcts, port, cts, rlk, sk, fhe = _both(scheme, n, 90)
    jmod, tmod = (jbfv, tbfv) if scheme == "bfv" else (jbgv, tbgv)
    want = jax.jit(jmod.multiply_no_relin)(jctx, *jcts)
    got = tmod.multiply_no_relin(port["mxu"], *cts)
    np.testing.assert_array_equal(got.data.numpy().view(np.uint32), np.asarray(want.data))
    assert torch.equal(got.data, tmod.multiply_no_relin(port["default"], *cts).data)
    full = tmod.multiply(port["mxu"], *cts, rlk)
    assert torch.equal(full.data, tmod.multiply(port["default"], *cts, rlk).data)
    assert [int(v) for v in fhe.decode(fhe.decrypt(full, sk))[:4]] == [15, 60, 135, 240]
    batch = tmod.multiply_batch(port["mxu"], cts, cts[::-1], rlk)
    assert torch.equal(batch[0].data, full.data)
