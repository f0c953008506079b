"""The port's fused decryption (ops/decrypt_cuda.py) equals the JAX package's
Pallas kernel fhe_tpu.ops.decrypt_pallas.decrypt_fused in interpreter mode,
for t = 65537 (against both its Fermat and its generic t lane) and the
non-Fermat t = 786433.  Integers, tolerance 0."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fhe_tpu import params as jparams
from fhe_tpu.ops import decrypt_pallas as dpal
from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import rns as jrns

from fhe_tpu_torch.ops import decrypt_cuda
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns

RNG = np.random.default_rng(77)


def _setup(n, t, batch, device="cpu"):
    prm = jparams.make_scheme_params(jparams.SecurityParams(
        poly_degree=n, log_q=90, plain_modulus=t, lambda_=0))
    qs = prm.q_primes

    def res(rows):
        return np.stack([RNG.integers(0, p, (rows, n), dtype=np.uint32)
                         for p in qs])

    c0, c1, s = res(batch), res(batch), res(1)
    return prm, c0, c1, s


def _t(a, device="cpu"):
    return torch.from_numpy(a.astype(np.int32)).to(device)


CASES = [(n, b, t, t == 65537) for n in (256, 1024) for b in (1, 3)
         for t in (65537, 786433)] + [(256, 3, 65537, False),
                                      (1024, 1, 65537, False)]


@pytest.mark.parametrize("n,batch,t,fermat", CASES)
def test_decrypt_fused_matches_pallas(n, batch, t, fermat):
    prm, c0, c1, s = _setup(n, t, batch)
    want = np.asarray(dpal.decrypt_fused(
        jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(s),
        npal.build_pallas_tables(n, prm.q_primes),
        jrns.make_decrypt(prm.q_primes, t, prm.gamma),
        fermat=fermat, interpret=True))
    tb = tntt.build_tables(n, prm.q_primes, "cpu")
    dc = trns.make_decrypt(prm.q_primes, t, prm.gamma, "cpu")
    before = decrypt_cuda.decrypt_fused.launches
    got = decrypt_cuda.decrypt_fused(_t(c0), _t(c1), _t(s), tb, dc)
    assert got.shape == (batch, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert decrypt_cuda.decrypt_fused.launches == before


@pytest.mark.parametrize("t", [65537, 786433])
def test_decrypt_fused_reads_component_views(t):
    """bfv.decrypt passes c0 and c1 as views of one [k, 2, n] ciphertext; the
    result equals the Pallas kernel's on the same components."""
    n = 256
    prm, c0, c1, s = _setup(n, t, 1)
    want = np.asarray(dpal.decrypt_fused(
        jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(s),
        npal.build_pallas_tables(n, prm.q_primes),
        jrns.make_decrypt(prm.q_primes, t, prm.gamma), interpret=True))
    ct = _t(np.concatenate([c0, c1], axis=1))
    tb = tntt.build_tables(n, prm.q_primes, "cpu")
    dc = trns.make_decrypt(prm.q_primes, t, prm.gamma, "cpu")
    got = decrypt_cuda.decrypt_fused(ct[:, 0:1], ct[:, 1:2], _t(s), tb, dc)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    with pytest.raises(ValueError, match="contiguous"):
        decrypt_cuda.decrypt_fused(
            ct[:, 0:1], _t(np.repeat(c1, 2, axis=2))[:, :, ::2], _t(s), tb, dc)
    with pytest.raises(ValueError, match="strides"):
        decrypt_cuda.decrypt_fused(_t(c0), ct[:, 1:2], _t(s), tb, dc)


def test_decrypt_scale_matches_jax():
    """The plain gamma-trick scaling alone equals rns.decrypt_scale."""
    prm, c0, _, _ = _setup(256, 786433, 2)
    want = np.asarray(jrns.decrypt_scale(
        jnp.asarray(c0), jrns.make_decrypt(prm.q_primes, 786433, prm.gamma)))
    got = trns.decrypt_scale(
        _t(c0), trns.make_decrypt(prm.q_primes, 786433, prm.gamma, "cpu"))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

