"""CUDA kernels of fhe_tpu_torch against their plain PyTorch versions, on the
card, at the slice's width (n = 8192, k = 3).  Integers, tolerance 0.

Every test here is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor fhe_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fhe_tpu_torch import FHE
from fhe_tpu_torch.ops import decrypt_cuda, ntt_cuda
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params

pytestmark = pytest.mark.cuda

N = 8192
RNG = np.random.default_rng(8192)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(t=65537):
    return make_scheme_params(SecurityParams(
        poly_degree=N, log_q=90, hamming_weight=64, plain_modulus=t))


def _residues(moduli, rows, dev):
    a = np.stack([RNG.integers(0, p, (rows, N), dtype=np.uint32)
                  for p in moduli])
    return torch.from_numpy(a.astype(np.int32)).to(dev)


@pytest.mark.parametrize("batch", [1, 16])
def test_ntt_kernels_match_plain(dev, batch):
    qs = _params().q_primes
    tb = tntt.build_tables(N, qs, dev)
    a = _residues(qs, batch, dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tb), tntt.ntt_forward(a, tb))
    assert torch.equal(ntt_cuda.ntt_inverse(a, tb), tntt.ntt_inverse(a, tb))


def test_ntt_kernels_mod_t_match_plain(dev):
    tt = tntt.build_tables(N, (65537,), dev)
    a = _residues((65537,), 1, dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tt), tntt.ntt_forward(a, tt))
    assert torch.equal(ntt_cuda.ntt_inverse(a, tt), tntt.ntt_inverse(a, tt))


def test_mul_by_ntt_operand_kernel_matches_plain(dev):
    qs = _params().q_primes
    tb = tntt.build_tables(N, qs, dev)
    u, w = _residues(qs, 1, dev), _residues(qs, 2, dev)
    assert torch.equal(ntt_cuda.mul_by_ntt_operand(u, w, tb),
                       tntt.mul_by_ntt_operand(u, w, tb))


@pytest.mark.parametrize("t", [65537, 786433])
@pytest.mark.parametrize("batch", [1, 8])
def test_decrypt_kernel_matches_plain(dev, t, batch):
    prm = _params(t)
    tb = tntt.build_tables(N, prm.q_primes, dev)
    dc = trns.make_decrypt(prm.q_primes, t, prm.gamma, dev)
    args = (_residues(prm.q_primes, batch, dev),
            _residues(prm.q_primes, batch, dev),
            _residues(prm.q_primes, 1, dev), tb, dc)
    assert torch.equal(decrypt_cuda.decrypt_fused(*args),
                       decrypt_cuda.decrypt_fused_plain(*args))


def test_decrypt_kernel_reads_component_views(dev):
    """The main path's decrypt: c0 and c1 as views of one [k, 2, n] tensor."""
    prm = _params()
    tb = tntt.build_tables(N, prm.q_primes, dev)
    dc = trns.make_decrypt(prm.q_primes, prm.t, prm.gamma, dev)
    ct = _residues(prm.q_primes, 2, dev)
    args = (ct[:, 0:1], ct[:, 1:2], _residues(prm.q_primes, 1, dev), tb, dc)
    assert torch.equal(decrypt_cuda.decrypt_fused(*args),
                       decrypt_cuda.decrypt_fused_plain(*args))


def test_slice_on_card(dev):
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=5, device=dev)
    pk, sk = fhe.keygen()
    p1, p2 = fhe.encode([5, 10, 15, 20]), fhe.encode([3, 6, 9, 12])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(p2, pk)
    assert list(fhe.decode(fhe.decrypt(fhe.add(c1, c2), sk))[:4]) == [8, 16, 24, 32]
    ct = fhe.to_ntt(c1)
    acc = None
    for i in range(8):
        term = fhe.multiply_plain(ct, fhe.encode([i + 1, 2 * i + 1, 3, 4]),
                                  cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    assert int(fhe.decode(fhe.decrypt(fhe.to_coeff(acc), sk))[0]) == 180
