"""The port's NTT wrappers (ops/ntt_cuda.py) equal the JAX package's Pallas
kernels, run in interpreter mode: fhe_tpu.ops.ntt_pallas.ntt_forward,
ntt_inverse and mul_by_ntt_operand.  On the CPU the wrappers take the plain
PyTorch versions of ops/ntt.py; tests/test_torch_cuda.py holds the CUDA
kernels against those same plain versions on the card.  At n = 16384 and
32768, the sizes only the card runs otherwise, the plain transforms equal
fhe_tpu.ops.ntt's jnp transforms.  Integers, tolerance 0."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.ops import ntt_pallas as npal

from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_cuda

RNG = np.random.default_rng(2024)


def _residues(moduli, rows, n):
    return np.stack([RNG.integers(0, p, (rows, n), dtype=np.uint32)
                     for p in moduli])


def _t(arr, device="cpu"):
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def _setup(n, moduli):
    return (npal.build_pallas_tables(n, moduli),
            tntt.build_tables(n, moduli, "cpu"))


SHAPES = [(256, 2, 1), (1024, 3, 2)]


@pytest.mark.parametrize("n,k,batch", SHAPES)
def test_ntt_forward_matches_pallas(n, k, batch):
    moduli = jprimes.find_ntt_primes(n, k)
    pt, tb = _setup(n, moduli)
    a = _residues(moduli, batch, n)
    want = np.asarray(npal.ntt_forward(jnp.asarray(a), pt, interpret=True))
    got = ntt_cuda.ntt_forward(_t(a), tb).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k,batch", SHAPES)
def test_ntt_inverse_matches_pallas(n, k, batch):
    moduli = jprimes.find_ntt_primes(n, k)
    pt, tb = _setup(n, moduli)
    a = _residues(moduli, batch, n)
    want = np.asarray(npal.ntt_inverse(jnp.asarray(a), pt, interpret=True))
    got = ntt_cuda.ntt_inverse(_t(a), tb).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16384, 32768])
def test_plain_ntt_matches_jax_at_large_n(n):
    """The multiply's n = 16384 and the JAX bench's g_n32768 input (one
    prime row, numpy seed 5, bench.py:932-945): the plain forward and
    inverse transforms, which the card's B1 and B2 equal there, against
    fhe_tpu.ops.ntt.ntt_forward / ntt_inverse."""
    p = jprimes.find_ntt_primes(n, 3)[0]
    x = np.random.default_rng(5).integers(0, p, (1, 1, n), dtype=np.uint32)
    jtb, tb = jntt.build_tables(n, (p,)), tntt.build_tables(n, (p,), "cpu")
    fwd = np.asarray(jax.jit(jntt.ntt_forward)(jnp.asarray(x), jtb))
    np.testing.assert_array_equal(tntt.ntt_forward(_t(x), tb).numpy().astype(np.uint32), fwd)
    inv = np.asarray(jax.jit(jntt.ntt_inverse)(jnp.asarray(x), jtb))
    np.testing.assert_array_equal(tntt.ntt_inverse(_t(x), tb).numpy().astype(np.uint32), inv)
    np.testing.assert_array_equal(tntt.ntt_inverse(_t(fwd), tb).numpy().astype(np.uint32), x)


@pytest.mark.parametrize("n,t", [(256, 65537), (1024, 786433)])
def test_mod_t_tables_match_pallas(n, t):
    """The encoder's transforms: one small modulus t through the same
    wrappers (t = 65537 and a non-Fermat t)."""
    pt, tb = _setup(n, (t,))
    a = _residues((t,), 1, n)
    fwd = np.asarray(npal.ntt_forward(jnp.asarray(a), pt, interpret=True))
    np.testing.assert_array_equal(
        ntt_cuda.ntt_forward(_t(a), tb).numpy().astype(np.uint32), fwd)
    inv = np.asarray(npal.ntt_inverse(jnp.asarray(a), pt, interpret=True))
    np.testing.assert_array_equal(
        ntt_cuda.ntt_inverse(_t(a), tb).numpy().astype(np.uint32), inv)


@pytest.mark.parametrize("n,k", [(256, 2), (1024, 3)])
@pytest.mark.parametrize("c", [1, 2])
def test_mul_by_ntt_operand_matches_pallas(n, k, c):
    moduli = jprimes.find_ntt_primes(n, k)
    pt, tb = _setup(n, moduli)
    u = _residues(moduli, 1, n)
    w = _residues(moduli, c, n)
    want = np.asarray(npal.mul_by_ntt_operand(jnp.asarray(u), jnp.asarray(w),
                                              pt, interpret=True))
    got = ntt_cuda.mul_by_ntt_operand(_t(u), _t(w), tb)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_cpu_route_launches_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch; forward then inverse is the identity."""
    n, moduli = 512, jprimes.find_ntt_primes(512, 2)
    tb = tntt.build_tables(n, moduli, "cpu")
    a = _t(_residues(moduli, 3, n))
    before = (ntt_cuda.ntt_forward.launches, ntt_cuda.ntt_inverse.launches,
              ntt_cuda.mul_by_ntt_operand.launches)
    back = ntt_cuda.ntt_inverse(ntt_cuda.ntt_forward(a, tb), tb)
    ntt_cuda.mul_by_ntt_operand(a[:, :1].contiguous(), a, tb)
    assert torch.equal(back, a)
    assert (ntt_cuda.ntt_forward.launches, ntt_cuda.ntt_inverse.launches,
            ntt_cuda.mul_by_ntt_operand.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_wrappers_reject_bad_input(bad):
    n, moduli = 256, jprimes.find_ntt_primes(256, 2)
    tb = tntt.build_tables(n, moduli, "cpu")
    a = _t(_residues(moduli, 2, n))
    x = {"dtype": a.to(torch.int64), "shape": a[:1].contiguous(),
         "strides": a.transpose(0, 1)}[bad]
    with pytest.raises((TypeError, ValueError)):
        ntt_cuda.ntt_forward(x, tb)

