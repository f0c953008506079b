"""The modmul roofline probe (B19), held bit for bit against the JAX package.

fhe_tpu_torch.utils.ubench.modmul_chain on CPU tensors (its plain int64
emulation, ``modmul_chain_plain``) against fhe_tpu.utils.ubench.modmul_chain
with the Pallas kernel in interpreter mode, on the same [8, 256] block of
residues, reps = 16, unroll = 8, for every variant (exact, lazy, barrett,
cheap17, mul17) and ilp 1, 2 and 4.  The constant is a twiddle of a 30-bit
NTT prime, as in the JAX bench's roofline group.  tests/test_torch_cuda.py
holds the CUDA kernel against the same plain version on the card.  uint32
words, tolerance 0."""

import numpy as np
import pytest
import torch

from fhe_tpu.utils import ubench as jubench

from fhe_tpu_torch import convert
from fhe_tpu_torch.ops import modmath as mm
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.utils import ubench

REPS, UNROLL = 16, 8


@pytest.fixture(scope="module")
def chain():
    """(x, w, w_sh, p, mu): an [8, 256] block below p and the bench's
    constant psi_br[0, 1] of the first q prime."""
    ctx = make_context(make_scheme_params(SecurityParams(
        poly_degree=256, log_q=60, hamming_weight=16, lambda_=0)), device="cpu")
    p = ctx.ntt_q.primes[0]
    w = int(ctx.ntt_q.psi_br[0, 1])
    x = np.random.default_rng(20261020).integers(0, p, (8, 256), dtype=np.uint32)
    return x, w, mm.shoup_precompute(w, p), p, mm.barrett_precompute(p)


@pytest.mark.parametrize("ilp", ubench.ILPS)
@pytest.mark.parametrize("variant", ubench.VARIANTS)
def test_modmul_chain_matches_pallas(chain, variant, ilp):
    x, w, w_sh, p, mu = chain
    want = np.asarray(jubench.modmul_chain(
        x, np.uint32(w), np.uint32(w_sh), np.uint32(p), np.uint32(mu), reps=REPS,
        variant=variant, interpret=True, unroll=UNROLL, ilp=ilp))
    got = ubench.modmul_chain(torch.from_numpy(x.astype(np.int32)), w, w_sh, p, mu,
                              REPS, variant, UNROLL, ilp)
    assert got.dtype == torch.int32 and got.shape == (8, 256)
    np.testing.assert_array_equal(convert.to_numpy(got), want)


def test_modmul_chain_checks_arguments(chain):
    x, w, w_sh, p, mu = chain
    xt = torch.from_numpy(x.astype(np.int32))
    assert torch.equal(ubench.modmul_chain(xt, w, w_sh, p, mu, 0), xt)
    with pytest.raises(ValueError, match="multiple"):
        ubench.modmul_chain(xt, w, w_sh, p, mu, 12)
    with pytest.raises(ValueError, match="variant"):
        ubench.modmul_chain(xt, w, w_sh, p, mu, 16, "montgomery")
    with pytest.raises(ValueError, match="variant"):
        ubench.modmul_chain(xt, w, w_sh, p, mu, 16, ilp=3)
    with pytest.raises(ValueError, match="int32"):
        ubench.modmul_chain(xt.to(torch.int64), w, w_sh, p, mu, 16)
