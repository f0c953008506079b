"""The base-conversion kernel's lanes and the multiply that uses them, held
bit for bit against the JAX package.

Kernel modules (the port's wrappers on CPU tensors, which run their plain
twins): fast_bconv_sk_fused with the digits lane against
rns_pallas.fast_bconv_sk_fused in interpreter mode followed by the JAX
relinearization digit multiply (modmath.mul_mod_shoup with the context's
inv_qhat_levels, as fhe_tpu.scheme.bfv._keyswitch_delta forms it), and
fast_floor_fused with the SK lane (and digits) against
rns_pallas.fast_floor_fused then rns_pallas.fast_bconv_sk_fused, at the
leveled configuration (n = 256, log_q = 150, k = 5) at levels 0, 1 and 2.
A Python model of the kernel's thread-to-word mapping (ops/rns_cuda.py's
conv_geometry and conv_vec, csrc/rns.cu base_conv_kernel) covers every
output word exactly once.  tests/test_torch_cuda.py holds the kernel's
lanes against the same plain twins on the card.

The scheme: the port's multiply against fhe_tpu.scheme.bfv.multiply,
jitted, on a use_pallas=False context (pinned equal to the Pallas path by
tests/test_pallas.py), at n = 1024 (ks_omega 1 and 2), at n = 256,
levels 0 to 2, and at the headline n = 8192, log_q = 90 (k = 3), on keys
and ciphertexts made by the port's *_from_noise
entry points from numpy draws and carried to JAX as arrays; and the port's
multiply equal to relinearize(multiply_no_relin) bit for bit.

Residues are compared with tolerance 0; the noise budget, which the JAX
package carries in float32, to 1e-4 bits."""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu.ops import modmath as jmm
from fhe_tpu.ops import rns_pallas as rpal
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import rns_cuda
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.types import Ciphertext

RNG = np.random.default_rng(20261017)
SMALL = dict(poly_degree=256, log_q=150, hamming_weight=32)             # k = 5
WIDE = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)    # k = 3
HEADLINE = dict(poly_degree=8192, log_q=90, hamming_weight=64)           # k = 3, kb = 5
PRODUCT = [15, 60, 135, 240]

_jmultiply = jax.jit(jbfv.multiply)


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def _small(moduli, shape, bound=6):
    """Residues of integers in [-bound, bound]: a stand-in for the error draws."""
    x = RNG.integers(-bound, bound + 1, shape)
    return np.stack([x % p for p in moduli]).astype(np.uint32)


def _ternary(moduli, n, h):
    s = np.zeros(n, dtype=np.int64)
    s[RNG.choice(n, h, replace=False)] = RNG.choice([-1, 1], h)
    return np.stack([(s % p)[None] for p in moduli]).astype(np.uint32)


def _jct(ct: Ciphertext):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             is_ntt_form=ct.is_ntt_form, noise_budget=ct.noise_budget)


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


@functools.lru_cache(maxsize=None)
def _state(kw_items: tuple):
    """The port's facade and the JAX context of one configuration, keys from
    numpy draws (the port's) carried to JAX, and two fresh ciphertexts of
    [5, 10, 15, 20] and [3, 6, 9, 12]."""
    kw = dict(kw_items)
    jctx = jcontext.make_context(jmake_params(JSecurity(**kw)), use_pallas=False,
                                 use_mxu=False)
    fhe = FHE(device="cpu", seed=0, **kw)
    tctx, qs, n = fhe.ctx, fhe.params.q_primes, fhe.params.n
    kd = -(-fhe.params.k // fhe.params.security.ks_omega)
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, n, kw["hamming_weight"])),
                                    _t(_residues(qs, (1, n))), _t(_small(qs, (1, n))))
    rlk = tbfv.relinkey_gen_from_noise(
        tctx, sk, _t(_residues(qs, (kd, 1, n)).transpose(1, 0, 2, 3)),
        _t(_small(qs, (kd, 1, n)).transpose(1, 0, 2, 3)))
    cts = [tbfv.encrypt_from_noise(tctx, pk, fhe.encode(v),
                                   _t(_ternary(qs, n, kw["hamming_weight"])),
                                   _t(_small(qs, (1, n))), _t(_small(qs, (1, n))))
           for v in ([5, 10, 15, 20], [3, 6, 9, 12])]
    jrlk = jtypes.RelinKeys(data=jnp.asarray(convert.to_numpy(rlk)))
    return dataclasses.make_dataclass("S", ["jctx", "fhe", "sk", "rlk", "jrlk", "cts"])(
        jctx, fhe, sk, rlk, jrlk, cts)


def _digit_consts(tctx, level):
    return tctx.inv_qhat_levels[level], tctx.inv_qhat_shoup_levels[level]


def _jax_digits(jctx, out, level, primes):
    """The JAX relinearization digits of the c2 rows of out [k, 3B, n]."""
    k, rows, n = out.shape
    c2 = out.reshape(k, 3, rows // 3, n)[:, 2]
    inv, inv_sh = jctx.inv_qhat_levels[level]
    p = jnp.asarray(np.array(primes, dtype=np.uint32))
    return np.asarray(jmm.mul_mod_shoup(c2, inv[:, None, None], inv_sh[:, None, None],
                                        p[:, None, None]))


# ---------------------------------------------------------------------------
# the thread-to-word mapping of base_conv_kernel
# ---------------------------------------------------------------------------


def _model_hits(lane: str, count: int, rows_out: int, k: int, digits: bool):
    """How often the kernel, launched as conv_geometry says, stores each word
    of out [rows_out, count] and of the digits [k, count / 3]: thread t of
    block b owns words e .. e + V - 1 of every row, e = (b * threads + t) * V,
    if e < count; it stores out[r * count + e + v] for every output row r and,
    from word dstart = 2 count / 3 on, dig[j * count / 3 + e - dstart + v]."""
    geo = rns_cuda.conv_geometry(count, lane)
    v, threads, blocks = geo["per_thread"], geo["threads"], geo["blocks"]
    assert count % v == 0 and blocks * threads * v >= count > (blocks - 1) * threads * v
    e = np.arange(blocks * threads, dtype=np.int64) * v
    e = e[e < count]
    assert (e % v == 0).all()          # whole 8-byte accesses of every row
    out = np.zeros(rows_out * count, dtype=np.int64)
    dstart, dcount = 2 * count // 3, count // 3
    dig = np.zeros(k * dcount, dtype=np.int64)
    assert dstart % v == 0            # a thread's words are all c2 or none
    for r in range(rows_out):
        for w in range(v):
            np.add.at(out, r * count + e + w, 1)
    if digits:
        de = e[e >= dstart] - dstart
        for j in range(k):
            for w in range(v):
                np.add.at(dig, j * dcount + de + w, 1)
    return out, dig


@pytest.mark.parametrize("lane", ["sk", "floor", "floor_sk"])
@pytest.mark.parametrize("batch,n", [(1, 32), (3, 256), (1, 8192), (5, 8192), (8, 8192),
                                     (9, 8192), (24, 8192), (3, 16384)])
def test_conv_mapping_covers_every_word_once(lane, batch, n):
    """B = 1, 8 and 24 (the multiply and its batches), odd B, n = 32 to
    16384: every output word and every digit word is stored exactly once."""
    count = 3 * batch * n
    for k, kb in ((3, 5), (8, 10)):
        rows_out = kb if lane == "floor" else k
        out, dig = _model_hits(lane, count, rows_out, k, lane != "floor")
        assert (out == 1).all()
        if lane != "floor":
            assert (dig == 1).all()


def test_conv_vec_reads_unaligned_views_a_word_at_a_time():
    """A row view that starts off an 8-byte boundary takes the word
    loads; the mapping (above) does not depend on it."""
    buf = torch.zeros(3 * 5 * 1024 + 1, dtype=torch.int32)
    aligned = buf[:-1].view(5, 3, 1024)
    odd = buf[1:].view(5, 3, 1024)
    assert aligned.data_ptr() % 8 == 0 and odd.data_ptr() % 8 == 4
    assert rns_cuda.conv_vec(2, aligned) and not rns_cuda.conv_vec(2, odd)
    assert not rns_cuda.conv_vec(2, aligned, odd)
    assert rns_cuda.conv_vec(1, odd)


# ---------------------------------------------------------------------------
# the lanes against the Pallas kernels in interpreter mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,level,batch", [(WIDE, 0, 1), (WIDE, 0, 3), (WIDE, 1, 1),
                                            (SMALL, 2, 3)])
def test_sk_lane_with_digits_matches_pallas(kw, level, batch):
    s = _state(tuple(kw.items()))
    tctx, jctx = s.fhe.ctx, s.jctx
    n, qs = tctx.n, tctx.params.q_primes[:tctx.k - level]
    xb = _residues(tctx.mul_levels[level][1].primes, (3 * batch, n))
    want = np.asarray(rpal.fast_bconv_sk_fused(jnp.asarray(xb), jctx.sk_levels[level],
                                               interpret=True))
    got, d = rns_cuda.fast_bconv_sk_fused(_t(xb), tctx.sk_levels[level],
                                          _digit_consts(tctx, level))
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    np.testing.assert_array_equal(convert.to_numpy(d),
                                  _jax_digits(jctx, jnp.asarray(want), level, qs))
    assert d.shape == (len(qs), batch, n)
    # without the digits lane: the conversion alone, the same rows
    np.testing.assert_array_equal(
        convert.to_numpy(rns_cuda.fast_bconv_sk_fused(_t(xb), tctx.sk_levels[level])), want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_floor_sk_lane_matches_pallas(level):
    """fast_floor_fused with sk (and the digits) equals the JAX n < 1024
    path's fast_floor_fused then fast_bconv_sk_fused, and the digit
    multiply, with the level's constants."""
    s = _state(tuple(SMALL.items()))
    tctx, jctx = s.fhe.ctx, s.jctx
    n, qs = tctx.n, tctx.params.q_primes[:tctx.k - level]
    bsk = tctx.mul_levels[level][1].primes
    assert len(bsk) == jctx.bsk_counts[level]
    tx_q, tx_bsk = _residues(qs, (3, n)), _residues(bsk, (3, n))
    floored = rpal.fast_floor_fused(jnp.asarray(tx_q), jnp.asarray(tx_bsk),
                                    jctx.floor_levels[level], interpret=True)
    want = np.asarray(rpal.fast_bconv_sk_fused(floored, jctx.sk_levels[level],
                                               interpret=True))
    args = (_t(tx_q), _t(tx_bsk), tctx.floor_levels[level], tctx.sk_levels[level])
    got, d = rns_cuda.fast_floor_fused(*args, _digit_consts(tctx, level))
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    np.testing.assert_array_equal(convert.to_numpy(d),
                                  _jax_digits(jctx, jnp.asarray(want), level, qs))
    np.testing.assert_array_equal(convert.to_numpy(rns_cuda.fast_floor_fused(*args)), want)
    # the floor lane alone is still B10
    np.testing.assert_array_equal(
        convert.to_numpy(rns_cuda.fast_floor_fused(*args[:3])), np.asarray(floored))


def test_lanes_reject_mismatched_constants():
    s = _state(tuple(SMALL.items()))
    tctx = s.fhe.ctx
    n = tctx.n
    qs, bsk = tctx.params.q_primes, tctx.mul_levels[0][1].primes
    tx_q, tx_bsk = _t(_residues(qs, (3, n))), _t(_residues(bsk, (3, n)))
    with pytest.raises(ValueError, match="SK constants"):
        rns_cuda.fast_floor_fused(tx_q, tx_bsk, tctx.floor_levels[0], tctx.sk_levels[1])
    with pytest.raises(ValueError, match="needs sk"):
        rns_cuda.fast_floor_fused(tx_q, tx_bsk, tctx.floor_levels[0], None,
                                  _digit_consts(tctx, 0))
    with pytest.raises(ValueError, match="3 components"):
        rns_cuda.fast_bconv_sk_fused(_t(_residues(bsk, (2, n))), tctx.sk_levels[0],
                                     _digit_consts(tctx, 0))
    with pytest.raises(ValueError, match="digits must be"):
        rns_cuda.fast_bconv_sk_fused(_t(_residues(bsk, (3, n))), tctx.sk_levels[0],
                                     _digit_consts(tctx, 1))


# ---------------------------------------------------------------------------
# the multiply against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,level", [(WIDE, 0), ({**WIDE, "ks_omega": 2}, 0),
                                      (SMALL, 0), (SMALL, 1), (SMALL, 2), (HEADLINE, 0)])
def test_multiply_matches_jax(kw, level):
    """At n = 1024, at n = 256 (levels 0-2) and at the headline shape,
    n = 8192, log_q = 90 (k = 3): the port's plain multiply (the twins of
    B4-B7 on CPU tensors) equals fhe_tpu's."""
    s = _state(tuple(kw.items()))
    tctx = s.fhe.ctx
    a, b = (tbfv.mod_switch_to_level(tctx, c, level) for c in s.cts)
    got = tbfv.multiply(tctx, a, b, s.rlk)
    assert_ct_equal(got, _jmultiply(s.jctx, _jct(a), _jct(b), s.jrlk))
    assert [int(v) for v in s.fhe.decode(tbfv.decrypt(tctx, got, s.sk))[:4]] == PRODUCT


@pytest.mark.parametrize("kw,level", [(WIDE, 0), ({**WIDE, "ks_omega": 2}, 0),
                                      (SMALL, 0), (SMALL, 2)])
def test_multiply_is_relinearize_of_multiply_no_relin(kw, level):
    """The digits the conversion kernel stores beside c2 are relinearize's
    own: multiply(a, b) == relinearize(multiply_no_relin(a, b)), residues
    and noise budget, with keys switched down and keys of the level."""
    s = _state(tuple(kw.items()))
    tctx = s.fhe.ctx
    a, b = (tbfv.mod_switch_to_level(tctx, c, level) for c in s.cts)
    want = tbfv.relinearize(tctx, tbfv.multiply_no_relin(tctx, a, b), s.rlk)
    got = tbfv.multiply(tctx, a, b, s.rlk)
    assert torch.equal(got.data, want.data) and got.noise_budget == want.noise_budget
    keys = tbfv.switch_relin_keys(tctx, s.rlk, level)
    assert torch.equal(tbfv.multiply(tctx, a, b, keys, keys_at_level=True).data, want.data)
