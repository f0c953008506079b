"""The bootstrapping pipeline of fhe_tpu_torch (scheme/bootstrap.py) held bit
for bit against fhe_tpu.scheme.bootstrap on a use_pallas=False context, at
tests/test_bootstrap.py's configuration: n = 256, log_q = 120 (k = 4),
h = 16, lambda_ = 0.

Keys and ciphertexts cross through convert.py; the bootstrap keys and the
final key-switching keys are made by the port's *_from_noise functions from
the JAX package's own draws (re-derived with the same key splits).  The
residues of every step are compared with tolerance 0.  Noise budgets: the
port's equals the JAX package's formula evaluated in host floats to 1e-9,
and the budget the JAX package returns (float32) to 1e-4.  The level-1
pipeline and the facade are in test_torch_bootstrap_level.py."""

import dataclasses
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import bootstrap as jbs
from fhe_tpu.scheme import noise as jnoise
from fhe_tpu.scheme.context import make_context as jmake_context
from fhe_tpu.scheme.types import Plaintext as JPlaintext

from fhe_tpu_torch import convert
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bootstrap as tbs
from fhe_tpu_torch.scheme.context import make_context

KW = dict(poly_degree=256, log_q=120, lambda_=0, hamming_weight=16)
N = 256

_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))
_encrypt = jax.jit(jbfv.encrypt)
_mod_switch = jax.jit(jbfv.mod_switch_to_next)
_extract = jax.jit(jbs.extract_payload, static_argnums=(2, 3))
_ext_prod = jax.jit(jbs._external_product, static_argnums=(3,))
_ext_prod_batch = jax.jit(jbs._external_product_batch, static_argnums=(3,))
_rotate = jax.jit(lambda ctx, lwe, bsk: jbs.blind_rotate(ctx, lwe, bsk, level=bsk.level))
_rotate_tv = jax.jit(lambda ctx, lwe, bsk, tv: jbs.blind_rotate(ctx, lwe, bsk, test_poly=tv,
                                                                level=bsk.level))
_boot = jax.jit(jbs.bootstrap_binary)
_boot_lut = jax.jit(jbs.bootstrap_lut, static_argnums=(3,))
_boot_batch = jax.jit(jbs.bootstrap_binary_batch)


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(x):
    a = np.asarray(x)
    return convert._tensor(a, a.ndim, "cpu")


def bsk_draws(jctx, key, level):
    """make_bootstrap_key's draws: split(key) -> uniform a, Gaussian e, each
    [kl, n*2*2kl, n] over the level's primes."""
    tb = jbfv._tb(jctx, level)
    total = jctx.params.n * 2 * 2 * (jctx.k - level)
    k_a, k_e = jrandom.split(key)
    return (_uniform(k_a, tb.p, tb.mu, total, jctx.params.n),
            _gaussian(k_e, tb.p, jctx.params.security.sigma, total, jctx.params.n))


def ks_draws(jctx, key):
    """bfv._keyswitch_keygen's draws: split(key, 3) per digit, [kd, k, 1, n]."""
    tb, n, sig = jctx.ntt_q, jctx.params.n, jctx.params.security.sigma
    da, de = [], []
    for _ in range(jctx.k):
        key, k_a, k_e = jrandom.split(key, 3)
        da.append(_uniform(k_a, tb.p, tb.mu, 1, n))
        de.append(_gaussian(k_e, tb.p, sig, 1, n))
    return np.stack(da), np.stack(de)


def encrypt_coeff(s, m, key, level=0):
    """JAX and port ciphertexts of m in the constant coefficient (the port's
    a copy of the JAX one), mod-switched to ``level``."""
    data = np.zeros(N, dtype=np.uint32)
    data[0] = m
    jct = _encrypt(s.jctx, key, s.jpk, JPlaintext(data=jnp.asarray(data)))
    for _ in range(level):
        jct = _mod_switch(s.jctx, jct)
    return jct, convert.ciphertext_from_numpy(
        _np(jct.data), level=jct.level, noise_budget=float(jct.noise_budget), device="cpu")


def want_budget(jp, level, rotation_only=False):
    """The JAX pipeline's budget chain in host floats (fhe_tpu.scheme.noise)."""
    b = max(0.0, jnoise.bfv_budget(jp, level,
                                   math.log2(4 * jp.n) + jnoise.keyswitch_add(jp, level)))
    if rotation_only:
        return b
    if level:
        q_drop = math.prod(jp.q_primes[jp.k - level:])
        b = max(0.0, jnoise.bfv_budget(jp, 0, 2.0 * math.log2(q_drop)
                                       + jnoise.bfv_variance(jp, level, b)))
    return max(0.0, jnoise.bfv_budget(jp, 0, jnoise.add(jnoise.bfv_variance(jp, 0, b),
                                                        jnoise.keyswitch_add(jp, 0))))


def assert_ct_equal(got, want, budget):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - budget) < 1e-9
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def decode0(s, ct):
    return int(tbfv.decrypt(s.tctx, ct, s.tsk).data[0])


def build_state(seed: int, levels: tuple):
    """JAX context, keys, bootstrap keys at ``levels`` (the JAX package's,
    eagerly: its key generation does not trace) and final key-switching
    keys, and the port's made from the same draws."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jmake_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    kg, kb = jrandom.split(jrandom.PRNGKey(seed))
    jpk, jsk = jax.jit(jbfv.keygen)(jctx, kg)
    _, tsk = convert.keys_from_numpy(_np(jpk.data), _np(jsk.data), device="cpu")
    jbsk, tbsk = {}, {}
    for level in levels:
        key = jrandom.fold_in(kb, 50 + level)
        jbsk[level] = jbs.make_bootstrap_key(jctx, key, jsk, level)
        a, e = bsk_draws(jctx, key, level)
        tbsk[level] = tbs.make_bootstrap_key_from_noise(tctx, tsk, _t(a), _t(e), level)
    k_ks = jrandom.fold_in(kb, 60)
    jks = jbs.keyswitch_keygen(jctx, k_ks, jsk, jsk)
    tks = tbs.keyswitch_keygen_from_noise(tctx, tsk, tsk, *(_t(x) for x in ks_draws(jctx, k_ks)))
    return dataclasses.make_dataclass("S", [
        "jp", "jctx", "tctx", "kb", "jpk", "jsk", "tsk", "jbsk", "tbsk", "jks", "tks",
        "memo"])(jp, jctx, tctx, kb, jpk, jsk, tsk, jbsk, tbsk, jks, tks, {})


@pytest.fixture(scope="module")
def s():
    return build_state(3, (0,))


def test_bootstrap_key_matches_jax(s):
    np.testing.assert_array_equal(convert.to_numpy(s.tbsk[0].pos), _np(s.jbsk[0].pos))
    np.testing.assert_array_equal(convert.to_numpy(s.tbsk[0].neg), _np(s.jbsk[0].neg))
    assert s.tbsk[0].level == 0 and s.tbsk[0].pos.shape == (N, 8, 4, 2, N)


def test_keyswitch_keygen_matches_jax(s):
    np.testing.assert_array_equal(convert.to_numpy(s.tks), _np(s.jks))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("w", [1, 3])
def test_extract_payload_matches_jax(s, level, w):
    """extract_lsb (w = 1) and extract_payload (w = 3) of the same
    ciphertext equal the JAX package's LWE sample, at levels 0 and 1."""
    m = 1 if w == 1 else 3
    jct, tct = encrypt_coeff(s, m, jrandom.fold_in(s.kb, 10 + level), level)
    want = _extract(s.jctx, jct, w, 0)
    got = tbs.extract_lsb(s.tctx, tct) if w == 1 else tbs.extract_payload(s.tctx, tct, w)
    np.testing.assert_array_equal(convert.to_numpy(got.a), _np(want.a))
    assert int(got.b) == int(want.b)
    assert got.a.shape == (N,) and got.b.shape == ()
    # the phase sits near m * 2n / 2^w over Z_2n
    s_int = tbfv._inv_q(s.tctx, s.tsk.data)[0, 0].numpy().astype(np.int64)
    s_int = np.where(s_int == 1, 1, np.where(s_int > 1, -1, 0))
    phase = (int(got.b) + int((got.a.numpy().astype(np.int64) * s_int).sum())) % (2 * N)
    target = m * 2 * N >> w
    assert min((phase - target) % (2 * N), (target - phase) % (2 * N)) < N >> w


def _ext_prod_port(s, acc, rows):
    """The port's external product, which the rotation's CMUX gates call,
    on the JAX layout: acc [kl, 2, n] or [kl, B, 2, n] -> the same layout."""
    tb = tbfv._tb(s.tctx, 0)
    x = _t(acc).transpose(0, 1) if acc.ndim == 3 else _t(acc).permute(2, 0, 1, 3)
    p, inv = tbs._cmux_consts(tb, s.tctx.inv_qhat_levels[0], x.dim())
    out = tbs._external_product(x, tbs._keys_t(rows), tb, p, inv)
    return out.transpose(0, 1) if acc.ndim == 3 else out.permute(1, 2, 0, 3)


def test_external_product_matches_jax(s):
    rng = np.random.default_rng(7)
    primes = np.asarray(s.jp.q_primes, dtype=np.uint64)[:, None, None]
    acc = (rng.integers(0, 1 << 32, (4, 2, N), dtype=np.uint64) % primes).astype(np.uint32)
    for j in (0, 77):
        want = _ext_prod(s.jctx, jnp.asarray(acc), s.jbsk[0].pos[j], 0)
        got = _ext_prod_port(s, acc, s.tbsk[0].pos[j])
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want))


def test_external_product_batch_matches_jax(s):
    rng = np.random.default_rng(8)
    primes = np.asarray(s.jp.q_primes, dtype=np.uint64)[:, None, None, None]
    acc = (rng.integers(0, 1 << 32, (4, 3, 2, N), dtype=np.uint64) % primes).astype(np.uint32)
    want = _ext_prod_batch(s.jctx, jnp.asarray(acc), s.jbsk[0].neg[5], 0)
    got = _ext_prod_port(s, acc, s.tbsk[0].neg[5])
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want))
    single = _ext_prod_port(s, acc[:, 1], s.tbsk[0].neg[5])
    assert torch.equal(got[:, 1], single)


def test_monomial_mul_matches_jax():
    """x * X^r for every r in [0, 2n) at n = 32, mod 97: the port's gather
    from the negacyclic extension, and its batched form with a per-sample
    [B, n] index, against the JAX package's _monomial_mul."""
    n, p = 32, 97
    x = np.arange(2 * n, dtype=np.uint32).reshape(1, 2, n) % p
    x[0, 0, 3] = 0
    jp = jnp.asarray(np.array([p], dtype=np.uint32))[:, None, None]
    jmono = jax.jit(jbs._monomial_mul, static_argnums=(2,))
    tp = torch.tensor([p], dtype=torch.int32).view(1, 1, 1)
    rs = list(range(2 * n))
    got_b = tbs._monomial_mul_batch(_t(x)[:, None].expand(1, 2 * n, 2, n).contiguous(),
                                    torch.tensor(rs), n, tp[..., None])
    for r in rs:
        want = _np(jmono(jnp.asarray(x), jnp.uint32(r), n, jp))
        np.testing.assert_array_equal(convert.to_numpy(tbs._monomial_mul(_t(x), r, n, tp)),
                                      want, err_msg=f"r={r}")
        np.testing.assert_array_equal(convert.to_numpy(got_b[:, r]), want, err_msg=f"r={r}")


def _lwe(s, bit, key_idx):
    jct, tct = encrypt_coeff(s, bit, jrandom.fold_in(s.kb, key_idx))
    return _extract(s.jctx, jct, 1, 0), tbs.extract_lsb(s.tctx, tct)


def rotation(s, bit):
    """(JAX, port) blind_rotate of a fresh bit's LWE sample, made once."""
    if ("rotate", bit) not in s.memo:
        jl, tl = _lwe(s, bit, 40 + bit)
        s.memo["rotate", bit] = (jl, tl, _rotate(s.jctx, jl, s.jbsk[0]),
                                 tbs.blind_rotate(s.tctx, tl, s.tbsk[0]))
    return s.memo["rotate", bit]


def test_blind_rotate_matches_jax(s):
    _, _, want, got = rotation(s, 1)
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == 0 and not got.is_ntt_form
    assert abs(got.noise_budget - want_budget(s.jp, 0, rotation_only=True)) < 1e-9
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def test_blind_rotate_custom_test_poly_matches_jax(s):
    """A constant test polynomial (a lookup table): the rotated constant
    coefficient reads +marker for bit 1, as in tests/test_bootstrap.py."""
    jl, tl, _, _ = rotation(s, 1)
    marker = 12345
    tv = np.stack([np.full(N, marker % int(p), dtype=np.uint32) for p in s.jp.q_primes])
    want = _rotate_tv(s.jctx, jl, s.jbsk[0], jnp.asarray(tv)[:, None, :])
    got = tbs.blind_rotate(s.tctx, tl, s.tbsk[0], test_poly=_t(tv[:, None, :]))
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    phase = tbfv._phase(s.tctx, got, s.tsk)
    coeff0 = tbfv._rns.from_rns_host(phase[:, :1], s.jp.q_primes)[0]
    q = math.prod(s.jp.q_primes)
    assert abs((coeff0 if coeff0 <= q // 2 else coeff0 - q) - marker) < (1 << 46)


def test_blind_rotate_batch_matches_single(s):
    """Element i of blind_rotate_batch equals blind_rotate of sample i."""
    (_, tl1, _, got1), (_, tl0, want0, _) = rotation(s, 1), rotation(s, 0)
    acc = tbs.blind_rotate_batch(s.tctx, torch.stack([tl1.a, tl0.a]),
                                 torch.stack([tl1.b, tl0.b]), s.tbsk[0])
    assert acc.shape == (4, 2, 2, N)
    assert torch.equal(acc[:, 0], got1.data)
    np.testing.assert_array_equal(convert.to_numpy(acc[:, 1]), _np(want0.data))


@pytest.mark.parametrize("bit", [0, 1])
def test_bootstrap_binary_matches_jax(s, bit):
    jct, tct = encrypt_coeff(s, bit, jrandom.fold_in(s.kb, 20 + bit))
    want = _boot(s.jctx, jrandom.fold_in(s.kb, 30), jct, s.jsk, s.jbsk[0], s.jks)
    got = tbs.bootstrap_binary(s.tctx, None, tct, s.tsk, s.tbsk[0], s.tks)
    assert_ct_equal(got, want, want_budget(s.jp, 0))
    assert decode0(s, got) == bit


@pytest.mark.parametrize("lut,m", [((1, 0), 0), ((1, 0), 1), ((0, 1, 4, 4), 0),
                                   ((0, 1, 4, 4), 1), ((0, 1, 4, 4), 2), ((0, 1, 4, 4), 3)])
def test_bootstrap_lut_matches_jax(s, lut, m):
    """Encrypted NOT ([1, 0]) and m -> m^2 mod 5 ([0, 1, 4, 4], payload 3 bits)."""
    jct, tct = encrypt_coeff(s, m, jrandom.fold_in(s.kb, 90 + m))
    want = _boot_lut(s.jctx, jrandom.fold_in(s.kb, 31), jct, lut, s.jsk, None,
                     s.jbsk[0], s.jks)
    got = tbs.bootstrap_lut(s.tctx, None, tct, list(lut), s.tsk, bsk=s.tbsk[0],
                            ks_keys=s.tks)
    assert_ct_equal(got, want, want_budget(s.jp, 0))
    assert decode0(s, got) == lut[m]


def test_bootstrap_binary_batch_matches_jax(s):
    """B = 4 bootstraps through one batched rotation: equal to the JAX
    package's, and element i equal to bootstrap_binary(cts[i])."""
    pairs = [encrypt_coeff(s, i % 2, jrandom.fold_in(s.kb, 100 + i)) for i in range(4)]
    want = _boot_batch(s.jctx, [j for j, _ in pairs], s.jbsk[0], s.jks)
    got = tbs.bootstrap_binary_batch(s.tctx, [t for _, t in pairs], s.tbsk[0], s.tks)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_ct_equal(g, w, want_budget(s.jp, 0))
        assert decode0(s, g) == i % 2
    single = tbs.bootstrap_binary(s.tctx, None, pairs[1][1], s.tsk, s.tbsk[0], s.tks)
    assert torch.equal(single.data, got[1].data)
    assert single.noise_budget == got[1].noise_budget


def test_bootstrap_argument_checks(s):
    _, tct = encrypt_coeff(s, 1, jrandom.fold_in(s.kb, 21), level=1)
    with pytest.raises(ValueError, match="bootstrap key level 0 != ciphertext level 1"):
        tbs.bootstrap_binary(s.tctx, None, tct, s.tsk, s.tbsk[0], s.tks)
    with pytest.raises(ValueError, match="requested at level 1"):
        tbs.blind_rotate(s.tctx, tbs.extract_lsb(s.tctx, tct), s.tbsk[0], level=1)
    with pytest.raises(ValueError, match="needs bsk"):
        tbs.blind_rotate(s.tctx, tbs.extract_lsb(s.tctx, tct))
    draws = torch.zeros((4, 10, N), dtype=torch.int32)
    with pytest.raises(ValueError, match="bootstrap key draws"):
        tbs.make_bootstrap_key_from_noise(s.tctx, s.tsk, draws, draws)
    with pytest.raises(ValueError, match="payload wider"):
        tbs.extract_payload(s.tctx, tct, 20)
