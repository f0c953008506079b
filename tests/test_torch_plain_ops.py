"""The plain twins of the port (A18) against the JAX package, tolerance 0:
the uint32 arithmetic of fhe_tpu.ops.modmath (on tests/test_modmath.py's
primes and vectors and at the edges 0, p - 1, 2^30 - 1 and 2^32 - 1), the
negacyclic products of fhe_tpu.ops.ntt / ntt_pallas (interpret mode), the
rest of fhe_tpu.ops.poly (estimate_noise to 1e-9), sampling's
uniform_mod_t_host (range, shape and dtype: its draws differ by design)
and params.default_params."""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu import params as jparams
from fhe_tpu import primes as jprimes
from fhe_tpu.ops import modmath as jmm
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import poly as jpoly
from fhe_tpu.ops import rns as jrns
from fhe_tpu.ops import sampling as jsampling

from fhe_tpu_torch import params as tparams
from fhe_tpu_torch.ops import modmath as tmm
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_cuda
from fhe_tpu_torch.ops import poly as tpoly
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.ops import sampling as tsampling

PRIMES = jprimes.find_ntt_primes(4096, 4) + [jprimes.find_ntt_primes(8192, 1)[0]]
RNG = np.random.default_rng(321)
T_VAR = 786433          # a small modulus for mul_mod_var / pow_mod_var


def _words(size, bound, edges=()):
    return np.concatenate([RNG.integers(0, bound, size=size, dtype=np.uint64),
                           np.array(edges, dtype=np.uint64)]).astype(np.uint32)


def _jax(fn, *args):
    """A JAX twin's uint32 result (or pair) as int64 numpy arrays."""
    out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    if isinstance(out, tuple):
        return tuple(np.asarray(o).astype(np.int64) for o in out)
    return np.asarray(out).astype(np.int64)


def _port(fn, *args, int32_bits=False):
    """The port twin on int64 tensors (or int32 tensors carrying the bits)."""
    conv = lambda a: torch.from_numpy(a.view(np.int32) if int32_bits else a.astype(np.int64))
    out = fn(*[conv(a) if isinstance(a, np.ndarray) else a for a in args])
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def _cases(p):
    """name -> (JAX function, port function, arguments) at prime p."""
    u32 = 1 << 32
    x = _words(600, u32, [0, 1, p - 1, (1 << 30) - 1, u32 - 1])
    y = _words(600, u32, [u32 - 1, u32 - 1, u32 - 1, u32 - 1, 1])
    a = _words(600, p, [0, 1, p - 1, p - 1, 0])
    b = _words(600, p, [p - 1, p - 1, p - 1, 1, 0])
    w = int(RNG.integers(1, p))
    w_sh = tmm.shoup_precompute(w, p)
    mu = tmm.barrett_precompute(p)
    p_neg_inv = tmm.montgomery_precompute(p)[0]
    av, bv = _words(600, T_VAR, [0, T_VAR - 1]), _words(600, T_VAR, [T_VAR - 1, T_VAR - 1])
    af, bf = _words(600, 65537, [0, 65536]), _words(600, 65537, [65536, 65536])
    var = (T_VAR, (1 << 32) // T_VAR, (1 << 32) % T_VAR,
           tmm.shoup_precompute((1 << 32) % T_VAR, T_VAR))
    U = np.uint32
    return {
        "umul32_wide": (jmm.umul32_wide, tmm.umul32_wide, (x, y)),
        "umul32_hi": (jmm.umul32_hi, tmm.umul32_hi, (x, y)),
        "neg_mod": (jmm.neg_mod, tmm.neg_mod, (a, U(p))),
        "mul_mod_shoup": (jmm.mul_mod_shoup, tmm.mul_mod_shoup, (x, U(w), U(w_sh), U(p))),
        "reduce_mod_shoup": (jmm.reduce_mod_shoup, tmm.reduce_mod_shoup,
                             (x, U(p), U((1 << 32) // p))),
        "mul_mod_shoup_lazy": (jmm.mul_mod_shoup_lazy, tmm.mul_mod_shoup_lazy,
                               (x, U(w), U(w_sh), U(p))),
        "mul_mod_barrett": (jmm.mul_mod_barrett, tmm.mul_mod_barrett, (a, b, U(p), U(mu))),
        "reduce_u64_mod": (jmm.reduce_u64_mod, tmm.reduce_u64_mod,
                           (x, y, U(p), U(mu), U((1 << 32) % p))),
        "barrett_reduce_u32": (jmm.barrett_reduce_u32, tmm.barrett_reduce_u32,
                               (x, U(p), U(mu))),
        "mul_mod_montgomery": (jmm.mul_mod_montgomery, tmm.mul_mod_montgomery,
                               (a, b, U(p), U(p_neg_inv))),
        "mul_mod_var": (jmm.mul_mod_var, tmm.mul_mod_var, (av, bv) + tuple(U(v) for v in var)),
        "reduce_mod_fermat16": (jmm.reduce_mod_fermat16, tmm.reduce_mod_fermat16, (x,)),
        "mul_mod_fermat16": (jmm.mul_mod_fermat16, tmm.mul_mod_fermat16, (af, bf)),
    }


CASE_NAMES = list(_cases(PRIMES[0]))


@pytest.mark.parametrize("p", [PRIMES[0], PRIMES[-1]])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_modmath_twin_matches_jax(name, p):
    jfn, tfn, args = _cases(p)[name]
    want = _jax(jfn, *args)
    _equal(_port(tfn, *args), want)
    _equal(_port(tfn, *args, int32_bits=True), want)


def test_modmath_twins_match_python_ints():
    """tests/test_modmath.py's contracts on Python ints: the wide product,
    Shoup on any x < 2^32, Barrett, Montgomery (a b 2^-32), the u64
    reduction and the Fermat product."""
    for p in PRIMES:
        cases = _cases(p)
        x, y = (v.astype(object) for v in cases["umul32_wide"][2])
        hi, lo = _port(tmm.umul32_wide, *cases["umul32_wide"][2])
        np.testing.assert_array_equal(hi, (x * y) >> 32)
        np.testing.assert_array_equal(lo, (x * y) & 0xFFFFFFFF)
        _, _, (xs, w, _, _) = cases["mul_mod_shoup"]
        got = _port(tmm.mul_mod_shoup, *cases["mul_mod_shoup"][2])
        np.testing.assert_array_equal(got, xs.astype(object) * int(w) % p)
        a, b = (v.astype(object) for v in cases["mul_mod_barrett"][2][:2])
        np.testing.assert_array_equal(_port(tmm.mul_mod_barrett, *cases["mul_mod_barrett"][2]),
                                      a * b % p)
        np.testing.assert_array_equal(
            _port(tmm.mul_mod_montgomery, *cases["mul_mod_montgomery"][2]),
            a * b * pow(1 << 32, -1, p) % p)
        np.testing.assert_array_equal(_port(tmm.reduce_u64_mod, *cases["reduce_u64_mod"][2]),
                                      ((x << 32) + y) % p)
        af, bf = (v.astype(object) for v in cases["mul_mod_fermat16"][2])
        np.testing.assert_array_equal(_port(tmm.mul_mod_fermat16, af.astype(np.uint32),
                                            bf.astype(np.uint32)), af * bf % 65537)


@pytest.mark.parametrize("p", PRIMES[:2])
def test_mul_mod_shoup_lazy_keeps_its_range(p):
    """The lazy product is x*w mod p or that plus p: in [0, 2p), and some
    values are >= p, as the JAX package's butterflies expect."""
    jfn, tfn, args = _cases(p)["mul_mod_shoup_lazy"]
    got = _port(tfn, *args)
    assert got.min() >= 0 and got.max() < 2 * p and (got >= p).any()
    np.testing.assert_array_equal(got % p, args[0].astype(object) * int(args[1]) % p)


@pytest.mark.parametrize("p", PRIMES[:2])
def test_pow_mod_matches_jax(p):
    """Against Python's pow at six exponents, and against JAX (one jit) at
    the Fermat inverse's p - 2."""
    mu = tmm.barrett_precompute(p)
    base = _words(64, p, [0, 1, p - 1])
    for e in (0, 1, 2, 5, p - 2, (p - 1) // 2):
        got = tmm.pow_mod(torch.from_numpy(base.astype(np.int64)), e, p, mu).numpy()
        np.testing.assert_array_equal(got, [pow(int(v), e, p) for v in base])
        if e == p - 2:
            want = _jax(jax.jit(jmm.pow_mod, static_argnums=1), base, e, np.uint32(p),
                        np.uint32(mu))
            np.testing.assert_array_equal(got, want)


def test_pow_mod_var_matches_jax():
    t = T_VAR
    consts = (t, (1 << 32) // t, (1 << 32) % t, tmm.shoup_precompute((1 << 32) % t, t))
    base = _words(64, t, [0, 1, t - 1])
    for e in (0, 1, 3, t - 2):
        got = tmm.pow_mod_var(torch.from_numpy(base.astype(np.int64)), e, *consts).numpy()
        np.testing.assert_array_equal(got, [pow(int(v), e, t) for v in base])
    want = _jax(jax.jit(jmm.pow_mod_var, static_argnums=1), base, t - 2,
                *(np.uint32(c) for c in consts))
    np.testing.assert_array_equal(got, want)


def test_montgomery_precompute_matches_jax():
    for p in PRIMES:
        assert tmm.montgomery_precompute(p) == jmm.montgomery_precompute(p)


@pytest.mark.parametrize("axis,m", [(0, 5), (1, 8), (1, 7)])
def test_add_mod_tree_matches_jax(axis, m):
    p = PRIMES[1]
    shape = (m, 64) if axis == 0 else (3, m, 16)
    x = RNG.integers(0, p, size=shape, dtype=np.uint64).astype(np.uint32)
    x.reshape(-1)[:3] = p - 1
    want = np.asarray(jmm.add_mod_tree(jnp.asarray(x), jnp.uint32(p), axis))
    got = tmm.add_mod_tree(torch.from_numpy(x.astype(np.int32)), p, axis).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# -- negacyclic products and ops/poly.py --------------------------------------

N = 64
K = 2


@pytest.fixture(scope="module")
def tables():
    ps = jprimes.find_ntt_primes(N, K, bits=30)
    return jntt.build_tables(N, ps), tntt.build_tables(N, ps, "cpu"), ps


def _rand_poly(ps, batch=2, n=N):
    return np.stack([RNG.integers(0, p, size=(batch, n), dtype=np.uint64)
                     for p in ps]).astype(np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("n,k,batch", [(256, 2, 1), (1024, 3, 2)])
def test_polymul_negacyclic_matches_jax(n, k, batch):
    """The plain twin (forward, pointwise, inverse) equals
    fhe_tpu.ops.ntt.polymul_negacyclic, and ntt_cuda's (B1, product, B2;
    its plain versions here) equals ntt_pallas.polymul_negacyclic in
    interpret mode (at n = 256: interpret mode takes seconds)."""
    ps = jprimes.find_ntt_primes(n, k)
    tb_j, tb = jntt.build_tables(n, ps), tntt.build_tables(n, ps, "cpu")
    a, b = _rand_poly(ps, batch, n), _rand_poly(ps, batch, n)
    want = np.asarray(jax.jit(jntt.polymul_negacyclic)(jnp.asarray(a), jnp.asarray(b), tb_j))
    np.testing.assert_array_equal(tntt.polymul_negacyclic(_t(a), _t(b), tb).numpy(), want)
    if n > 256:
        return
    want_pl = np.asarray(npal.polymul_negacyclic(jnp.asarray(a), jnp.asarray(b), tb_j,
                                                 npal.build_pallas_tables(n, ps),
                                                 interpret=True))
    np.testing.assert_array_equal(ntt_cuda.polymul_negacyclic(_t(a), _t(b), tb).numpy(),
                                  want_pl)


@pytest.mark.parametrize("scalar", [99999, -5, (1 << 70) + 3, "residues"])
def test_add_scalar_matches_jax(tables, scalar):
    tb_j, tb, ps = tables
    a = _rand_poly(ps)
    if scalar == "residues":
        res = np.array([12345 % p for p in ps], dtype=np.uint32)
        want = np.asarray(jpoly.add_scalar(jnp.asarray(a), jnp.asarray(res), tb_j))
        got = tpoly.add_scalar(_t(a), _t(res), tb)
    else:
        want = np.asarray(jpoly.add_scalar(jnp.asarray(a), scalar, tb_j))
        got = tpoly.add_scalar(_t(a), scalar, tb)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mul_ntt_and_schoolbook_match_jax(tables):
    tb_j, tb, ps = tables
    a, b = _rand_poly(ps, 1), _rand_poly(ps, 1)
    fast = tpoly.mul_ntt(_t(a), _t(b), tb).numpy()
    slow = tpoly.mul_negacyclic(_t(a), _t(b), tb).numpy()
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, np.asarray(jpoly.mul_ntt(jnp.asarray(a),
                                                                 jnp.asarray(b), tb_j)))
    np.testing.assert_array_equal(slow, np.asarray(jax.jit(jpoly.mul_negacyclic)(
        jnp.asarray(a), jnp.asarray(b), tb_j)))


def test_negacyclic_reduce_matches_jax(tables):
    tb_j, tb, ps = tables
    raw = _rand_poly(ps, 2, 2 * N)
    want = np.asarray(jpoly.negacyclic_reduce(jnp.asarray(raw), tb_j))
    np.testing.assert_array_equal(tpoly.negacyclic_reduce(_t(raw), tb).numpy(), want)


def test_mod_switch_matches_jax(tables):
    tb_j, tb, ps = tables
    q = ps[0] * ps[1]
    vals = [int(v) for v in RNG.integers(0, q, size=N)] + [0, q - 1, q // 2]
    res = jrns.to_rns_host(vals, ps)[:, None, :]
    want = np.asarray(jpoly.mod_switch(jnp.asarray(res), tb_j, None,
                                       jrns.make_mod_switch(tuple(ps))))
    got = tpoly.mod_switch(_t(res), tb, None, trns.make_mod_switch(tuple(ps), "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", ["power_of_two", "random", "zeros", "wrapped"])
def test_estimate_noise_matches_jax(tables, data):
    """To 1e-9 against the JAX formula (the centred norm rounded to float32,
    then log2) in host floats, and exactly against JAX where its float32
    log2 is exact (a power of two, zeros); elsewhere XLA's float32 log2 is
    not correctly rounded, so the JAX value itself is held to one float32
    step (2^-19 below 32)."""
    tb_j, tb, ps = tables
    a = np.zeros((K, 1, N), dtype=np.uint32)
    if data == "power_of_two":
        a[:, 0, 3] = 1 << 10
    elif data == "random":
        a = _rand_poly(ps, 1)
    elif data == "wrapped":
        a[:, 0, 5] = [p - 12345 for p in ps]
    pcol = np.array(ps, dtype=np.int64)[:, None, None]
    mag = np.where(a > pcol // 2, pcol - a, a).max()
    formula = np.log2(max(float(np.float32(mag)), 1.0))
    got = tpoly.estimate_noise(_t(a), tb)
    want = float(jpoly.estimate_noise(jnp.asarray(a), tb_j, ()))
    assert abs(got - formula) <= 1e-9
    assert abs(got - want) <= (1e-9 if data in ("power_of_two", "zeros") else 2.0 ** -19)


def test_uniform_mod_t_host_range_shape_dtype():
    gen = torch.Generator().manual_seed(3)
    for t in (65537, 786433):
        u = tsampling.uniform_mod_t_host(gen, t, 3, 512)
        assert u.dtype == torch.int32 and tuple(u.shape) == (3, 512)
        assert int(u.min()) >= 0 and int(u.max()) < t and len(torch.unique(u)) > 1000
    # the JAX helper's contract, for comparison: the same shape and range
    j = np.asarray(jsampling.uniform_mod_t_host(jax.random.PRNGKey(0), 65537, 3, 512))
    assert j.shape == (3, 512) and j.max() < 65537


@pytest.mark.parametrize("kw", [{}, {"poly_degree": 1024, "log_q": 54},
                                {"plain_modulus": 786433, "ks_omega": 2}])
def test_default_params_match_jax(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jparams.default_params(**kw)
        got = tparams.default_params(**kw)
    assert (got.n, got.t, got.q_primes, got.aux_primes, got.m_sk, got.gamma) == (
        want.n, want.t, want.q_primes, want.aux_primes, want.m_sk, want.gamma)
    assert got.security.ks_omega == want.security.ks_omega
