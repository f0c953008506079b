"""fhe_tpu_torch.utils: serialize (the same .npz format as
fhe_tpu.utils.serialize, files crossing between the packages both ways),
perf.PerformanceMonitor, debug.checked, and native (the port's ctypes
loader, bit-identical to the Python bodies; skipped, as
tests/test_native.py is, when the library is not built)."""

import numpy as np
import pytest
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import bootstrap as jbs
from fhe_tpu.scheme.context import make_context as jmake_context
from fhe_tpu.utils import serialize as jserialize

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv, bootstrap
from fhe_tpu_torch.scheme.types import (BootstrapKey, Ciphertext, GaloisKeys, Plaintext,
                                        PublicKey, RelinKeys, SecretKey)
from fhe_tpu_torch.utils import debug, native, perf, serialize


def _np(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def small():
    f = FHE(poly_degree=256, log_q=60, seed=3, device="cpu")
    pk, sk = f.keygen()
    return f, pk, sk, f.relinkey_gen(sk), f.galoiskey_gen(sk, elements=[3])


def _assert_same(got, want):
    """Equal residues and static fields, a port object against a port or a
    JAX object."""
    if isinstance(want, GaloisKeys) or type(want).__name__ == "GaloisKeys":
        assert sorted(got.data) == sorted(int(g) for g in want.data)
        for g in got.data:
            np.testing.assert_array_equal(_np(got.data[g]), _np(want.data[g]))
        return
    if type(want).__name__ == "BootstrapKey":
        assert got.level == want.level
        np.testing.assert_array_equal(_np(got.pos), _np(want.pos))
        np.testing.assert_array_equal(_np(got.neg), _np(want.neg))
        return
    np.testing.assert_array_equal(_np(got.data), _np(want.data))
    for f in ("level", "is_ntt_form", "scale_t"):
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f), f
    if hasattr(want, "noise_budget"):
        assert abs(float(got.noise_budget) - float(want.noise_budget)) < 1e-6


def test_roundtrip_all_types(tmp_path, small):
    f, pk, sk, rlk, gk = small
    pt = f.encode([1, 2, 3])
    ct = f.encrypt(pt, pk)
    objs = {"pk": pk, "sk": sk, "rlk": rlk, "gk": gk, "pt": pt, "ct": ct,
            "params": f.params}
    path = tmp_path / "bundle.npz"
    serialize.save(path, objs)
    out = serialize.load(path, device="cpu")
    for name, obj in objs.items():
        if name == "params":
            assert out[name] == obj
        else:
            assert type(out[name]) is type(obj)
            _assert_same(out[name], obj)
    assert out["ct"].noise_budget == ct.noise_budget


def test_loaded_keys_decrypt(tmp_path, small):
    f, pk, sk, *_ = small
    path = tmp_path / "ct.npz"
    serialize.save(path, {"ct": f.encrypt(f.encode([7, 8, 9]), pk), "sk": sk})
    out = serialize.load(path, device="cpu")
    assert list(f.decode(f.decrypt(out["ct"], out["sk"]))[:3]) == [7, 8, 9]


def test_rejects_unknown_type_and_slash_names(tmp_path, small):
    with pytest.raises(TypeError):
        serialize.save(tmp_path / "x.npz", {"bad": object()})
    with pytest.raises(ValueError):
        serialize.save(tmp_path / "x.npz", {"a/b": small[1]})


def test_ciphertext_scale_t_and_bootstrap_key_roundtrip(tmp_path):
    """A BGV ciphertext keeps its scale_t (and still decrypts); a
    BootstrapKey keeps its rows and level."""
    f = FHE(poly_degree=256, log_q=90, seed=12, scheme="bgv", device="cpu")
    pk, sk = f.keygen()
    ct = f.mod_switch_to_next(f.encrypt(f.encode([41, 42]), pk))
    assert ct.scale_t != 1
    g = FHE(poly_degree=64, log_q=60, lambda_=0, hamming_weight=8, seed=0, device="cpu")
    _, gsk = g.keygen()
    bsk = g.make_bootstrap_key(gsk, level=1)
    path = tmp_path / "bgv_bsk.npz"
    serialize.save(path, {"ct": ct, "sk": sk, "bsk": bsk})
    out = serialize.load(path, device="cpu")
    assert out["ct"].scale_t == ct.scale_t
    assert list(f.decode(f.decrypt(out["ct"], out["sk"]))[:2]) == [41, 42]
    assert isinstance(out["bsk"], BootstrapKey)
    _assert_same(out["bsk"], bsk)


@pytest.fixture(scope="module")
def jax_objs():
    """Objects of every type made by the JAX package: keys, Galois keys, a
    plaintext, a ciphertext, params, a mod-switched BGV ciphertext and a
    bootstrap key (n = 64, as tests/test_serialize.py makes it)."""
    jf = JFHE(poly_degree=256, log_q=60, seed=3)
    pk, sk = jf.keygen()
    pt = jf.encode([1, 2, 3])
    bf = JFHE(poly_degree=256, log_q=90, seed=12, scheme="bgv")
    bpk, _ = bf.keygen()
    prm = jmake_params(JSecurity(poly_degree=64, log_q=60, lambda_=0, hamming_weight=8))
    ctx = jmake_context(prm, use_pallas=False, use_mxu=False)
    kg, kb = jrandom.split(jrandom.PRNGKey(0))
    _, bsk_sk = jbfv.keygen(ctx, kg)
    return {"pk": pk, "sk": sk, "rlk": jf.relinkey_gen(sk),
            "gk": jf.galoiskey_gen(sk, elements=[3]), "pt": pt, "ct": jf.encrypt(pt, pk),
            "params": jf.params,
            "bgv_ct": bf.mod_switch_to_next(bf.encrypt(bf.encode([41, 42]), bpk)),
            "bsk": jbs.make_bootstrap_key(ctx, kb, bsk_sk, 1)}


PORT_TYPES = {"pk": PublicKey, "sk": SecretKey, "rlk": RelinKeys, "gk": GaloisKeys,
              "pt": Plaintext, "ct": Ciphertext, "bgv_ct": Ciphertext, "bsk": BootstrapKey}


def test_jax_file_loads_in_port(tmp_path, jax_objs):
    path = tmp_path / "jax.npz"
    jserialize.save(path, jax_objs)
    out = serialize.load(path, device="cpu")
    for name, obj in jax_objs.items():
        if name == "params":
            assert out[name] == make_scheme_params(SecurityParams(poly_degree=256, log_q=60))
            assert out[name].q_primes == obj.q_primes and out[name].gamma == obj.gamma
            continue
        assert isinstance(out[name], PORT_TYPES[name]), name
        _assert_same(out[name], obj)
    assert out["bgv_ct"].scale_t != 1


def test_port_file_loads_in_jax(tmp_path, jax_objs):
    """The JAX objects through the port (convert.py) and its save, then the
    JAX package's load: the same values."""
    port = {
        "pk": PublicKey(data=convert._tensor(_np(jax_objs["pk"].data), 3, "cpu")),
        "sk": SecretKey(data=convert._tensor(_np(jax_objs["sk"].data), 3, "cpu")),
        "rlk": convert.relin_keys_from_numpy(_np(jax_objs["rlk"].data), "cpu"),
        "gk": convert.galois_keys_from_numpy(
            {g: _np(v) for g, v in jax_objs["gk"].data.items()}, "cpu"),
        "pt": convert.plaintext_from_numpy(_np(jax_objs["pt"].data), "cpu"),
        "bsk": convert.bootstrap_key_from_numpy(_np(jax_objs["bsk"].pos),
                                                _np(jax_objs["bsk"].neg), 1, "cpu"),
        "params": make_scheme_params(SecurityParams(poly_degree=256, log_q=60)),
    }
    for name in ("ct", "bgv_ct"):
        jc = jax_objs[name]
        port[name] = convert.ciphertext_from_numpy(
            _np(jc.data), jc.level, jc.is_ntt_form, float(jc.noise_budget), "cpu",
            int(jc.scale_t))
    path = tmp_path / "port.npz"
    serialize.save(path, port)
    out = jserialize.load(path)
    for name, obj in jax_objs.items():
        if name == "params":
            assert out[name] == obj
            continue
        assert type(out[name]).__name__ == type(obj).__name__, name
        _assert_same(port[name], out[name])
        assert all(x.dtype == jnp.uint32 for x in (
            [out[name].pos] if name == "bsk" else
            list(out[name].data.values()) if name == "gk" else [out[name].data]))


def test_performance_monitor_counts_and_means(capsys):
    mon = perf.PerformanceMonitor()
    for _ in range(3):
        with mon.time("op", sync=[torch.zeros(4), {"x": Plaintext(data=torch.zeros(2))}]):
            sum(range(1000))
    with pytest.raises(RuntimeError), mon.time("raised"):
        raise RuntimeError
    stats = mon.get_stats()
    assert stats.counts == {"op": 3, "raised": 1}
    assert stats.mean_ms("op") == pytest.approx(stats.times_ms["op"] / 3)
    assert stats.mean_ms("op") > 0.0 and stats.mean_ms("missing") == 0.0
    assert stats.alloc_bytes is None and stats.allocs is None      # no CUDA here
    mon.print_stats()
    printed = capsys.readouterr().out
    assert "op" in printed and "raised" in printed and "allocated" not in printed
    mon.reset()
    assert mon.get_stats().counts == {} and mon.get_stats().times_ms == {}


def test_checked_passes_on_valid_op(small):
    f, pk, sk, *_ = small
    ct = f.encrypt(f.encode([1, 2]), pk)
    out = debug.checked(bfv.add)(f.ctx, ct, ct)
    assert list(f.decode(f.decrypt(out, sk))[:2]) == [2, 4]
    lwe = debug.checked(bootstrap.extract_lsb)(f.ctx, ct)      # not k rows: unchecked
    assert lwe.a.shape == (256,)


@pytest.mark.parametrize("bad", [0x7FFFFFFF, -1])
def test_checked_catches_out_of_range(small, bad):
    """A residue >= p, and a negative int32 (read as uint32 0xFFFFFFFF)."""
    f, pk, *_ = small
    ct = f.encrypt(f.encode([1]), pk)
    data = ct.data.clone()
    data[1, 0, 5] = bad
    with pytest.raises(ValueError, match="residue out of range"):
        debug.checked(lambda ctx, c: c)(f.ctx, ct.replace(data=data))
    p = f.ctx.ntt_q.p
    debug.assert_residues_in_range(ct.data, p)
    with pytest.raises(ValueError, match=r"at \[1, 0, 5\]"):
        debug.assert_residues_in_range(data, p, "ct")


native_only = pytest.mark.skipif(not native.available(), reason="native library not built")


def _python_only(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


@native_only
def test_native_is_prime_agrees(monkeypatch):
    from fhe_tpu_torch import primes
    cases = [0, 1, 2, 3, 4, 65536, 65537, 12289, 40961, (1 << 30) - 35, (1 << 30) - 41,
             999999937, 2 ** 61 - 1]
    got = [primes.is_prime(x) for x in cases]
    _python_only(monkeypatch)
    assert got == [primes.is_prime(x) for x in cases]


@native_only
def test_native_find_ntt_primes_and_psi_agree(monkeypatch):
    from fhe_tpu_torch import primes
    a = primes.find_ntt_primes(2048, 5, bits=30, exclude=(65537,))
    psi = primes.negacyclic_psi(512, a[0])
    _python_only(monkeypatch)
    assert a == primes.find_ntt_primes(2048, 5, bits=30, exclude=(65537,))
    assert psi == primes.negacyclic_psi(512, a[0]) and pow(psi, 512, a[0]) == a[0] - 1
    with pytest.raises(ValueError):
        primes.find_ntt_primes(1 << 20, 10_000, 30)


@native_only
@pytest.mark.parametrize("moduli", ["q", "t"])
def test_native_ntt_tables_bit_identical(monkeypatch, moduli):
    from fhe_tpu_torch import primes
    from fhe_tpu_torch.ops import ntt as tntt
    n = 512
    ps = tuple(primes.find_ntt_primes(n, 3, bits=30)) if moduli == "q" else (65537,)
    tntt._build_tables_np.cache_clear()
    fast = tntt._build_tables_np(n, ps)
    _python_only(monkeypatch)
    tntt._build_tables_np.cache_clear()
    slow = tntt._build_tables_np(n, ps)
    tntt._build_tables_np.cache_clear()
    assert set(fast) == set(slow)
    for key in fast:
        assert fast[key].dtype == slow[key].dtype and np.array_equal(fast[key], slow[key]), key
