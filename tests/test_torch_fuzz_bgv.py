"""scripts/fuzz_torch.py draws the circuits of scripts/fuzz.py for two BGV
seeds at ks_omega = 2 (n = 128, log_q = 120, h = 8, t = 65537; seed 2 adds
and subtracts fresh and plain operands, seed 3 also rotates and multiplies
by a plaintext): the same parameters, ops and tracked budget, and both
pass.  Then a fixed circuit at those parameters, run op by op in both
packages from JAX's keys and fresh ciphertexts (carried into the port
with convert.*_from_numpy): every intermediate ciphertext equals JAX's,
scale_t included, tolerance 0 (budgets: JAX carries them in float32,
1e-4).  The circuit reuses the ops the two seeds compile in JAX, plus the
multiply and the mod switch.  The BFV seed is in tests/test_torch_fuzz.py,
whose helpers this file uses."""

import warnings

import numpy as np
import pytest

from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.params import SecurityParams, make_scheme_params

from test_torch_fuzz import check_same_circuit, load_fuzzers


@pytest.fixture(scope="module")
def fuzzers():
    return load_fuzzers()


@pytest.mark.parametrize("seed", [2, 3])
def test_fuzz_draws_the_same_bgv_circuit(fuzzers, seed):
    check_same_circuit(fuzzers, seed)


def test_fixed_circuit_matches_jax_step_by_step():
    """BGV at seeds 2 and 3's parameters (ks_omega = 2, k = 4): plain ops,
    an add and a subtraction of fresh ciphertexts, a rotation (the
    prereduced key switch), a plain product, the multiply with
    relinearization, a mod switch (scale_t != 1 from here) and a plain add
    at level 1."""
    kw = dict(poly_degree=128, log_q=120, hamming_weight=8, ks_omega=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfhe = JFHE(jmake_params(JSecurity(**kw)), seed=5, scheme="bgv")
        tfhe = FHE(make_scheme_params(SecurityParams(**kw)), seed=5, scheme="bgv",
                   device="cpu")
    rng = np.random.default_rng(5)
    slots = 2 * jfhe.params.slot_count
    jpk, jsk = jfhe.keygen()
    jrlk = jfhe.relinkey_gen(jsk)
    jgal = jfhe.galoiskey_gen(jsk)
    jcts = [jfhe.encrypt(jfhe.encode(rng.integers(0, 100, size=slots)), jpk)
            for _ in range(3)]
    _, sk = convert.keys_from_numpy(np.asarray(jpk.data), np.asarray(jsk.data), "cpu")
    rlk = convert.relin_keys_from_numpy(np.asarray(jrlk.data), "cpu")
    gal = convert.galois_keys_from_numpy({g: np.asarray(v) for g, v in jgal.data.items()},
                                         "cpu")
    cts = [convert.ciphertext_from_numpy(np.asarray(c.data), c.level, c.is_ntt_form,
                                         float(c.noise_budget), "cpu",
                                         scale_t=int(np.asarray(c.scale_t))) for c in jcts]
    jpts = [jfhe.encode(rng.integers(0, 30, size=slots)) for _ in range(4)]
    pts = [convert.plaintext_from_numpy(np.asarray(p.data), "cpu") for p in jpts]

    steps = [
        ("sub_plain", lambda f, c, s: f.sub_plain(c, s["pts"][0])),
        ("add", lambda f, c, s: f.add(c, s["cts"][1])),
        ("rotate_rows 2", lambda f, c, s: f.rotate_rows(c, 2, s["gal"])),
        ("multiply_plain", lambda f, c, s: f.multiply_plain(c, s["pts"][1])),
        ("sub", lambda f, c, s: f.sub(c, s["cts"][2])),
        ("add_plain", lambda f, c, s: f.add_plain(c, s["pts"][2])),
        ("multiply", lambda f, c, s: f.multiply(c, s["cts"][1], s["rlk"])),
        ("mod_switch_to_next", lambda f, c, s: f.mod_switch_to_next(c)),
        ("add_plain at level 1", lambda f, c, s: f.add_plain(c, s["pts"][3])),
    ]
    jstate = {"cts": jcts, "rlk": jrlk, "gal": jgal, "pts": jpts}
    tstate = {"cts": cts, "rlk": rlk, "gal": gal, "pts": pts}
    jct, ct = jcts[0], cts[0]
    for name, op in steps:
        jct, ct = op(jfhe, jct, jstate), op(tfhe, ct, tstate)
        np.testing.assert_array_equal(convert.to_numpy(ct), np.asarray(jct.data), err_msg=name)
        assert (ct.level, ct.is_ntt_form, ct.scale_t) == (
            jct.level, jct.is_ntt_form, int(np.asarray(jct.scale_t))), name
        assert abs(ct.noise_budget - float(jct.noise_budget)) <= 1e-4, name
    np.testing.assert_array_equal(convert.to_numpy(tfhe.decrypt(ct, sk)),
                                  np.asarray(jfhe.decrypt(jct, jsk).data))
