"""The frozen work counts against hand-worked values at n = 16, and proof
that computing them reads nothing of the program."""

import builtins
import io
import pathlib

import pytest

from benchmark import workcounts as wc

N = 16            # log2 n = 4: one transform is 8 * 4 = 32 butterflies of 14 ops


def test_transform_is_n_half_log_n_butterflies():
    assert wc.transform_ops(N) == 8 * 4 * 14 == 448


def test_keyswitch_at_n16_k2():
    # B = 1: (k*kd + 2k) = 8 transforms; 2k = 4 sums of 2 terms a coefficient,
    # each 2 multiply-adds and one wide reduction: 16 * 4 * (2 + 15)
    w = wc.keyswitch(N, 2, 2, 1)
    assert w.ops == 8 * 448 + 16 * 4 * 17 == 4672
    # digits 2n, keys 2*2*2n, output 2*2n words of 4 bytes
    assert w.bytes == 4 * N * (2 + 8 + 4) == 896
    # a batch multiplies the per-element work; the keys are read once
    w3 = wc.keyswitch(N, 2, 2, 3)
    assert w3.ops == 3 * 4672 and w3.bytes == 4 * N * (6 + 8 + 12)
    g = wc.keyswitch(N, 2, 2, 1, galois=True)
    assert g.ops == 4672 + 2 * N * 8 and g.bytes == 896 + 4 * N * 2


def test_keyswitch_folds_every_16_terms():
    # kd = 29 digits: two wide reductions a sum
    w = wc.keyswitch(N, 1, 29, 1)
    assert w.ops == (29 + 2) * 448 + 2 * N * (29 + 2 * 15)


def test_ks_inner_at_n16_k2():
    # E = 3 elements, 2 components, k = 2 primes: 12 inverse transforms and
    # 12 sums of kd = 2 terms a coefficient
    w = wc.ks_inner(N, 2, 2, 3)
    assert w.ops == 12 * (448 + N * 17) == 8640
    # digits k*kd*n once, keys E*k*kd*2*n, output E*k*2*n
    assert w.bytes == 4 * N * (4 + 24 + 12) == 2560
    g = wc.ks_inner(N, 2, 2, 3, galois=True)
    assert g.ops == 8640 + 3 * 2 * N * 6 and g.bytes == 2560 + 4 * N * 2


def test_the_other_kernels_at_n16():
    assert wc.ntt(N, 3) == wc.Work(3 * 448, 2 * 3 * N * 4)
    assert wc.tensor_product(N, 2, 1) == wc.Work(2 * (7 * 448 + N * 48), 2 * N * 4 * 7)
    assert wc.mul_by_ntt_operand(N, 2, 2, 1).ops == 2 * (448 + 2 * (N * 11 + 448))
    # one coefficient's conversion from 2 to 3 primes: 2 Shoup products and
    # 3 sums of 2 terms
    conv = 2 * 6 + 3 * (2 + 15)
    b5 = wc.bsk_branch(N, 2, 3, 1)
    assert b5.ops == (4 * N * (conv + 3 * 3) + 3 * (7 * 448 + N * 48)
                      + 3 * N * (conv + 3 * 10))
    assert b5.bytes == N * 4 * (8 + 6 + 9)
    # 3 Bsk primes (2 aux + m_sk) to k = 2, R = 3 rows, 1 digit row
    aux_conv = 2 * 6 + (2 + 15)
    b6 = wc.base_conv_sk(N, 2, 3, 3, 1)
    assert b6.ops == 3 * N * (aux_conv + 6 + 2 * (17 + 10)) + N * 2 * 6
    assert b6.bytes == N * 4 * (9 + 6 + 2)
    assert wc.automorphism_sum(N, 2, 3).ops == 2 * N * (3 * 4 + 6 * 11)


def test_min_seconds_names_its_bound():
    peaks = {"int32_ops_per_s": 1e12, "hbm_bytes_per_s": 1e12}
    assert wc.min_seconds(wc.Work(10, 5), peaks) == (10 / 1e12, "ops")
    assert wc.min_seconds(wc.Work(5, 10), peaks) == (10 / 1e12, "bytes")


def test_counts_read_no_file_of_the_program(monkeypatch):
    source = pathlib.Path(wc.__file__).read_text()
    assert "fhe_tpu_torch" not in source and "modmath.cuh" not in source
    opened = []
    real_open = builtins.open

    def spy(path, *a, **k):
        opened.append(str(path))
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.setattr(io, "open", spy)
    monkeypatch.setattr(pathlib.Path, "read_text",
                        lambda self, *a, **k: opened.append(str(self)) or "")
    for fn, args in ((wc.keyswitch, (32768, 29, 29, 8)), (wc.ks_inner, (32768, 29, 29, 3)),
                     (wc.ntt, (8192, 7)), (wc.tensor_product, (8192, 7, 64)),
                     (wc.bsk_branch, (8192, 7, 8, 64)), (wc.base_conv_sk, (8192, 7, 8, 192, 64)),
                     (wc.mul_by_ntt_operand, (8192, 7, 2)), (wc.automorphism_sum, (8192, 7, 3))):
        wc.min_seconds(fn(*args))
    assert opened == []


@pytest.mark.parametrize("n,k", [(8192, 7), (32768, 29)])
def test_counts_grow_with_the_shapes(n, k):
    assert wc.keyswitch(n, k, k, 8).ops > wc.keyswitch(n, k, k, 1).ops
    assert wc.ks_inner(n, k, k, 3).bytes > wc.ks_inner(n, k, k, 2).bytes
