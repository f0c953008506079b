"""The column form's index maps (csrc/column.cuh), held on the CPU.

From n = 262144 every cluster kernel of the port runs as a chain of
ordinary launches that meet in global memory: column launches, which run
the stages that pair elements of different blocks on tiles of columns, and
block launches, which run the rest on blocks of b = n / 2^s positions.
ops/ntt.py's plain model of that order (column_forward_stages,
block_forward_stages, block_inverse_stages, column_inverse_stages) equals
fhe_tpu.ops.ntt's transforms bit for bit at n = 256, 1024 and 4096, k = 3,
for every s from 1 to log2(n) - 4, and the key switch chained the kernels'
way (digits, column launch, block launch with the inner product, inverse
column launch) equals the port's plain keyswitch_fused_batch.  A model of
the kernels' own schedule (the tiles' butterfly loops and the block
launches' register-blocked passes of modmath.cuh, pass by pass and group
by group) gives the same bits.  The card repeats all of it:
chip_smoke.py's n262144 phase (the column form forced at n = 8192 and
131072 against the cluster forms, and each kernel's column form against
its plain twin at n >= 262144).  Integers, tolerance 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt as jntt

from fhe_tpu_torch.ops import ntt as tntt

RNG = np.random.default_rng(22)
CASES = [(n, s) for n in (256, 1024, 4096) for s in range(1, n.bit_length() - 1 - 4 + 1)]


@functools.lru_cache(maxsize=None)
def _tables(n):
    moduli = tuple(jprimes.find_ntt_primes(n, 3))
    return moduli, jntt.build_tables(n, moduli), tntt.build_tables(n, moduli, "cpu")


def _residues(moduli, rows, n):
    return np.stack([RNG.integers(0, p, (rows, n), dtype=np.uint32) for p in moduli])


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("n,s", CASES)
def test_column_order_equals_jax_ntt(n, s):
    """ntt_forward_columns and ntt_inverse_columns with s column stages ==
    fhe_tpu.ops.ntt's forward and inverse transforms of [3, 2, n]."""
    moduli, jtb, tb = _tables(n)
    a = _residues(moduli, 2, n)
    want_f = np.asarray(jax.jit(jntt.ntt_forward)(jnp.asarray(a), jtb))
    want_i = np.asarray(jax.jit(jntt.ntt_inverse)(jnp.asarray(a), jtb))
    got_f = tntt.ntt_forward_columns(_t(a), tb, s).numpy().astype(np.uint32)
    got_i = tntt.ntt_inverse_columns(_t(a), tb, s).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_keyswitch_chain_equals_plain_twin(n):
    """B7's column chain (keyswitch_columns: the digits' column launch, the
    block launch's forward stages, products with both key rows summed over
    kd = 3 digits and inverse stages, the inverse column launch) == the
    port's plain keyswitch_fused_batch at B = 2, for every s."""
    moduli, _, tb = _tables(n)
    keys = _t(np.stack([_residues(moduli, 2, n) for _ in range(3)], axis=1))   # [k, kd, 2, n]
    d = _t(np.stack([RNG.integers(0, q, (2, n), dtype=np.uint32) for q in moduli]))
    want = tntt.keyswitch_fused_batch(d, keys, tb)
    for s in range(1, n.bit_length() - 1 - 4 + 1):
        assert torch.equal(tntt.keyswitch_columns(d, keys, tb, s), want), s


# -- a model of the kernels' schedule (column.cuh, modmath.cuh ntt_regs_pass)

def _regs_pass(x, L, inverse, logn, logT, p, w, load, store, h, logH):
    """modmath.cuh's ntt_regs_pass for CTA h of 2^logH: its groups, each of
    G = 2^L elements base + (i << logs), through L stages in registers."""
    G, logs, per = 1 << L, logT + 1 - L, 1 << (logn - L - logH)
    for grp in range(h * per, (h + 1) * per):
        g0 = grp >> logs
        base = (g0 << (logT + 1)) | (grp & ((1 << logs) - 1))
        v = load(base, logs, G)
        m0 = (1 << (logn - 1 - logT)) + g0
        for st in range(L):
            l = L - 1 - st if inverse else st
            half = G >> (l + 1)
            for b in range(1 << l):
                wv = int(w[(m0 << l) + b])
                for q in range(half):
                    i1, i2 = 2 * b * half + q, 2 * b * half + q + half
                    u, t = v[i1], v[i2]
                    if inverse:
                        v[i1], v[i2] = (u + t) % p, (u - t) * wv % p
                    else:
                        t = t * wv % p
                        v[i1], v[i2] = (u + t) % p, (u - t) % p
        store(v, base, logs)


def _group_io(row):
    def load(base, logs, G):
        return [row[base + (i << logs)] for i in range(G)]

    def store(v, base, logs):
        for i, x in enumerate(v):
            row[base + (i << logs)] = x
    return load, store


def _block(row, logn, logb, h, p, w, inverse):
    """column.cuh's block_forward / block_inverse on block h: the pass
    sizes in their order (the lead pass of logb mod 4 stages first in the
    forward, second in the inverse; passes of 4 otherwise), the first and
    last passes on the row, the rest on the block's own positions."""
    io = _group_io(row)
    rem, sched = logb % 4, []
    if inverse:
        sched.append(4)
        if rem:
            sched.append(rem)
        sched += [4] * ((logb - sum(sched)) // 4)
    else:
        sched.append(rem or 4)
        sched += [4] * ((logb - sched[0]) // 4)
    assert sum(sched) == logb and sched[-1 if not inverse else 0] == 4
    lo = 0
    for L in sched:
        logT = lo + L - 1 if inverse else logb - 1 - lo
        _regs_pass(row, L, inverse, logn, logT, p, w, *io, h, logn - logb)
        lo += L


def _columns(row, logn, logb, logc, p, w, inverse, n_inv=1):
    """column.cuh's column_forward / column_inverse over every tile: tile
    word e is element e >> logc of column col0 + (e mod C), position
    col0 + (e mod C) + ((e >> logc) << logb)."""
    s, C = logn - logb, 1 << logc
    W = C << s
    for col0 in range(0, 1 << logb, C):
        pos = [col0 + (e & (C - 1)) + ((e >> logc) << logb) for e in range(W)]
        t = [row[j] for j in pos]
        for l in range(s):
            logd = l if inverse else s - 1 - l
            for q in range(W // 2):
                c, bi = q & (C - 1), q >> logc
                g = bi >> logd
                i1 = (g << (logd + 1)) | (bi & ((1 << logd) - 1))
                e1 = (i1 << logc) | c
                e2 = e1 + (1 << (logd + logc))
                u, v = t[e1], t[e2]
                if inverse:
                    wv = int(w[(1 << (s - 1 - l)) + g])
                    t[e1], t[e2] = (u + v) % p, (u - v) * wv % p
                else:
                    v = v * int(w[(1 << l) + g]) % p
                    t[e1], t[e2] = (u + v) % p, (u - v) % p
        for e, j in enumerate(pos):
            row[j] = t[e] * n_inv % p


@pytest.mark.parametrize("n,logb,logc", [(256, 5, 3), (1024, 6, 2), (1024, 7, 7),
                                         (2048, 8, 5), (4096, 9, 3), (8192, 12, 12)])
def test_kernel_schedule_equals_plain_ntt(n, logb, logc):
    """The kernels' schedule at block 2^logb and tiles of 2^logc columns:
    the forward's column launch then every block launch, and every block
    launch of the inverse then its column launch (times n^-1), == the plain
    transforms of one row."""
    p = jprimes.find_ntt_primes(n, 1)[0]
    tb = tntt.build_tables(n, (p,), "cpu")
    logn = n.bit_length() - 1
    a = RNG.integers(0, p, n)
    x = _t(a).view(1, 1, n)
    psi = tb.psi_br[0].numpy().astype(np.int64) % (1 << 32)
    ipsi = tb.ipsi_br[0].numpy().astype(np.int64) % (1 << 32)
    row = [int(v) for v in a]
    _columns(row, logn, logb, logc, p, psi, False)
    for h in range(n >> logb):
        _block(row, logn, logb, h, p, psi, False)
    assert row == tntt.ntt_forward(x, tb).view(-1).tolist()
    row = [int(v) for v in a]
    for h in range(n >> logb):
        _block(row, logn, logb, h, p, ipsi, True)
    _columns(row, logn, logb, logc, p, ipsi, True, pow(n, -1, p))
    assert row == tntt.ntt_inverse(x, tb).view(-1).tolist()
