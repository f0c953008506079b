"""The work each kernel of the benchmarked paths needs, from its shape alone.

A kernel's roofline share is the least time the card could take for its
work, the larger of (integer operations / the integer peak) and (bytes /
the HBM bandwidth), over the kernel's measured time.  The counts below
describe what the algorithm needs, not what today's kernels issue: n/2 *
log2(n) butterflies per transform, one 32x32->64 multiply-add per digit x
key term and one wide reduction per 16 terms (a sum of 16 products of
30-bit residues still fits 64 bits), every input word read once and every
output word written once.  Work a kernel may fold away (the n^-1 scaling
of an inverse transform, the reduction of a digit below 2^30 before its
transform) is not counted.

The instructions each modular step costs are frozen here, as numbers: the
counts of the program's helpers when this benchmark was written.  A later
kernel that finds a cheaper reduction therefore cannot move its own
yardstick.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

# 32-bit integer instructions of one call of each modular step: add_mod,
# sub_mod (compare, subtract, select, add), a Shoup product, a Barrett
# product of two residues, a wide (64-bit) reduction, one 32x32->64
# multiply-add, a conditional correction, a Galois source index, and one
# butterfly (a Shoup product, an add and a subtract).
OPS = {"add_mod": 4, "sub_mod": 4, "mul_shoup": 6, "mul_barrett": 11, "neg_mod": 3,
       "reduce_wide": 15, "mac_wide": 1, "select": 3, "galois_index": 4,
       "galois_ntt_index": 2, "ntt_butterfly": 14}
WORD = 4
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


@dataclasses.dataclass(frozen=True)
class Work:
    ops: int
    bytes: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def __mul__(self, times: int) -> "Work":
        return Work(self.ops * times, self.bytes * times)


def min_seconds(work: Work, peaks: dict = PEAKS) -> tuple[float, str]:
    """The least time the card could take for ``work``, and which bound
    sets it ("ops" or "bytes")."""
    by_ops = work.ops / peaks["int32_ops_per_s"]
    by_bytes = work.bytes / peaks["hbm_bytes_per_s"]
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")


def transform_ops(n: int) -> int:
    """One negacyclic transform of length n."""
    return n // 2 * (n.bit_length() - 1) * OPS["ntt_butterfly"]


def _sum_ops(terms: int) -> int:
    """A sum of ``terms`` products of residues, reduced once per 16 terms."""
    return terms * OPS["mac_wide"] + math.ceil(terms / 16) * OPS["reduce_wide"]


def ntt(n: int, rows: int) -> Work:
    """B1 / B2: ``rows`` (prime, polynomial) rows transformed, read and
    written once."""
    return Work(rows * transform_ops(n), 2 * rows * n * WORD)


def mul_by_ntt_operand(n: int, k: int, comps: int, batch: int = 1) -> Work:
    """B3 / B13: u [k, B, n] forward, times the NTT-form w [k, comps, n]
    (a Barrett product), each product inverted: [k, comps, B, n]."""
    per = transform_ops(n) + comps * (n * OPS["mul_barrett"] + transform_ops(n))
    return Work(k * batch * per, n * WORD * (k * batch + k * comps + k * comps * batch))


def tensor_product(n: int, k: int, batch: int = 1) -> Work:
    """B4 / B11: x, y [k, 2, B, n] forward (four rows), the products
    x0y0, x0y1 + x1y0, x1y1 (four Barrett products, one add), three
    inverses: [k, 3, B, n]."""
    per = 7 * transform_ops(n) + n * (4 * OPS["mul_barrett"] + OPS["add_mod"])
    return Work(k * batch * per, k * batch * n * WORD * (4 + 3))


def _conv_ops(src: int, dst: int) -> int:
    """A fast base conversion of one coefficient from ``src`` to ``dst``
    primes: a Shoup product per source digit, a sum of ``src`` terms per
    destination prime."""
    return src * OPS["mul_shoup"] + dst * _sum_ops(src)


def bsk_branch(n: int, k: int, kb: int, batch: int = 1) -> Work:
    """B5 (batched: one launch for B pairs): the four rows of a, b [k, 4,
    B, n] lifted from q to Bsk (a conversion and a centring select a
    coefficient), their tensor product in Bsk (four forwards, four Barrett
    products and an add, three inverses), and the floor of t*x/q of the q
    products tx_q [k, 3, B, n] into Bsk (a conversion, a subtract and a
    Shoup product): [kb, 3, B, n]."""
    lift = 4 * n * (_conv_ops(k, kb) + kb * OPS["select"])
    product = kb * (7 * transform_ops(n) + n * (4 * OPS["mul_barrett"] + OPS["add_mod"]))
    floor = 3 * n * (_conv_ops(k, kb) + kb * (OPS["sub_mod"] + OPS["mul_shoup"]))
    return Work(batch * (lift + product + floor), batch * n * WORD * (4 * k + 3 * k + 3 * kb))


def base_conv_sk(n: int, k: int, kb: int, rows: int, digit_rows: int = 0) -> Work:
    """B6: the exact Shenoy-Kumaresan conversion of [kb, R, n] (kb - 1 aux
    primes, then m_sk) to [k, R, n]: the aux digits, m_sk's correction
    alpha (a conversion into m_sk and a Shoup product), each destination's
    sum, alpha's term and its subtract; with ``digit_rows`` relinearization
    digits [k, digit_rows, n] (a Shoup product each) stored beside."""
    aux = kb - 1
    per = (_conv_ops(aux, 1) + OPS["mul_shoup"]
           + k * (_sum_ops(aux) + OPS["mul_shoup"] + OPS["sub_mod"]))
    ops = rows * n * per + digit_rows * n * k * OPS["mul_shoup"]
    return Work(ops, n * WORD * (kb * rows + k * rows + k * digit_rows))


def keyswitch(n: int, k: int, kd: int, batch: int = 1, galois: bool = False) -> Work:
    """B7 / B12: for each of B digit stacks d [kd, B, n] and each output
    prime, the kd digits' forward transforms, the sums over kd of digit x
    key [k, kd, 2, n] for two components, and two inverses: [k, 2, B, n].
    The Galois lane also reads c0 [k, B, n] and adds phi_g(c0), a source
    index and an add a coefficient."""
    ops = batch * ((k * kd + 2 * k) * transform_ops(n) + 2 * k * n * _sum_ops(kd))
    words = kd * batch + k * kd * 2 + 2 * k * batch
    if galois:
        ops += batch * k * n * (OPS["add_mod"] + OPS["galois_index"])
        words += k * batch
    return Work(ops, n * WORD * words)


def ks_inner(n: int, k: int, kd: int, elements: int, stacks: int = 1,
             galois: bool = False) -> Work:
    """B17 / B18: the hoisted inner products of NTT-form digits [k, kd,
    stacks, n] with E elements' keys [k, kd, E, 2, n], summed over kd, and
    their inverses: [k, 2, E, n].  The Galois lane also reads c0 and
    gathers each element's products (a source index and an add)."""
    ops = elements * 2 * k * (transform_ops(n) + n * _sum_ops(kd))
    words = stacks * k * kd + elements * k * kd * 2 + elements * k * 2
    if galois:
        ops += elements * k * n * (OPS["add_mod"] + OPS["galois_ntt_index"])
        words += stacks * k
    return Work(ops, n * WORD * words)


def automorphism_sum(n: int, k: int, elements: int) -> Work:
    """B15: base [k, 2, n] + sum_e phi_e(delta_e + (c0, 0)) for delta
    [k, 2, E, n]: c0's add per element, and per component and element a
    source index, a sign flip and the accumulating add."""
    per = elements * OPS["add_mod"] + 2 * elements * (
        OPS["galois_index"] + OPS["neg_mod"] + OPS["add_mod"])
    return Work(k * n * per, n * WORD * (k * 2 * elements + k + 2 * k + 2 * k))
