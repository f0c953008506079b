"""Exact RNS decryption scaling — the decrypt part of ``fhe_tpu/ops/rns.py``.

m = round(t * x / q) mod t for the phase x = c0 + c1*s given by its residues,
all-integer through the gamma trick: the digits of [gamma*t*x]_q are summed
into a t lane and a gamma lane, and the centred gamma lane corrects the t
lane's rounding.  Bit-exact with ``fhe_tpu.ops.rns.decrypt_scale`` for any
valid t (the JAX package's t = 65537 Fermat lane gives the same bits).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import modmath as mm


@dataclasses.dataclass(frozen=True)
class DecryptConsts:
    """Per-prime arrays are [k] int32 tensors (uint32 bits) on one device;
    scalars are host ints, passed to the kernel by value."""

    p_src: torch.Tensor             # [k]
    gt_inv_phat: torch.Tensor       # [k]  [gamma*t*(q/q_i)^-1]_{q_i}
    gt_inv_phat_shoup: torch.Tensor
    phat_mod_t: torch.Tensor        # [k]  (q/q_i) mod t
    phat_shoup_t: torch.Tensor      # [k]  Shoup companions mod t
    phat_mod_g: torch.Tensor        # [k]  (q/q_i) mod gamma
    t: int
    gamma: int
    neg_inv_q_t: int                # [-q^-1]_t
    neg_inv_q_t_shoup: int
    neg_inv_q_g: int                # [-q^-1]_gamma
    inv_gamma_t: int                # gamma^-1 mod t
    inv_gamma_t_shoup: int
    gamma_mod_t: int                # [gamma]_t
    one_shoup_t: int                # floor(2^32/t): generic mod-t reduce
    gamma_mu: int                   # Barrett mu for gamma


ARRAY_FIELDS = ("p_src", "gt_inv_phat", "gt_inv_phat_shoup", "phat_mod_t",
                "phat_shoup_t", "phat_mod_g")


@functools.lru_cache(maxsize=None)
def _decrypt_host(src: tuple[int, ...], t: int, gamma: int) -> dict:
    Q = math.prod(src)
    gt_inv = [gamma * t % p * pow(Q // p, -1, p) % p for p in src]
    phat_t = [(Q // p) % t for p in src]
    neg_inv_q_t = (-pow(Q, -1, t)) % t
    inv_gamma_t = pow(gamma, -1, t)
    return dict(
        p_src=np.array(src, dtype=np.uint32),
        gt_inv_phat=np.array(gt_inv, dtype=np.uint32),
        gt_inv_phat_shoup=mm.shoup_array(gt_inv, src),
        phat_mod_t=np.array(phat_t, dtype=np.uint32),
        phat_shoup_t=mm.shoup_array(phat_t, [t] * len(src)),
        phat_mod_g=np.array([(Q // p) % gamma for p in src], dtype=np.uint32),
        t=t,
        gamma=gamma,
        neg_inv_q_t=neg_inv_q_t,
        neg_inv_q_t_shoup=mm.shoup_precompute(neg_inv_q_t, t),
        neg_inv_q_g=(-pow(Q, -1, gamma)) % gamma,
        inv_gamma_t=inv_gamma_t,
        inv_gamma_t_shoup=mm.shoup_precompute(inv_gamma_t, t),
        gamma_mod_t=gamma % t,
        one_shoup_t=mm.shoup_precompute(1, t),
        gamma_mu=mm.barrett_precompute(gamma),
    )


def make_decrypt(src_primes, t: int, gamma: int, device="cuda") -> DecryptConsts:
    if not (65537 <= t < (1 << 29)):
        raise ValueError(
            f"decrypt_scale needs 65537 <= t < 2^29, got {t} (see params.py)")
    host = _decrypt_host(tuple(int(p) for p in src_primes), t, gamma)
    return DecryptConsts(**{
        f: mm.u32_tensor(v, device) if f in ARRAY_FIELDS else v
        for f, v in host.items()})


def decrypt_scale(x: torch.Tensor, dc: DecryptConsts) -> torch.Tensor:
    """x: [k, B, n] int32 residues of the phase, coefficient domain.
    Returns [B, n] int32 plaintext coefficients mod t."""
    col = lambda v: v.to(torch.int64).view(-1, 1, 1)
    t, g = dc.t, dc.gamma
    z = x.to(torch.int64) * col(dc.gt_inv_phat) % col(dc.p_src)
    acc_t = (z * col(dc.phat_mod_t) % t).sum(0) % t
    acc_g = (z * col(dc.phat_mod_g) % g).sum(0) % g
    s_t = acc_t * dc.neg_inv_q_t % t
    s_g = acc_g * dc.neg_inv_q_g % g
    # centre s_g: e_hat = s_g (s_g <= gamma/2) or s_g - gamma, taken mod t
    e_mod_t = torch.where(s_g <= (g >> 1), s_g % t, (s_g - dc.gamma_mod_t) % t)
    return ((s_t - e_mod_t) % t * dc.inv_gamma_t % t).to(torch.int32)
