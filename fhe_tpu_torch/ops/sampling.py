"""Samplers drawing from an explicit ``torch.Generator`` (Philox on CUDA) —
counterpart of ``fhe_tpu/ops/sampling.py``.

They cannot reproduce the JAX package's threefry draws, so the scheme layer
also takes explicit noise (``bfv.keygen_from_noise``,
``bfv.encrypt_from_noise``) and the tests feed both packages the same draws.
Outputs are [k, batch, n] int32 residues; a negative sample v maps to p - |v|.
The generator must live on the device of ``primes``.
"""

from __future__ import annotations

import torch


def small_signed_to_rns(vals: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """[batch, n] small signed ints -> [k, batch, n] residues."""
    return torch.remainder(vals.to(torch.int64)[None],
                           primes.to(torch.int64).view(-1, 1, 1)
                           ).to(torch.int32)


def uniform_rns(gen: torch.Generator, primes: torch.Tensor, batch: int,
                n: int) -> torch.Tensor:
    """Uniform in [0, p) independently per prime (no modulo bias)."""
    return torch.stack([
        torch.randint(0, int(p), (batch, n), generator=gen,
                      device=primes.device, dtype=torch.int64)
        for p in primes.tolist()]).to(torch.int32)


def gaussian_rns(gen: torch.Generator, primes: torch.Tensor, sigma: float,
                 batch: int, n: int) -> torch.Tensor:
    """Rounded Gaussian of standard deviation sigma."""
    g = torch.randn((batch, n), generator=gen, device=primes.device,
                    dtype=torch.float32) * sigma
    return small_signed_to_rns(torch.round(g), primes)


def ternary_rns(gen: torch.Generator, primes: torch.Tensor, batch: int, n: int,
                hamming_weight: int | None = None) -> torch.Tensor:
    """Ternary {-1, 0, 1} polynomial; with hamming_weight h, exactly h
    nonzero entries at a uniform random h-subset of positions, each ±1."""
    dev = primes.device
    if hamming_weight is None:
        v = torch.randint(-1, 2, (batch, n), generator=gen, device=dev)
        return small_signed_to_rns(v, primes)
    h = hamming_weight
    if not 0 <= h <= n:
        raise ValueError(f"hamming weight {h} out of range for n={n}")
    v = torch.zeros((batch, n), dtype=torch.int64, device=dev)
    for b in range(batch):
        idx = torch.randperm(n, generator=gen, device=dev)[:h]
        signs = torch.randint(0, 2, (h,), generator=gen, device=dev) * 2 - 1
        v[b, idx] = signs
    return small_signed_to_rns(v, primes)


def uniform_mod_t_host(gen: torch.Generator, t: int, batch: int, n: int) -> torch.Tensor:
    """Uniform plaintext coefficients in [0, t), [batch, n] int32 on the
    generator's device (a test helper, as in the JAX package)."""
    return torch.randint(0, int(t), (batch, n), generator=gen, device=gen.device,
                         dtype=torch.int64).to(torch.int32)
