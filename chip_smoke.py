#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (fhe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch, nvcc;
  2. build: every CUDA kernel from fhe_tpu_torch/csrc/, with its time;
  3. kernels: each kernel against its plain PyTorch version on the card at
     n = 8192, k = 3 (k = 8 for the prereduced lanes), bit-exact (tolerance
     0), with device times (CUDA
     events, median of 25 launches after warm-up), the plain version's time
     and the least time the card could take (bound); then the launch shape
     of each cluster kernel (ntt_forward, ntt_inverse, mul_by_ntt_operand,
     tensor_product, bsk_branch_fused, keyswitch_fused, decrypt_fused,
     ks_inner_batch / ks_inner_grouped and the batch forms: grid, cluster,
     CTAs, threads, shared memory) at
     n = 8192 and 16384, and n = 16384 (the JAX bench's g_n16384,
     log_q = 90, k = 3, seed 4): the multiply at ks_omega = 1 and 2 decodes
     [15, 60], equals the CPU plain path and launched each of its kernels,
     with its device and wall ms; and n = 32768 (the bench's g_n32768, seed
     5): ntt_forward equals its plain twin, forward_ntt_ms_n32768, and so
     does ntt_inverse on the same rows (its device ms a check, not a bench
     metric);
  4. slice: the linear-ops main path through the FHE facade at n = 8192,
     log_q = 90 (k = 3), h = 64: keygen, encode, encrypt, add, add_plain and
     the 8-term resident plaintext multiply-accumulate, then decrypt and
     decode.  Every launch count is zeroed just before and read just after;
     each kernel of the path must have launched.  The decoded slots must be
     [8,16,24,32] and 180, and the card's results must equal the plain
     path's on the CPU bit for bit.  Then end-to-end times of each op;
  5. multiply: the ciphertext multiply path through the facade at the same
     width: keygen, relinkey_gen, encode and encrypt [5,10,15,20] and
     [3,6,9,12], multiply_no_relin, 3-component decrypt, relinearize,
     decrypt, and multiply; every decode must be [15,60,135,240].  Counts
     are zeroed before and read after, as in phase 4, and the card's
     relinearization keys, products and decryptions must equal the CPU
     plain path's bit for bit.  Then end-to-end times of each op, the
     device times of the multiply, its halves and the decrypt, and their
     device kernels per call (torch.profiler);
  6. serving: the batch and rotation path through the facade at the same
     width and B = 8: keygen, relinkey_gen, galoiskey_gen for (3, 2n - 1),
     encrypt_batch and decrypt_batch of two batches, multiply_batch (each
     element equal to the single multiply), rotate_rows by 1,
     rotate_columns and rotate_rows_batch by 1; every result decodes to its
     known slots.  Counts are zeroed before and read after; the batch
     kernels and keyswitch_fused's Galois lane must have launched.  The
     _from_noise entry points and every batch and rotation op must equal
     the CPU plain path bit for bit.  The three rotations alone launch the
     Galois lane only (no automorphism kernel, no classic key switch), with
     their profiler kernels per call.  Then end-to-end times of each op and
     per ciphertext, and multiply_batch at B = 24 (each product equal to
     the B = 8 one of its pair);
  7. hoisted: the hoisted rotations through the facade at the same width
     (the JAX bench's rotations group): keygen, galoiskey_gen for 3^s,
     s = 1..8, rotate_rows_hoisted of the 8 steps (each decodes to its
     rotation and decrypts as rotate_rows; the bits differ by design),
     rotate_rows_hoisted_batch of 4 ciphertexts (element [c][e] equal to
     rotate_rows_hoisted(cts[c])[e]), and sum_slots with the keys of
     sum_slots_elements() (every slot decodes to 50).  Card == CPU plain
     path for hoisted_galois_keys, both hoisted calls and sum_slots.  The
     hoisted calls launch the Galois lanes of ks_inner_batch and
     ks_inner_grouped once each, and sum_slots ks_inner_batch's Inner lane
     and automorphism_fused_sum six times each (one per radix-4 stage) and
     keyswitch_fused's Galois lane once, with no other automorphism kernel,
     with their profiler kernels per call.  Then wall and device times, per
     rotation beside rotate_rows by 1;
  8. omega: grouped gadget key switching at the JAX bench's k8_omega
     configuration, n = 8192, log_q = 218 (k = 8, kb = 10), ks_omega = 2
     (kd = 4): multiply decodes [15,60], multiply_batch at B = 8 equals the
     single multiply, rotate_rows by 1 decodes 10 and rotate_rows_batch by
     1 decodes (element i == rotate_rows; at ks_omega = 2 they launch
     automorphism_single and automorphism_fused before the prereduced key
     switch), and the hoisted calls as in phase 7; card == CPU plain path
     for relinkey_gen_from_noise, multiply, rotate_rows and
     rotate_rows_hoisted.  Then times;
  9. leveled: every op below level 0 at the JAX bench's k8 configuration,
     n = 8192, log_q = 218 (k = 8, kb = 10), h = 64, ks_omega = 1: multiply
     at level 0, mod_switch_to_next, multiply by the second operand at
     level 1, mod_switch_to_level 4, then at level 4 multiply_plain,
     add_plain, rotate_rows by 1, rotate_rows_hoisted of 8 steps and its
     batch of 4 ciphertexts, sum_slots, and multiply_batch at B = 8 at
     level 2; every result decodes.  Card == CPU plain path for the switched
     keys, the products and the mod switches.  With ks_omega = 2 at k = 8
     a multiply at level 2 decodes and one at level 1 raises.  Then the
     multiply at levels 0 and 1 (keys of the level, as the JAX bench's
     multiply_relin_ms_level1) at k = 3 and k = 8 with the per-prime ratio
     (t_L1 / (k-1)) / (t_L0 / k) (bench.py's leveled_per_prime_ratio), the
     mod switch, the key down-switch and the rotations at level 4;
 10. small: the n < 1024 multiply (tensor_product's Lift lane, the
     products in q and, with the lift q -> Bsk, in Bsk in one launch, then
     fast_floor_fused with the conversion to q and the digits in one
     launch) at the JAX tests' leveled configuration, n = 256, log_q = 150
     (k = 5), h = 32: multiply at levels 0, 1 and 2 and multiply_batch at
     B = 8 at level 1 decode; card == CPU plain path; one multiply launches
     the Lift lane once, fast_floor_fused once, and neither tensor_product's
     plain lane, fast_bconv_sk_fused nor a cat; times and kernels per call;
 11. roofline: the modmul chain (B19) of every variant at two reps values
     on a [256, 8192] block; the slope over reps gives each step's rate:
     G modmul/s for exact, lazy and barrett Shoup/Barrett products, the
     mul17 and cheap17 op rates, lazy at ilp 2 and 4, and the share of one
     integer pipe's 16.7 T op/s and of the two pipes' 33.4 T that the
     measured rates reach by the OPS counts (the bounds use the two pipes);
 12. bgv: BGV through the facade (FHE(..., scheme="bgv")) at the JAX bench's
     g_bgv configuration, n = 8192, log_q = 90 (k = 3), h = 64, t = 65537,
     seed 1: keygen, relinkey_gen, galoiskey_gen for (3, 2n - 1), for 3^s,
     s = 1..8, and for sum_slots_elements(), encrypt [5,10,15,20] and
     [3,6,9,12], multiply_no_relin, the 3-component decrypt, relinearize
     and multiply (each decodes [15,60,135,240]), multiply_batch at B = 8
     (element i == multiply), rotate_rows by 1, rotate_columns,
     rotate_rows_hoisted of the 8 steps and its batch of 4 ciphertexts,
     sum_slots (50 in every slot), mod_switch_to_next, and at level 1
     (scale_t = q_last mod t != 1) add_plain, multiply_plain and
     rotate_rows by 1, which decode, and an add of mismatched scale_t,
     which must raise.  B1-B4, B7 (both lanes), B11, B12 and the Galois
     lanes of B17/B18 must have launched, and B5, B6, B8, B9, B10 and B13
     (BFV's) never.  Card == CPU plain path bit for bit for the keys from
     noise, encrypt_from_noise, the products, relinearize, multiply_batch,
     the mod switch, the rotations, the ops at level 1 and the decrypts,
     scale_t included.  Then bgv_multiply_relin_ms (wall and device ms)
     beside BFV's headline multiply in the same run, the other BGV ops'
     times, the profiler's kernels per call, and estimate_noise_budget /
     exact_noise_budget of a fresh ciphertext and a product in both
     schemes;
 13. bootstrap: the bootstrapping pipeline through the facade at the JAX
     bench's g_bootstrap configuration, n = 1024, log_q = 120 (k = 4),
     lambda_ = 0, h = 16, seed 5: make_bootstrap_key at levels 0 and 1,
     bootstrap_binary of the bits 0 and 1 and of a level-1 input (each
     decodes its bit), bootstrap_lut [0, 1, 4, 4] of m = 0..3 (decodes
     lut[m]) and bootstrap_binary_batch of 8 bits i % 2 (decodes them, and
     elements 0 and 1 equal bootstrap_binary bit for bit).  One
     bootstrap_binary launches keyswitch_fused 2n + 1 times (two external
     products per secret coefficient, then the final key switch) and the
     batch keyswitch_fused_batch 2n times and keyswitch_fused once per
     element; B1, B2, B3 and B8 launch for keys, inputs and decrypts, and no
     other kernel.  Card == CPU plain path: the whole pipeline at n = 256
     (tests/test_bootstrap.py's configuration: extract_payload,
     make_bootstrap_key_from_noise, bootstrap_binary), and at n = 1024 one
     CMUX gate as the rotation calls it (bootstrap._cmux) and the external
     product in it (one keyswitch_fused launch each; batched, one
     keyswitch_fused_batch launch) and the first 16 steps of blind_rotate
     on a truncated key.  B7 and B12 at the external products' shapes
     against their plain versions; bootstrap_ms_n1024 and
     bootstrap_ms_n1024_b8 (per ciphertext; wall medians of 5, as
     bench.py), the time inside kernels of one call (torch.profiler), the
     device ms of a CMUX gate and of its external product, single and
     batched, make_bootstrap_key's seconds and the key's bytes, and traces:
     the kernels per CMUX gate (a 16-step rotation against a 0-step one),
     span and idle share.
Phases 4 to 13 each zero every launch count just before their path and read
them just after; each kernel of the path must have launched.  Phase 3 also
runs fast_bconv_sk_fused with the digits lane at [5,3,n], [5,24,n],
[10,3,n] and [10,24,n] (the multiply and multiply_batch at k = 3 and
k = 8), without digits, and on rows off an 8-byte boundary; the
prereduced lanes at the omega path's k = 8, kd = 4; fast_floor_fused with
the conversion to q (and digits) at n = 256, k = 5, levels 0 to 2, and its
floor lane alone at n = 8192, k = 3 and at n = 256, k = 5; tensor_product's
Lift lane (both products) at n = 256, k = 5, levels 0 to 2 (x and y as
views of one [k, 4, n] tensor at level 1), at n = 8192, k = 3 (kb = 5)
and k = 8 (kb = 10),
modmul_chain of every variant on a [256, 8192] block, and the cluster
kernels around the main path: mul_by_ntt_operand and tensor_product (and
their batch forms) at n = 256 (k = 5), 8192 and 16384, level views (level 1
of k = 3, level 2 of k = 8, the Bsk suffix at n = 256), t = 786433 tables,
B = 1, 2 and 8, mul_by_ntt_operand on strided component views with C = 1
and 2; bsk_branch_fused (single and batched) at k = 8 (kb = 10), B = 8,
level views (the Bsk suffix mid-tensor), t = 786433 tables, n = 256 (k = 5,
batched) and n = 16384, decrypt_fused at k = 8, k = 12 (more primes than a
cluster's 8 CTAs), B = 8, level views, t = 786433, n = 256 and n = 16384;
ntt_forward at n = 256, 16384, level views, keygen's [k, 3, n] and mod
t = 786433 at B = 1 and 16; and keyswitch_fused (both lanes, single and
batched) at kd = 1, 2, 3, 6 and 8 (k = 8: two digits per pair), the
prereduced kd = 4 and 3, level views, n = 256 and n = 16384, B = 1, 2, 8;
ntt_inverse at n = 32, 256, 16384, level views, keygen's [k, 3, n], the
key down-switch's [8, 12, n] rows, mod t = 786433 at B = 1 and 16 and rows
off a 16-byte boundary; and ks_inner_batch / ks_inner_grouped at kd = 1,
3, 4 and 8, shared and per-element digit stacks, C x E = 4 x 8, level
views, n = 256, 1024 and 16384 and rows off a 16-byte boundary; the Galois
lanes of keyswitch_fused (B = 1 and 8, g = 3 and 2n - 1, level views,
n = 256 and 16384) and of ks_inner_batch / ks_inner_grouped (E = 8, C x E =
4 x 8), each also at level views, n = 256, 1024, 16384 and 32768 and rows
off a 16-byte boundary, with a run of zeros in c0 and the digits; a
sum_slots stage's B17 and B15 (E = 3, and at k8_omega's k = 8, kd = 4).
The line before the last is {"kernels": [...]}, each kernel with its launches
on its own path (phase 4 to 11), on the bgv path (bgv_launches) and on the
bootstrap path (bootstrap_launches); the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero; without
a card the script exits 1 before printing any result.  Imports no JAX and
nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from fhe_tpu_torch import FHE, primes
from fhe_tpu_torch.ops import _build, decrypt_cuda, galois_cuda, ntt_cuda, rns_cuda
from fhe_tpu_torch.ops import galois as plain_galois
from fhe_tpu_torch.ops import ntt as plain_ntt
from fhe_tpu_torch.ops import rns, sampling
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv, bgv
from fhe_tpu_torch.scheme import bootstrap
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.types import (BootstrapKey, GaloisKeys, LWECiphertext, Plaintext,
                                        PublicKey, RelinKeys, SecretKey)
from fhe_tpu_torch.utils import ubench

N, LOG_Q, H = 8192, 90, 64
BATCH = 8           # the serving batch (bench.py mul_b8 / rot_b8 / enc_b8 / dec_b8)
C_HOIST = 4         # ciphertexts of the hoisted batch (bench.py rot_hoist_k8_b4)
REPS = 25

# Published H100 SXM peaks (NVIDIA data sheet) at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer issue rate of one pipe: 64 lanes per SM (half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s), 132 SMs, 1.98 GHz boost clock.
# Integer multiplies issue on the FMA pipe and adds, logic, shifts and
# selects on the INT32 pipe, 64 lanes each, and a stream that mixes them
# uses both in one cycle: the roofline phase measures one pipe's rate with
# mul17 (16.6 T multiplies/s) and an exact Shoup chain above it.  The bounds
# divide operations by the two pipes' rate.
INT32_PIPE_OPS_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 2 * INT32_PIPE_OPS_PER_S


def helper_ops() -> dict[str, int]:
    """32-bit integer instructions per call of each modular helper, from the
    "OPS <helper> <count>" block beside the helpers in csrc/modmath.cuh."""
    text = (_build.CSRC / "modmath.cuh").read_text()
    ops = {m[1]: int(m[2]) for m in re.finditer(r"^//\s+OPS (\w+) (\d+)$", text, re.M)}
    want = {"add_mod", "sub_mod", "mul_shoup", "mul_shoup_lazy", "reduce_shoup",
            "mul_barrett", "reduce_barrett", "neg_mod", "reduce_wide", "mac_wide", "select",
            "lane16", "mul16", "galois_index", "galois_ntt_index", "ntt_butterfly"}
    if set(ops) != want:
        raise RuntimeError(f"modmath.cuh OPS block lists {sorted(ops)}, expected "
                           f"{sorted(want)}")
    return ops


OPS = helper_ops()
OPS_BUTTERFLY = OPS["ntt_butterfly"]
if OPS_BUTTERFLY != OPS["mul_shoup"] + OPS["add_mod"] + OPS["sub_mod"]:
    raise RuntimeError("modmath.cuh: OPS ntt_butterfly is not mul_shoup + add_mod + sub_mod")
# integer instructions of one step of each modmul_chain variant: the helpers'
# OPS counts, and 17 for the two calibration chains (csrc/ubench.cu)
CHAIN_OPS = {"exact": OPS["mul_shoup"], "lazy": OPS["mul_shoup_lazy"],
             "barrett": OPS["mul_barrett"], "cheap17": 17, "mul17": 17}

# path: the phase whose run gives the kernel's launches in the kernels line
KERNELS = {
    "ntt_forward": dict(fn=ntt_cuda.ntt_forward, source="fhe_tpu_torch/csrc/ntt.cu",
                        replaces="fhe_tpu/ops/ntt_pallas.py:444", path="slice"),
    "ntt_inverse": dict(fn=ntt_cuda.ntt_inverse, source="fhe_tpu_torch/csrc/ntt.cu",
                        replaces="fhe_tpu/ops/ntt_pallas.py:493", path="slice"),
    "mul_by_ntt_operand": dict(fn=ntt_cuda.mul_by_ntt_operand,
                               source="fhe_tpu_torch/csrc/ntt.cu",
                               replaces="fhe_tpu/ops/ntt_pallas.py:576", path="slice"),
    "decrypt_fused": dict(fn=decrypt_cuda.decrypt_fused,
                          source="fhe_tpu_torch/csrc/decrypt.cu",
                          replaces="fhe_tpu/ops/decrypt_pallas.py:126", path="slice"),
    "tensor_product": dict(fn=ntt_cuda.tensor_product,
                           source="fhe_tpu_torch/csrc/ntt.cu",
                           replaces="fhe_tpu/ops/ntt_pallas.py:879", path="multiply"),
    "bsk_branch_fused": dict(fn=rns_cuda.bsk_branch_fused,
                             source="fhe_tpu_torch/csrc/rns.cu",
                             replaces="fhe_tpu/ops/rns_pallas.py:257", path="multiply"),
    "fast_bconv_sk_fused": dict(fn=rns_cuda.fast_bconv_sk_fused,
                                source="fhe_tpu_torch/csrc/rns.cu",
                                replaces="fhe_tpu/ops/rns_pallas.py:310", path="multiply"),
    "keyswitch_fused": dict(fn=ntt_cuda.keyswitch_fused,
                            source="fhe_tpu_torch/csrc/ntt.cu",
                            replaces="fhe_tpu/ops/ntt_pallas.py:751", path="multiply"),
    "mul_by_ntt_operand_batch": dict(fn=ntt_cuda.mul_by_ntt_operand_batch,
                                     source="fhe_tpu_torch/csrc/ntt.cu",
                                     replaces="fhe_tpu/ops/ntt_pallas.py:655",
                                     path="serving"),
    "tensor_product_batch": dict(fn=ntt_cuda.tensor_product_batch,
                                 source="fhe_tpu_torch/csrc/ntt.cu",
                                 replaces="fhe_tpu/ops/ntt_pallas.py:973", path="serving"),
    "keyswitch_fused_batch": dict(fn=ntt_cuda.keyswitch_fused_batch,
                                  source="fhe_tpu_torch/csrc/ntt.cu",
                                  replaces="fhe_tpu/ops/ntt_pallas.py:1269",
                                  path="serving"),
    # B5 with its batch grid axis (the JAX multiply_batch has no fused Bsk branch)
    "bsk_branch_fused_batch": dict(fn=rns_cuda.bsk_branch_fused_batch,
                                   source="fhe_tpu_torch/csrc/rns.cu",
                                   replaces="fhe_tpu/ops/rns_pallas.py:257",
                                   path="serving"),
    # the Galois lanes of B7 and B12 (a rotation at ks_omega = 1 in one launch:
    # B16, and B14 without c0, folded into the key switch)
    "keyswitch_fused_galois": dict(fn=ntt_cuda.keyswitch_fused, counter="galois_launches",
                                   source="fhe_tpu_torch/csrc/ntt.cu",
                                   replaces="fhe_tpu/ops/galois_pallas.py:272",
                                   path="serving"),
    "keyswitch_fused_batch_galois": dict(fn=ntt_cuda.keyswitch_fused_batch,
                                         counter="galois_launches",
                                         source="fhe_tpu_torch/csrc/ntt.cu",
                                         replaces="fhe_tpu/ops/galois_pallas.py:162",
                                         path="serving"),
    # B17's Inner lane and B15: each sum_slots stage; B17 and B18 with B14's
    # shared-c0 and per-element-c0 lanes folded in (the hoisted rotations'
    # Galois lanes)
    "ks_inner_batch": dict(fn=ntt_cuda.ks_inner_batch, source="fhe_tpu_torch/csrc/ntt.cu",
                           replaces="fhe_tpu/ops/ntt_pallas.py:1161", path="hoisted"),
    "automorphism_fused_sum": dict(fn=galois_cuda.automorphism_fused_sum,
                                   source="fhe_tpu_torch/csrc/galois.cu",
                                   replaces="fhe_tpu/ops/galois_pallas.py:228",
                                   path="hoisted"),
    "ks_inner_batch_galois": dict(fn=ntt_cuda.ks_inner_batch, counter="galois_launches",
                                  source="fhe_tpu_torch/csrc/ntt.cu",
                                  replaces="fhe_tpu/ops/galois_pallas.py:162", path="hoisted"),
    "ks_inner_grouped_galois": dict(fn=ntt_cuda.ks_inner_grouped, counter="galois_launches",
                                    source="fhe_tpu_torch/csrc/ntt.cu",
                                    replaces="fhe_tpu/ops/ntt_pallas.py:1100",
                                    path="hoisted"),
    # B14 and B16 as launches of their own: the rotations at ks_omega = 2 (and
    # the Galois key generator on every path)
    "automorphism_fused": dict(fn=galois_cuda.automorphism_fused,
                               source="fhe_tpu_torch/csrc/galois.cu",
                               replaces="fhe_tpu/ops/galois_pallas.py:162", path="omega"),
    "automorphism_single": dict(fn=galois_cuda.automorphism_single,
                                source="fhe_tpu_torch/csrc/galois.cu",
                                replaces="fhe_tpu/ops/galois_pallas.py:272", path="omega"),
    # the prereduced lanes of B7 and B12 (grouped gadget digits, ks_omega > 1),
    # counted apart from the classic lanes
    "keyswitch_fused_prereduced": dict(fn=ntt_cuda.keyswitch_fused,
                                       counter="prereduced_launches",
                                       source="fhe_tpu_torch/csrc/ntt.cu",
                                       replaces="fhe_tpu/ops/ntt_pallas.py:751",
                                       path="omega"),
    "keyswitch_fused_batch_prereduced": dict(fn=ntt_cuda.keyswitch_fused_batch,
                                             counter="prereduced_launches",
                                             source="fhe_tpu_torch/csrc/ntt.cu",
                                             replaces="fhe_tpu/ops/ntt_pallas.py:1269",
                                             path="omega"),
    # B9 as tensor_product's Lift lane: the n < 1024 multiply's products in q
    # and, with the lift q -> Bsk, in Bsk in one launch
    "tensor_product_lift": dict(fn=ntt_cuda.tensor_product, counter="lift_launches",
                                source="fhe_tpu_torch/csrc/ntt.cu",
                                replaces="fhe_tpu/ops/rns_pallas.py:105", path="small"),
    "fast_floor_fused": dict(fn=rns_cuda.fast_floor_fused,
                             source="fhe_tpu_torch/csrc/rns.cu",
                             replaces="fhe_tpu/ops/rns_pallas.py:147", path="small"),
    "modmul_chain": dict(fn=ubench.modmul_chain, source="fhe_tpu_torch/csrc/ubench.cu",
                         replaces="fhe_tpu/utils/ubench.py:113", path="roofline"),
}

# the kernels each later path runs, besides those whose path it is
LEVELED_KERNELS = ("ntt_forward", "ntt_inverse", "mul_by_ntt_operand", "decrypt_fused",
                   "tensor_product", "bsk_branch_fused", "fast_bconv_sk_fused",
                   "keyswitch_fused", "tensor_product_batch", "keyswitch_fused_batch",
                   "bsk_branch_fused_batch", "keyswitch_fused_galois", "automorphism_single",
                   "ks_inner_batch", "automorphism_fused_sum", "ks_inner_batch_galois",
                   "ks_inner_grouped_galois")
SMALL_KERNELS = ("ntt_forward", "ntt_inverse", "mul_by_ntt_operand", "decrypt_fused",
                 "fast_bconv_sk_fused", "keyswitch_fused", "tensor_product_batch",
                 "keyswitch_fused_batch", "bsk_branch_fused_batch")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        setattr(k["fn"], k.get("counter", "launches"), 0)


def read_counts() -> dict[str, int]:
    return {name: getattr(k["fn"], k.get("counter", "launches"))
            for name, k in KERNELS.items()}


def check_launched(launches: dict[str, int], path: str, also=()) -> None:
    """Every kernel of the path, and those named in ``also``, launched at
    least once in the run."""
    for name, meta in KERNELS.items():
        if meta["path"] == path or name in also:
            check(launches[name] > 0, f"{name} was never launched on the {path} path")


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms.  Before each launch the card is kept
    busy (torch.cuda._sleep) for longer than the host takes to queue the call,
    so the events bracket device work only, not host overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host_s > 0.01:                  # a slow plain version: fewer runs
        reps = min(reps, 5)
    cycles = int(max(2 * host_s, 50e-6) * 2.0e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 10) -> float:
    """Median end-to-end time of fn() in ms as a caller sees it: CUDA events
    around the call, host work included, ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or integer operations over
    the issue rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_work(k: int, batch: int, inverse: bool, n: int = N) -> tuple[float, float]:
    """(bytes, ops) of one [k, batch, n] transform: rows in and out, one
    twiddle table and its Shoup companions per prime."""
    logn = n.bit_length() - 1
    ops = k * batch * (n // 2) * logn * OPS_BUTTERFLY
    if inverse:
        ops += k * batch * n * OPS["mul_shoup"]
    return 4 * (2 * k * batch * n + 2 * k * n), ops


def mul_work(k: int, c: int, batch: int = 1, n: int = N) -> tuple[float, float]:
    """u [k, batch, n] and the shared w [k, c, n] in, [k, c, batch, n] out,
    forward and inverse tables; per element and prime one forward sweep,
    then c products and inverse sweeps (the kernel repeats the forward sweep
    for each c: not counted)."""
    logn = n.bit_length() - 1
    nbytes = 4 * (batch * k * n + k * c * n + batch * k * c * n + 4 * k * n)
    ops = batch * k * ((n // 2) * logn * OPS_BUTTERFLY
                       + c * (n * OPS["mul_barrett"] + (n // 2) * logn * OPS_BUTTERFLY
                              + n * OPS["mul_shoup"]))
    return nbytes, ops


def decrypt_work(k: int, batch: int, n: int = N) -> tuple[float, float]:
    logn = n.bit_length() - 1
    nbytes = 4 * (2 * k * batch * n + k * n + 4 * k * n + batch * n)
    o = OPS
    # per prime: forward and inverse sweeps, the key product, the n^-1 and
    # the phase/z/t-lane/gamma-lane step (decrypt.cu); then the epilogue
    per_prime = (2 * (n // 2) * logn * OPS_BUTTERFLY
                 + n * (o["mul_barrett"] + o["mul_shoup"] + o["add_mod"]
                        + 2 * o["mul_shoup"] + o["reduce_barrett"]
                        + o["mul_barrett"] + 2 * o["add_mod"]))
    epilogue = n * (2 * o["mul_shoup"] + o["mul_barrett"] + o["reduce_shoup"]
                    + 2 * o["sub_mod"])
    return nbytes, batch * (k * per_prime + epilogue)


def sweeps_ops(fwd_rows: int, inv_rows: int, n: int = N) -> float:
    """Ops of one prime's forward and inverse sweeps over that many rows,
    with the inverse's n_inv multiply."""
    logn = n.bit_length() - 1
    return ((fwd_rows + inv_rows) * (n // 2) * logn * OPS_BUTTERFLY
            + inv_rows * n * OPS["mul_shoup"])


def product_ops(n: int = N) -> float:
    """c0, c1, c2 from the four NTT rows: 4 Barrett products and an add."""
    return n * (4 * OPS["mul_barrett"] + OPS["add_mod"])


def tensor_product_work(k: int, batch: int = 1, n: int = N) -> tuple[float, float]:
    """x, y [k, 2, batch, n] in, [k, 3, batch, n] out, forward and inverse
    tables."""
    nbytes = 4 * (batch * (4 * k * n + 3 * k * n) + 4 * k * n)
    return nbytes, batch * k * (sweeps_ops(4, 3, n) + product_ops(n))


def lift_ops(k: int, cols: int) -> float:
    """The SmMRq lift of cols coefficients from k q primes into one Bsk
    prime, its k source digits aside (they do not depend on the Bsk prime):
    per output each digit's conversion and m~ lane step, the lane's close,
    the centred correction and the m~^-1 scale."""
    o = OPS
    return cols * (k * (o["mul_shoup"] + o["add_mod"] + o["lane16"])
                   + o["mul16"] + o["select"] + 2 * o["mul_shoup"] + o["sub_mod"])


def bsk_branch_work(k: int, kb: int, batch: int = 1, n: int = N) -> tuple[float, float]:
    """ab [k, 4, batch, N] and tx_q [k, 3, batch, N] in, [kb, 3, batch, N]
    out, Bsk tables.  The k source digits of the lift's 4N and the floor's
    3N coefficients do not depend on the Bsk prime, so they count once (the
    kernel forms them again in each block).  Per Bsk prime: the lift, the
    sweeps and product, and the floor; all of it once per element."""
    o = OPS
    digits = (4 + 3) * n * k * o["mul_shoup"]
    lift = lift_ops(k, 4 * n)
    floor = 3 * n * (k * (o["mul_shoup"] + o["add_mod"])
                     + o["sub_mod"] + o["mul_shoup"])
    nbytes = 4 * (batch * (4 * k * n + 3 * k * n + 3 * kb * n) + 4 * kb * n)
    return nbytes, batch * (digits + kb * (lift + sweeps_ops(4, 3, n) + product_ops(n)
                                           + floor))


def sk_ops(kb: int, k: int, m: int) -> float:
    """Integer ops of the Shenoy-Kumaresan conversion of m coefficients from
    kb Bsk primes to k q primes: each aux digit once; per coefficient the
    m_sk sum (an unreduced 64-bit sum, one multiply-add a digit, and its
    reduction) and alpha; per output the same sum into q_j and the centred
    correction."""
    o = OPS
    l = kb - 1
    conv = l * o["mac_wide"] + o["reduce_wide"]
    return (l * m * o["mul_shoup"]
            + m * (conv + o["sub_mod"] + o["mul_shoup"])
            + k * m * (conv + o["select"] + o["mul_shoup"] + o["sub_mod"]))


def fast_bconv_sk_work(kb: int, k: int, rows: int, n: int = N,
                       digits: bool = False) -> tuple[float, float]:
    """[kb, rows, n] in, [k, rows, n] out, and with the digits lane the
    [k, rows / 3, n] digits of the c2 rows out, one Shoup product each."""
    m = rows * n
    dig = k * m // 3 if digits else 0
    return 4 * (kb * m + k * m + dig), sk_ops(kb, k, m) + dig * OPS["mul_shoup"]


def keyswitch_work(k: int, kd: int, batch: int = 1, prereduced: bool = False,
                   n: int = N) -> tuple[float, float]:
    """d [kd, batch, n] (prereduced: [k, kd, batch, n]) and the shared keys
    [k, kd, 2, n] in, [k, 2, batch, n] out, q tables.  Per element and
    prime: kd reductions (none when prereduced) and forward sweeps, 2 kd key
    products and sums, and a 2-row inverse sweep."""
    o = OPS
    per_prime = ((0 if prereduced else kd * n * o["reduce_barrett"]) + sweeps_ops(kd, 2, n)
                 + 2 * kd * n * (o["mul_barrett"] + o["add_mod"]))
    digits = (k if prereduced else 1) * kd * n
    nbytes = 4 * (batch * (digits + 2 * k * n) + 2 * k * kd * n + 4 * k * n)
    return nbytes, batch * k * per_prime


def ks_inner_work(k: int, kd: int, stacks: int, key_sets: int,
                  batch: int, n: int = N) -> tuple[float, float]:
    """dg [k, kd, stacks, n] and keys [k, kd, key_sets, 2, n] in,
    [k, 2, batch, n] out, inverse tables.  Per element and prime: 2 kd key
    products and sums and a 2-row inverse sweep (the kernel reads the
    digits once per output row: counted once)."""
    o = OPS
    nbytes = 4 * (k * kd * stacks * n + 2 * k * kd * key_sets * n + 2 * k * batch * n
                  + 2 * k * n)
    ops = batch * k * (2 * kd * n * (o["mul_barrett"] + o["add_mod"]) + sweeps_ops(0, 2, n))
    return nbytes, ops


def automorphism_work(k: int, c: int, hs: tuple[int, ...],
                      c0_rows: int) -> tuple[float, float]:
    """x [k, c, B, N] in and out, the B multipliers, and c0_rows [k, N] rows
    of c0 (0, 1 shared, or B per element).  Per output residue its source
    index; the negation where these h negate (h*j mod 2N >= N, counted from
    hs); one add per component-0 residue when there is a c0."""
    o = OPS
    j = torch.arange(N, dtype=torch.int64)
    negated = sum(int(((h * j) % (2 * N) >= N).sum()) for h in hs)
    batch = len(hs)
    ops = (k * c * batch * N * o["galois_index"] + k * c * negated * o["neg_mod"]
           + (k * batch * N * o["add_mod"] if c0_rows else 0))
    return 4 * (2 * k * c * batch * N + c0_rows * k * N + batch), ops


def coeff_gather_ops(k: int, hs: tuple[int, ...], n: int = N) -> float:
    """Gathering phi(c0) into k rows for each multiplier of hs and adding it:
    per residue its source index and the add, and the negation where these
    h negate (h*j mod 2n >= n, counted from hs)."""
    o = OPS
    j = torch.arange(n, dtype=torch.int64)
    negated = sum(int(((h * j) % (2 * n) >= n).sum()) for h in hs)
    return k * (len(hs) * n * (o["galois_index"] + o["add_mod"]) + negated * o["neg_mod"])


def ks_inner_galois_work(k: int, kd: int, stacks: int, key_sets: int, outputs: tuple,
                         c0_rows: int, n: int = N) -> tuple[float, float]:
    """The Galois lane of ks_inner: dg [k, kd, stacks, n], pre-permuted keys
    [k, kd, key_sets, 2, n] and c0_rows [k, n] rows in, [k, 2, B, n] out
    (``outputs``: the Galois element of each of the B), inverse tables.  Per
    element, prime and output row: kd products and sums, the in-block
    source and the add of the permuted sum per position, and a 2-row
    inverse sweep per element and prime; phi(c0) gathered into row 0."""
    o = OPS
    batch = len(outputs)
    hs = tuple(pow(g, -1, 2 * n) for g in outputs)
    per_row = n * (kd * (o["mul_barrett"] + o["add_mod"]) + o["galois_ntt_index"]
                   + o["add_mod"])
    ops = batch * k * (2 * per_row + sweeps_ops(0, 2, n)) + coeff_gather_ops(k, hs, n)
    nbytes = 4 * (k * kd * stacks * n + 2 * k * kd * key_sets * n + c0_rows * k * n
                  + 2 * k * batch * n + 2 * k * n)
    return nbytes, ops


def automorphism_sum_work(k: int, c: int, hs: tuple[int, ...]) -> tuple[float, float]:
    """x [k, c, B, N], c0 [k, N] and base [k, c, N] in, [k, c, N] out, the B
    multipliers.  Per source residue its index, the c0 add on component 0,
    the negation where these h negate, and the accumulating add."""
    o = OPS
    j = torch.arange(N, dtype=torch.int64)
    negated = sum(int(((h * j) % (2 * N) >= N).sum()) for h in hs)
    batch = len(hs)
    ops = (k * c * batch * N * (o["galois_index"] + o["add_mod"])
           + k * c * negated * o["neg_mod"] + k * batch * N * o["add_mod"])
    return 4 * (k * c * batch * N + k * N + 2 * k * c * N + batch), ops


def keyswitch_galois_work(k: int, g: int, batch: int = 1,
                          n: int = N) -> tuple[float, float]:
    """keyswitch_fused's Galois lane (kd = k): keyswitch_work's bytes and
    operations, c0 [k, B, n] in, and per element and prime the source index
    of every digit word it gathers, with the negation mod q_j where g
    negates, and phi(c0) gathered into row 0."""
    o = OPS
    nbytes, ops = keyswitch_work(k, k, batch, n=n)
    h = pow(g, -1, 2 * n)
    j = torch.arange(n, dtype=torch.int64)
    negated = int(((h * j) % (2 * n) >= n).sum())
    digit_ops = k * (n * o["galois_index"] + negated * o["neg_mod"])
    ops += batch * k * digit_ops + batch * coeff_gather_ops(k, (h,), n)
    return nbytes + 4 * k * batch * n, ops


def quiet_params(n: int, log_q: int, **kw):
    """Parameters the JAX bench runs below 128-bit security at this n (its
    warning silenced, as there)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q,
                                                 hamming_weight=H, **kw))


def params_k8():
    """The JAX bench's k8_omega configuration (bench.py:727-775): n = 8192,
    log_q = 218 (k = 8), h = 64, ks_omega = 2."""
    return quiet_params(N, 218, ks_omega=2)


def params_leveled():
    """The JAX bench's k8 configuration (bench.py:668-726): n = 8192,
    log_q = 218 (k = 8), h = 64, ks_omega = 1."""
    return quiet_params(N, 218)


def params_small():
    """The JAX tests' leveled configuration (tests/test_leveled.py):
    n = 256, log_q = 150 (k = 5), h = 32."""
    return make_scheme_params(SecurityParams(poly_degree=256, log_q=150,
                                             hamming_weight=32))


def chain_input(gen: torch.Generator, ctx) -> tuple[torch.Tensor, tuple]:
    """The JAX bench's roofline input: a [256, 8192] block below the first q
    prime p, and (w, w_sh, p, mu) with w = psi_br[0, 1]."""
    p = ctx.ntt_q.primes[0]
    w = int(ctx.ntt_q.psi_br[0, 1])
    x = residues(gen, (p,), 256)[0]
    return x, (w, (w << 32) // p, p, (1 << 61) // p)


def tensor_product_lift_work(k: int, kb: int, n: int = N) -> tuple[float, float]:
    """tensor_product's Lift lane: x, y [k, 2, n] in q in, [k + kb, 3, n]
    out, the q and Bsk tables; the q side's sweeps and product, and on the
    Bsk side the k source digits of the 4n coefficients once (the kernel
    forms them again for each Bsk prime) and per Bsk prime the lift, the
    sweeps and the product."""
    ops = (k * (sweeps_ops(4, 3, n) + product_ops(n)) + 4 * n * k * OPS["mul_shoup"]
           + kb * (lift_ops(k, 4 * n) + sweeps_ops(4, 3, n) + product_ops(n)))
    return 4 * (4 * k * n + 3 * (k + kb) * n + 4 * (k + kb) * n), ops


def floor_ops(k: int, kb: int, cols: int) -> float:
    """FastFloor of cols coefficients into kb primes: the k digits once; per
    output the conversion (an unreduced 64-bit sum and its reduction), the
    subtraction and the q^-1 scale."""
    o = OPS
    per_out = k * o["mac_wide"] + o["reduce_wide"] + o["sub_mod"] + o["mul_shoup"]
    return cols * k * o["mul_shoup"] + kb * cols * per_out


def fast_floor_work(k: int, kb: int, cols: int) -> tuple[float, float]:
    """tx_q [k, cols] and tx_bsk [kb, cols] in, [kb, cols] out."""
    return 4 * (k + 2 * kb) * cols, floor_ops(k, kb, cols)


def fast_floor_sk_work(k: int, kb: int, cols: int, digits: bool) -> tuple[float, float]:
    """The FloorSK lane: tx_q [k, cols] and tx_bsk [kb, cols] in, [k, cols]
    out (and the digits of the c2 third); the floor, then the conversion
    to q of the floored residues, which never leave registers."""
    dig = k * cols // 3 if digits else 0
    return (4 * ((k + kb) * cols + k * cols + dig),
            floor_ops(k, kb, cols) + sk_ops(kb, k, cols) + dig * OPS["mul_shoup"])


def chain_work(elems: int, reps: int, variant: str, ilp: int = 1) -> tuple[float, float]:
    """x in and out; reps steps of each of ilp chains per element, and the
    seeds and the XOR fold of ilp > 1."""
    return 8 * elems, elems * (reps * ilp * CHAIN_OPS[variant] + 2 * (ilp - 1))


def residues(gen: torch.Generator, moduli, rows: int, n: int | None = None) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(p), (rows, n or N), generator=gen,
                                      device="cuda", dtype=torch.int64)
                        for p in moduli]).to(torch.int32)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0]


def phase_device() -> None:
    print(card_name())
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    info = {"device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "nvcc": nvcc.strip().splitlines()[-1]}
    print("phase device", json.dumps(info))


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_all()
    dt = time.perf_counter() - t0
    out = _build.build_dir()
    usage = []
    for log in sorted(out.glob("*.log")):
        usage += [f"{log.stem}: {line.strip()}" for line in log.read_text().splitlines()
                  if "registers" in line or "spill" in line]
    print("phase build", json.dumps({"seconds": dt, "dir": out.name}))
    for line in usage:
        print("  ptxas", line)


def flat(x) -> torch.Tensor:
    """A kernel's result, or its tuple of results, as one flat tensor."""
    return torch.cat([t.flatten() for t in x]) if isinstance(x, tuple) else x.flatten()


def digit_consts(ctx, level: int = 0) -> tuple:
    return ctx.inv_qhat_levels[level], ctx.inv_qhat_shoup_levels[level]


def conv_cases(gen: torch.Generator, ctx) -> list:
    """fast_bconv_sk_fused (B6) at the four shapes its paths give it, with
    the digits lane as the multiplies call it: [5,3,n] the headline
    multiply, [5,24,n] its multiply_batch at B = 8, [10,3,n] the k8 and
    k8_omega multiply, [10,24,n] their batch; then without digits, and on
    rows that start off an 8-byte boundary (read a word at a time)."""
    ctx8 = make_context(params_leveled(), device="cuda")
    out = []
    for c, rows in ((ctx, 3), (ctx, 3 * BATCH), (ctx8, 3), (ctx8, 3 * BATCH)):
        kb, k = c.mul_tables[1].k, c.k
        xb = residues(gen, c.params.bsk_primes, rows)
        out.append(("fast_bconv_sk_fused", f"digits [{kb},{rows},{N}] -> [{k},{rows},{N}]",
                    lambda x=xb, c=c: rns_cuda.fast_bconv_sk_fused(x, c.sk_c, digit_consts(c)),
                    lambda x=xb, c=c: rns.fast_bconv_sk_digits(x, c.sk_c, c.inv_qhat),
                    fast_bconv_sk_work(kb, k, rows, digits=True)))
    kb, k = ctx.mul_tables[1].k, ctx.k
    xb = residues(gen, ctx.params.bsk_primes, 3)
    out.append(("fast_bconv_sk_fused", f"[{kb},3,{N}] -> [{k},3,{N}]",
                lambda: rns_cuda.fast_bconv_sk_fused(xb, ctx.sk_c),
                lambda: rns.fast_bconv_sk(xb, ctx.sk_c), fast_bconv_sk_work(kb, k, 3)))
    odd = offset_copy(residues(gen, ctx.params.bsk_primes, 3 * BATCH))
    out.append(("fast_bconv_sk_fused", f"digits, rows off 8 bytes [{kb},{3 * BATCH},{N}]",
                lambda: rns_cuda.fast_bconv_sk_fused(odd, ctx.sk_c, digit_consts(ctx)),
                lambda: rns.fast_bconv_sk_digits(odd, ctx.sk_c, ctx.inv_qhat),
                fast_bconv_sk_work(kb, k, 3 * BATCH, digits=True)))
    return out


def lift_cases(gen: torch.Generator, ctx_s, ctx) -> list:
    """tensor_product's Lift lane (B9 folded into B4: the products in q and
    of the lifts in Bsk, one launch) at the n = 256, k = 5 multiply's
    shapes, levels 0, 1 and 2 (level 1: x and y as views of one [k, 4, n]
    tensor, read in place), then at the headline [3, 2, 8192] (kb = 5) and
    at k = 8 (kb = 10)."""
    out = []
    ctx8 = make_context(params_leveled(), device="cuda")
    shapes = [(ctx_s, level) for level in (0, 1, 2)] + [(ctx, 0), (ctx8, 0)]
    for c, level in shapes:
        n, (tq, tbsk), sc = c.n, c.mul_levels[level], c.smq_levels[level]
        k, kb = tq.k, tbsk.k
        if c is ctx_s and level == 1:
            xy = residues(gen, tq.primes, 4, n)
            x, y, what = xy[:, :2], xy[:, 2:], f"views of [{k},4,{n}]"
        else:
            x, y = residues(gen, tq.primes, 2, n), residues(gen, tq.primes, 2, n)
            what = f"x, y [{k},2,{n}]"
        label = f"level {level} of k={c.k}: " if c is ctx_s else ""
        args = (x, y, tq, sc, tbsk)
        out.append(("tensor_product_lift", f"{label}{what} -> [{k},3,{n}] + [{kb},3,{n}]",
                    lambda a=args: ntt_cuda.tensor_product(*a[:3], lift=a[3:]),
                    lambda a=args: (plain_ntt.tensor_product(*a[:3]),
                                    rns.tensor_product_lift(a[0], a[1], *a[3:])),
                    tensor_product_lift_work(k, kb, n)))
    return out


def floor_sk_cases(gen: torch.Generator, ctx_s) -> list:
    """fast_floor_fused with the SK lane and digits (B10 and B6 in one
    launch) at the n = 256, k = 5 multiply's shapes, levels 0, 1 and 2, and
    without digits at level 1."""
    out = []
    n = ctx_s.n
    for level, digits in ((0, True), (1, True), (2, True), (1, False)):
        qs, bsk = ctx_s.ntt_q.primes[:ctx_s.k - level], ctx_s.mul_levels[level][1].primes
        tx_q, tx_b = residues(gen, qs, 3, n), residues(gen, bsk, 3, n)
        fc, sk = ctx_s.floor_levels[level], ctx_s.sk_levels[level]
        dig = digit_consts(ctx_s, level) if digits else None
        out.append(("fast_floor_fused",
                    f"floor+SK{' + digits' if digits else ''}, level {level} of k=5: "
                    f"[{len(qs)},3,{n}] + [{len(bsk)},3,{n}] -> [{len(qs)},3,{n}]",
                    lambda a=tx_q, b=tx_b, f=fc, s=sk, d=dig:
                    rns_cuda.fast_floor_fused(a, b, f, s, d),
                    lambda a=tx_q, b=tx_b, f=fc, s=sk, d=dig:
                    rns.fast_floor_sk(a, b, f, s, None if d is None else d[0]),
                    fast_floor_sk_work(len(qs), len(bsk), 3 * n, digits)))
    return out


def device_kernels(fn) -> list[tuple]:
    """(start, end, name) of the device kernels one call of fn() launches,
    in order, from a torch.profiler trace after a warm-up call (copies and
    fills excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))


def profiled_kernels(fn) -> list[str]:
    """The names of the device kernels one call of fn() launches."""
    return [name for _, _, name in device_kernels(fn)]


def print_profiled(phase: str, ops: dict) -> None:
    """Each op's device kernels per call (torch.profiler), and the first
    op's kernel names."""
    names = {op: profiled_kernels(fn) for op, fn in ops.items()}
    print(f"phase {phase} profiler kernels_per_call",
          json.dumps({op: len(v) for op, v in names.items()}))
    first = next(iter(names))
    print(f"phase {phase} profiler {first} kernels",
          json.dumps([name[:48] for name in names[first]]))


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version on the same inputs, on the card."""
    prm = make_scheme_params(SecurityParams(poly_degree=N, log_q=LOG_Q,
                                            hamming_weight=H))
    qs, k = prm.q_primes, prm.k
    tb = plain_ntt.build_tables(N, qs, "cuda")
    cases = []   # (kernel, shape label, kernel call, plain call, (bytes, ops))
    for batch in (1, 16):
        x = residues(gen, qs, batch)
        cases.append(("ntt_forward", f"[{k},{batch},{N}]",
                      lambda x=x: ntt_cuda.ntt_forward(x, tb),
                      lambda x=x: plain_ntt.ntt_forward(x, tb),
                      ntt_work(k, batch, False)))
        cases.append(("ntt_inverse", f"[{k},{batch},{N}]",
                      lambda x=x: ntt_cuda.ntt_inverse(x, tb),
                      lambda x=x: plain_ntt.ntt_inverse(x, tb),
                      ntt_work(k, batch, True)))
    tt = plain_ntt.build_tables(N, (prm.t,), "cuda")
    xt = residues(gen, (prm.t,), 1)
    cases.append(("ntt_forward", f"t [1,1,{N}]", lambda: ntt_cuda.ntt_forward(xt, tt),
                  lambda: plain_ntt.ntt_forward(xt, tt), ntt_work(1, 1, False)))
    cases.append(("ntt_inverse", f"t [1,1,{N}]", lambda: ntt_cuda.ntt_inverse(xt, tt),
                  lambda: plain_ntt.ntt_inverse(xt, tt), ntt_work(1, 1, True)))
    u, w = residues(gen, qs, 1), residues(gen, qs, 2)
    cases.append(("mul_by_ntt_operand", f"u [{k},1,{N}] w [{k},2,{N}]",
                  lambda: ntt_cuda.mul_by_ntt_operand(u, w, tb),
                  lambda: plain_ntt.mul_by_ntt_operand(u, w, tb), mul_work(k, 2)))
    s = residues(gen, qs, 1)
    for t in (65537, 786433):
        dc = rns.make_decrypt(qs, t, prm.gamma, "cuda")
        # the main path's inputs first: both components as views of one
        # [k, 2, n] ciphertext, read in place
        ct = residues(gen, qs, 2)
        args = (ct[:, 0:1], ct[:, 1:2], s, tb, dc)
        cases.append(("decrypt_fused", f"t={t} views of [{k},2,{N}]",
                      lambda a=args: decrypt_cuda.decrypt_fused(*a),
                      lambda a=args: decrypt_cuda.decrypt_fused_plain(*a),
                      decrypt_work(k, 1)))
        for batch in (1, 8):
            c0, c1 = residues(gen, qs, batch), residues(gen, qs, batch)
            args = (c0, c1, s, tb, dc)
            cases.append(("decrypt_fused", f"t={t} [{k},{batch},{N}]",
                          lambda a=args: decrypt_cuda.decrypt_fused(*a),
                          lambda a=args: decrypt_cuda.decrypt_fused_plain(*a),
                          decrypt_work(k, batch)))
    # the multiply's kernels, on the context the facade builds
    ctx = make_context(prm, device="cuda")
    tq, tbsk = ctx.mul_tables
    kb = tbsk.k
    x, y = residues(gen, qs, 2), residues(gen, qs, 2)
    cases.append(("tensor_product", f"x, y [{k},2,{N}], t-folded q tables",
                  lambda: ntt_cuda.tensor_product(x, y, tq),
                  lambda: plain_ntt.tensor_product(x, y, tq), tensor_product_work(k)))
    ab, tx_q = residues(gen, qs, 4), residues(gen, qs, 3)
    cases.append(("bsk_branch_fused", f"ab [{k},4,{N}], tx_q [{k},3,{N}], kb={kb}",
                  lambda: rns_cuda.bsk_branch_fused(ab, tx_q, ctx.smq, ctx.floor_c, tbsk),
                  lambda: rns.bsk_branch_fused(ab, tx_q, ctx.smq, ctx.floor_c, tbsk),
                  bsk_branch_work(k, kb)))
    cases += conv_cases(gen, ctx)
    d = torch.cat([residues(gen, (q,), 1)[0] for q in qs])           # [kd, N]
    # the stored [kd, k, 2, N] key layout, read through the permuted view
    keys = torch.stack([residues(gen, qs, 2) for _ in qs])
    keys_t = keys.permute(1, 0, 2, 3)
    cases.append(("keyswitch_fused", f"d [{k},{N}], keys [{k},{k},2,{N}] (kd={k})",
                  lambda: ntt_cuda.keyswitch_fused(d, keys_t, ctx.ntt_q),
                  lambda: plain_ntt.keyswitch_fused(d, keys_t, ctx.ntt_q),
                  keyswitch_work(k, k)))
    # the serving kernels at B = 8, on the layouts the batch ops pass: views of
    # a [B, k, c, N] stack of ciphertexts
    tq = ctx.mul_tables[0]
    ab_b = residues(gen, qs, 4 * BATCH).view(k, BATCH, 4, N).transpose(0, 1)
    ab_b = ab_b.contiguous().permute(1, 2, 0, 3)                         # [k, 4, B, N]
    cases.append(("tensor_product_batch", f"views of [{BATCH},{k},4,{N}], t-folded q tables",
                  lambda: ntt_cuda.tensor_product_batch(ab_b[:, :2], ab_b[:, 2:], tq),
                  lambda: plain_ntt.tensor_product_batch(ab_b[:, :2], ab_b[:, 2:], tq),
                  tensor_product_work(k, BATCH)))
    tx_b = residues(gen, qs, 3 * BATCH).view(k, 3, BATCH, N)
    bsk_args = (ab_b, tx_b, ctx.smq, ctx.floor_c, tbsk)
    cases.append(("bsk_branch_fused_batch",
                  f"ab views of [{BATCH},{k},4,{N}], tx_q [{k},3,{BATCH},{N}], kb={kb}",
                  lambda: rns_cuda.bsk_branch_fused_batch(*bsk_args),
                  lambda: rns.bsk_branch_fused_batch(*bsk_args),
                  bsk_branch_work(k, kb, BATCH)))
    d_b = torch.stack([residues(gen, (q,), BATCH)[0] for q in qs])     # [kd, B, N]
    cases.append(("keyswitch_fused_batch",
                  f"d [{k},{BATCH},{N}], keys [{k},{k},2,{N}] (kd={k})",
                  lambda: ntt_cuda.keyswitch_fused_batch(d_b, keys_t, ctx.ntt_q),
                  lambda: plain_ntt.keyswitch_fused_batch(d_b, keys_t, ctx.ntt_q),
                  keyswitch_work(k, k, BATCH)))
    u_b = residues(gen, qs, BATCH)
    cases.append(("mul_by_ntt_operand_batch", f"u [{k},{BATCH},{N}] w [{k},2,{N}]",
                  lambda: ntt_cuda.mul_by_ntt_operand_batch(u_b, w, tb),
                  lambda: plain_ntt.mul_by_ntt_operand_batch(u_b, w, tb),
                  mul_work(k, 2, BATCH)))
    # the rotations at ks_omega = 1 (phase 6): keyswitch_fused's Galois lane on
    # the digits of an un-permuted c1, c0 a view of a [B, k, 2, N] stack
    ct_g = residues(gen, qs, 2 * BATCH).view(k, BATCH, 2, N).transpose(0, 1).contiguous()
    c0_g = ct_g.permute(1, 2, 0, 3)[:, 0]                              # [k, B, N]
    for g in (3, 2 * N - 1):
        cases.append(("keyswitch_fused_galois",
                      f"d [{k},{N}], keys [{k},{k},2,{N}], c0 view of [1,{k},2,{N}], g={g}",
                      lambda g=g: ntt_cuda.keyswitch_fused(d, keys_t, ctx.ntt_q, g=g,
                                                           c0=c0_g[:, 0]),
                      lambda g=g: plain_ntt.keyswitch_fused(d, keys_t, ctx.ntt_q, g=g,
                                                            c0=c0_g[:, 0]),
                      keyswitch_galois_work(k, g)))
    cases.append(("keyswitch_fused_batch_galois",
                  f"d [{k},{BATCH},{N}], keys [{k},{k},2,{N}], c0 views of "
                  f"[{BATCH},{k},2,{N}], g=3",
                  lambda: ntt_cuda.keyswitch_fused_batch(d_b, keys_t, ctx.ntt_q, g=3, c0=c0_g),
                  lambda: plain_ntt.keyswitch_fused_batch(d_b, keys_t, ctx.ntt_q, g=3, c0=c0_g),
                  keyswitch_galois_work(k, 3, BATCH)))
    # B14 and B16 as launches of their own (the rotations at ks_omega = 2 and
    # the Galois key generator), on views of a [B, k, 2, N] stack
    x_g = residues(gen, qs, 2 * BATCH).view(k, BATCH, 2, N).transpose(0, 1)
    x_g = x_g.contiguous().permute(1, 2, 0, 3)                       # [k, 2, B, N]
    hs = (pow(3, -1, 2 * N),) * BATCH           # rotate_rows_batch by 1
    c0s = {"no c0": None, "shared c0": residues(gen, qs, 1)[:, 0],
           "per-element c0": residues(gen, qs, BATCH)}
    for lane, c0 in c0s.items():
        cases.append(("automorphism_fused",
                      f"views of [{BATCH},{k},2,{N}], g=3, {lane}",
                      lambda c0=c0: galois_cuda.automorphism_fused(x_g, hs, tb.p, c0),
                      lambda c0=c0: plain_galois.automorphism_fused(x_g, hs, tb.p, c0),
                      automorphism_work(k, 2, hs, 0 if c0 is None else c0.numel() // N // k)))
    x_s = residues(gen, qs, 2)
    cases.append(("automorphism_single", f"[{k},2,{N}], g=3",
                  lambda: galois_cuda.automorphism_single(x_s, 3, tb.p),
                  lambda: plain_galois.automorphism_single(x_s, 3, tb.p),
                  automorphism_work(k, 2, (pow(3, -1, 2 * N),), 0)))
    # the hoisted rotations (phase 7): the Galois lanes of ks_inner_batch (a
    # shared digit stack and c0 against E = 8 pre-permuted key sets) and of
    # ks_inner_grouped (C = 4 ciphertexts by E = 8 elements), their Inner
    # lanes (B17, B18) at the same shapes, then a sum_slots stage
    kd = k
    keys_e = residues(gen, qs, kd * BATCH * 2).view(k, kd, BATCH, 2, N)
    dg_1 = residues(gen, qs, kd).view(k, kd, 1, N)
    c0_1 = residues(gen, qs, 1)[:, 0]
    cases.append(("ks_inner_batch_galois",
                  f"shared dg [{k},{kd},1,{N}] and c0, keys [{k},{kd},{BATCH},2,{N}], "
                  "g=3^1..3^8",
                  lambda: ntt_cuda.ks_inner_batch(dg_1, keys_e, tb, HOIST, c0_1),
                  lambda: plain_ntt.ks_inner_batch(dg_1, keys_e, tb, HOIST, c0_1),
                  ks_inner_galois_work(k, kd, 1, BATCH, HOIST, 1)))
    dg_c = residues(gen, qs, kd * C_HOIST).view(k, kd, C_HOIST, N)
    c0_c = residues(gen, qs, C_HOIST)
    cases.append(("ks_inner_grouped_galois",
                  f"dg [{k},{kd},{C_HOIST},{N}], c0 [{k},{C_HOIST},{N}], keys "
                  f"[{k},{kd},{BATCH},2,{N}]",
                  lambda: ntt_cuda.ks_inner_grouped(dg_c, keys_e, tb, HOIST, c0_c),
                  lambda: plain_ntt.ks_inner_grouped(dg_c, keys_e, tb, HOIST, c0_c),
                  ks_inner_galois_work(k, kd, C_HOIST, BATCH, HOIST * C_HOIST, C_HOIST)))
    for label, stacks in (("shared", 1), ("per-element", BATCH)):
        dg = residues(gen, qs, kd * stacks).view(k, kd, stacks, N)
        cases.append(("ks_inner_batch",
                      f"Inner lane, {label} dg [{k},{kd},{stacks},{N}], keys "
                      f"[{k},{kd},{BATCH},2,{N}]",
                      lambda dg=dg: ntt_cuda.ks_inner_batch(dg, keys_e, tb),
                      lambda dg=dg: plain_ntt.ks_inner_batch(dg, keys_e, tb),
                      ks_inner_work(k, kd, stacks, BATCH, BATCH)))
    cases.append(("ks_inner_grouped",
                  f"Inner lane, dg [{k},{kd},{C_HOIST},{N}], keys [{k},{kd},{BATCH},2,{N}]",
                  lambda: ntt_cuda.ks_inner_grouped(dg_c, keys_e, tb),
                  lambda: plain_ntt.ks_inner_grouped(dg_c, keys_e, tb),
                  ks_inner_work(k, kd, C_HOIST, BATCH, C_HOIST * BATCH)))
    # a sum_slots stage (steps 1, 2, 3): B17's Inner lane, then B15; and at
    # k8_omega's k = 8, kd = 4; a run of x and c0 is zero
    hoist3 = HOIST[:3]
    hs3 = tuple(pow(g, -1, 2 * N) for g in hoist3)
    x_sum = residues(gen, qs, 2 * 3).view(k, 2, 3, N)
    c0_sum, base_sum = residues(gen, qs, 1)[:, 0], residues(gen, qs, 2)
    x_sum[..., :64] = 0
    c0_sum[:, :64] = 0
    cases.append(("automorphism_fused_sum", f"x [{k},2,3,{N}], c0 [{k},{N}], base [{k},2,{N}]",
                  lambda: galois_cuda.automorphism_fused_sum(x_sum, hs3, tb.p, c0_sum,
                                                             base_sum),
                  lambda: plain_galois.automorphism_fused_sum(x_sum, hs3, tb.p, c0_sum,
                                                              base_sum),
                  automorphism_sum_work(k, 2, hs3)))
    keys_3 = residues(gen, qs, kd * 3 * 2).view(k, kd, 3, 2, N)
    cases.append(("ks_inner_batch",
                  f"Inner lane, a sum_slots stage: dg [{k},{kd},1,{N}], keys [{k},{kd},3,2,{N}]",
                  lambda: ntt_cuda.ks_inner_batch(dg_1, keys_3, tb),
                  lambda: plain_ntt.ks_inner_batch(dg_1, keys_3, tb),
                  ks_inner_work(k, kd, 1, 3, 3)))
    qs8 = params_k8().q_primes
    k8, kd8 = len(qs8), 4
    tb8 = plain_ntt.build_tables(N, qs8, "cuda")
    dg8 = residues(gen, qs8, kd8).view(k8, kd8, 1, N)
    keys8_3 = residues(gen, qs8, kd8 * 3 * 2).view(k8, kd8, 3, 2, N)
    x8 = residues(gen, qs8, 2 * 3).view(k8, 2, 3, N)
    c0_8, base_8 = residues(gen, qs8, 1)[:, 0], residues(gen, qs8, 2)
    cases.append(("ks_inner_batch",
                  f"Inner lane, k8_omega: dg [{k8},{kd8},1,{N}], keys [{k8},{kd8},3,2,{N}]",
                  lambda: ntt_cuda.ks_inner_batch(dg8, keys8_3, tb8),
                  lambda: plain_ntt.ks_inner_batch(dg8, keys8_3, tb8),
                  ks_inner_work(k8, kd8, 1, 3, 3)))
    cases.append(("automorphism_fused_sum", f"k8_omega: x [{k8},2,3,{N}]",
                  lambda: galois_cuda.automorphism_fused_sum(x8, hs3, tb8.p, c0_8, base_8),
                  lambda: plain_galois.automorphism_fused_sum(x8, hs3, tb8.p, c0_8, base_8),
                  automorphism_sum_work(k8, 2, hs3)))
    # the prereduced lanes at the omega path's shapes (phase 8: k = 8, kd = 4),
    # each beside the classic lane at the same k and kd (qs8, tb8 above)
    keys8 = torch.stack([residues(gen, qs8, 2) for _ in range(kd8)]).permute(1, 0, 2, 3)
    d8 = residues(gen, qs8, kd8)                                     # [k, kd, N]
    d8_b = residues(gen, qs8, kd8 * BATCH).view(k8, kd8, BATCH, N)
    cases.append(("keyswitch_fused_prereduced", f"d [{k8},{kd8},{N}], keys [{k8},{kd8},2,{N}]",
                  lambda: ntt_cuda.keyswitch_fused(d8, keys8, tb8, prereduced=True),
                  lambda: plain_ntt.keyswitch_fused(d8, keys8, tb8, prereduced=True),
                  keyswitch_work(k8, kd8, prereduced=True)))
    cases.append(("keyswitch_fused_batch_prereduced",
                  f"d [{k8},{kd8},{BATCH},{N}], keys [{k8},{kd8},2,{N}]",
                  lambda: ntt_cuda.keyswitch_fused_batch(d8_b, keys8, tb8, prereduced=True),
                  lambda: plain_ntt.keyswitch_fused_batch(d8_b, keys8, tb8,
                                                          prereduced=True),
                  keyswitch_work(k8, kd8, BATCH, prereduced=True)))
    d8_classic = torch.cat([residues(gen, (q,), 1)[0] for q in qs8[:kd8]])   # [kd, N]
    d8_classic_b = torch.stack([residues(gen, (q,), BATCH)[0] for q in qs8[:kd8]])
    cases.append(("keyswitch_fused", f"d [{kd8},{N}], keys [{k8},{kd8},2,{N}] (k=8)",
                  lambda: ntt_cuda.keyswitch_fused(d8_classic, keys8, tb8),
                  lambda: plain_ntt.keyswitch_fused(d8_classic, keys8, tb8),
                  keyswitch_work(k8, kd8)))
    cases.append(("keyswitch_fused_batch",
                  f"d [{kd8},{BATCH},{N}], keys [{k8},{kd8},2,{N}] (k=8)",
                  lambda: ntt_cuda.keyswitch_fused_batch(d8_classic_b, keys8, tb8),
                  lambda: plain_ntt.keyswitch_fused_batch(d8_classic_b, keys8, tb8),
                  keyswitch_work(k8, kd8, BATCH)))
    # the n < 1024 multiply's products with the lift (B9 as B4's Lift
    # lane) and its floor with the conversion to q (B10 with B6, the
    # FloorSK lane): at n = 256, k = 5 with each level's constants (the
    # small path), the lane also at the headline shapes (k = 3, kb = 5) and
    # at k = 8 (kb = 10); then the floor lane alone (B10) at the headline
    # shapes
    ctx_s = make_context(params_small(), device="cuda")
    cases += lift_cases(gen, ctx_s, ctx)
    cases += floor_sk_cases(gen, ctx_s)
    tx_q = residues(gen, qs, 3)
    tx_bsk = residues(gen, prm.bsk_primes, 3)
    cases.append(("fast_floor_fused", f"floor lane [{k},3,{N}] + [{kb},3,{N}] -> [{kb},3,{N}]",
                  lambda: rns_cuda.fast_floor_fused(tx_q, tx_bsk, ctx.floor_c),
                  lambda: rns.fast_floor(tx_q, tx_bsk, ctx.floor_c),
                  fast_floor_work(k, kb, 3 * N)))
    qs_s, bsk_s = ctx_s.ntt_q.primes[:4], ctx_s.mul_levels[1][1].primes
    txq_s, txb_s = residues(gen, qs_s, 3, 256), residues(gen, bsk_s, 3, 256)
    fc_s = ctx_s.floor_levels[1]
    cases.append(("fast_floor_fused",
                  f"floor lane, level 1 of k=5: [4,3,256] -> [{len(bsk_s)},3,256]",
                  lambda: rns_cuda.fast_floor_fused(txq_s, txb_s, fc_s),
                  lambda: rns.fast_floor(txq_s, txb_s, fc_s),
                  fast_floor_work(4, len(bsk_s), 3 * 256)))
    # the cluster kernels B1, B3/B13, B4/B11, B5, B7/B12 and B8 around the
    # main path's shapes (n = 256, 16384, level views, t = 786433, batches)
    cases += cluster_cases(gen, ctx, ctx_s)
    # the modmul roofline probe (B19) on the JAX bench's [256, 8192] block
    x_m, consts = chain_input(gen, ctx)
    for variant in ubench.VARIANTS:
        cases.append(("modmul_chain", f"{variant} [256,{N}] reps=64",
                      lambda v=variant: ubench.modmul_chain(x_m, *consts, 64, v),
                      lambda v=variant: ubench.modmul_chain_plain(x_m, *consts, 64, v),
                      chain_work(x_m.numel(), 64, variant)))
    results = {}
    for name, label, kern, plain, work in cases:
        got, want = flat(kern()), flat(plain())
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        check(got.shape == want.shape and err == 0,
              f"{name} {label}: kernel differs from its plain version (max err {err})")
        ms, plain_ms = device_ms(kern), device_ms(plain)
        b_ms, b_by = bound(*work)
        row = {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        print("phase kernel", name, json.dumps(row))
        results.setdefault(name, row)          # the first shape goes in the table
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    print("phase kernels clocks:", clocks.strip())
    return results


def bsk_case(gen: torch.Generator, ctx, level: int, batch: int | None, label: str):
    """A bsk_branch_fused case on ctx's level-L constants: the single
    kernel (batch None) or the batched one on views of a [B, k, 4, n]
    stack, as multiply_batch passes them."""
    n, qs = ctx.n, ctx.ntt_q.primes[:ctx.k - level]
    k, tbsk = len(qs), ctx.mul_levels[level][1]
    consts = (ctx.smq_levels[level], ctx.floor_levels[level], tbsk)
    if batch is None:
        ab, tx_q = residues(gen, qs, 4, n), residues(gen, qs, 3, n)
        return ("bsk_branch_fused", f"{label}: ab [{k},4,{n}], kb={tbsk.k}",
                lambda: rns_cuda.bsk_branch_fused(ab, tx_q, *consts),
                lambda: rns.bsk_branch_fused(ab, tx_q, *consts),
                bsk_branch_work(k, tbsk.k, 1, n))
    ab = residues(gen, qs, 4 * batch, n).view(k, batch, 4, n).transpose(0, 1)
    ab = ab.contiguous().permute(1, 2, 0, 3)
    tx_q = residues(gen, qs, 3 * batch, n).view(k, 3, batch, n)
    return ("bsk_branch_fused_batch", f"{label}: ab views of [{batch},{k},4,{n}], kb={tbsk.k}",
            lambda: rns_cuda.bsk_branch_fused_batch(ab, tx_q, *consts),
            lambda: rns.bsk_branch_fused_batch(ab, tx_q, *consts),
            bsk_branch_work(k, tbsk.k, batch, n))


def decrypt_case(gen: torch.Generator, prm, level: int, batch: int, label: str):
    """A decrypt_fused case at prm's level-L primes (row views of the level-0
    tables), c0 and c1 as views of a [k, B, 2, n] stack."""
    n, k = prm.n, prm.k - level
    tb = plain_ntt.slice_tables(plain_ntt.build_tables(n, prm.q_primes, "cuda"), k)
    dc = rns.make_decrypt(prm.q_primes[:k], prm.t, prm.gamma, "cuda")
    ct = residues(gen, tb.primes, 2 * batch, n).view(k, batch, 2, n)
    args = (ct[:, :, 0], ct[:, :, 1], residues(gen, tb.primes, 1, n), tb, dc)
    return ("decrypt_fused", f"{label}: views of [{k},{batch},2,{n}], t={prm.t}",
            lambda: decrypt_cuda.decrypt_fused(*args),
            lambda: decrypt_cuda.decrypt_fused_plain(*args), decrypt_work(k, batch, n))


def level_tables(ctx, level: int, kind: str):
    """The level-L tables a path passes: "q" the q primes' row views (encrypt,
    decrypt), "mul" the t-folded q tables (the multiply), "bsk" the t-folded
    Bsk suffix, mid-tensor (the n < 1024 multiply)."""
    if kind == "q":
        return plain_ntt.slice_tables(ctx.ntt_q, ctx.k - level)
    return ctx.mul_levels[level][0 if kind == "mul" else 1]


def mul_case(gen: torch.Generator, ctx, level: int, kind: str, c: int, batch: int | None,
             label: str):
    """A mul_by_ntt_operand case (batch None) or a mul_by_ntt_operand_batch
    one, u read in place as one component of a [k, B, 2, n] stack (the
    decrypt of a 3-component ciphertext passes such a view)."""
    tb, n = level_tables(ctx, level, kind), ctx.n
    rows = batch or 1
    u = residues(gen, tb.primes, 2 * rows, n).view(tb.k, rows, 2, n)[:, :, 1]
    w = residues(gen, tb.primes, c, n)
    name = "mul_by_ntt_operand" if batch is None else "mul_by_ntt_operand_batch"
    return (name, f"{label}: u views of [{tb.k},{rows},2,{n}], w [{tb.k},{c},{n}]",
            lambda: getattr(ntt_cuda, name)(u, w, tb),
            lambda: getattr(plain_ntt, name)(u, w, tb), mul_work(tb.k, c, rows, n))


def product_case(gen: torch.Generator, ctx, level: int, kind: str, batch: int | None,
                 label: str):
    """A tensor_product case on two tensors (the multiply) or on the halves of
    one [k, 4, n] tensor ("bsk": the n < 1024 multiply's Bsk side), or a
    tensor_product_batch one on views of a [B, k, 4, n] stack."""
    tb, n = level_tables(ctx, level, kind), ctx.n
    if batch is None:
        if kind == "bsk":
            lift = residues(gen, tb.primes, 4, n)
            x, y, what = lift[:, :2], lift[:, 2:], f"halves of [{tb.k},4,{n}]"
        else:
            x, y = residues(gen, tb.primes, 2, n), residues(gen, tb.primes, 2, n)
            what = f"x, y [{tb.k},2,{n}]"
        return ("tensor_product", f"{label}: {what}, {kind} tables",
                lambda: ntt_cuda.tensor_product(x, y, tb),
                lambda: plain_ntt.tensor_product(x, y, tb), tensor_product_work(tb.k, 1, n))
    ab = residues(gen, tb.primes, 4 * batch, n).view(tb.k, batch, 4, n).transpose(0, 1)
    ab = ab.contiguous().permute(1, 2, 0, 3)
    return ("tensor_product_batch", f"{label}: views of [{batch},{tb.k},4,{n}], {kind} tables",
            lambda: ntt_cuda.tensor_product_batch(ab[:, :2], ab[:, 2:], tb),
            lambda: plain_ntt.tensor_product_batch(ab[:, :2], ab[:, 2:], tb),
            tensor_product_work(tb.k, batch, n))


def keyswitch_case(gen: torch.Generator, ctx, level: int, kd: int, batch: int | None,
                   prereduced: bool, label: str):
    """A keyswitch_fused case (batch None) or a keyswitch_fused_batch one on
    ctx's level-L tables (row views): keys in the stored [kd, k, 2, n] layout
    read through the prime-major view; digit j mod its own q_j ([kd, B, n]),
    or per-prime residues ([k, kd, B, n]) in the prereduced lane."""
    tb, n = level_tables(ctx, level, "q"), ctx.n
    qs, k, rows = tb.primes, tb.k, batch or 1
    keys = torch.stack([residues(gen, qs, 2, n) for _ in range(kd)]).permute(1, 0, 2, 3)
    if prereduced:
        d = residues(gen, qs, kd * rows, n).view(k, kd, rows, n)
    else:
        d = torch.stack([residues(gen, (q,), rows, n)[0] for q in qs[:kd]])
    if batch is None:
        d = d[..., 0, :]
    name = "keyswitch_fused" if batch is None else "keyswitch_fused_batch"
    lane = "_prereduced" if prereduced else ""
    return (name + lane, f"{label}: d {list(d.shape)}, keys [{k},{kd},2,{n}] (kd={kd})",
            lambda: getattr(ntt_cuda, name)(d, keys, tb, prereduced),
            lambda: getattr(plain_ntt, name)(d, keys, tb, prereduced),
            keyswitch_work(k, kd, rows, prereduced, n))


def keyswitch_galois_case(gen: torch.Generator, ctx, level: int, batch: int | None,
                          label: str, g: int = 3):
    """keyswitch_fused's Galois lane (batch None) or keyswitch_fused_batch's
    on ctx's level-L tables: classic digits of every prime, c0 a view of a
    [B, k, 2, n] stack; a run of c0 and of the digits is zero, so the
    negations meet zeros."""
    tb, n = level_tables(ctx, level, "q"), ctx.n
    qs, k, rows = tb.primes, tb.k, batch or 1
    keys = torch.stack([residues(gen, qs, 2, n) for _ in range(k)]).permute(1, 0, 2, 3)
    d = torch.stack([residues(gen, (q,), rows, n)[0] for q in qs])
    d[..., :64] = 0
    ct = residues(gen, qs, 2 * rows, n).view(k, rows, 2, n).transpose(0, 1).contiguous()
    ct[..., :64] = 0
    c0 = ct.permute(1, 2, 0, 3)[:, 0]
    if batch is None:
        d, c0 = d[:, 0], c0[:, 0]
    name = "keyswitch_fused" if batch is None else "keyswitch_fused_batch"
    return (name + "_galois", f"{label}: d {list(d.shape)}, keys [{k},{k},2,{n}], g={g}",
            lambda: getattr(ntt_cuda, name)(d, keys, tb, g=g, c0=c0),
            lambda: getattr(plain_ntt, name)(d, keys, tb, g=g, c0=c0),
            keyswitch_galois_work(k, g, rows, n))


def ntt_forward_case(gen: torch.Generator, tb, batch: int, label: str):
    """An ntt_forward case on tb (a level's row views, or a table mod t)."""
    n = tb.n
    x = residues(gen, tb.primes, batch, n)
    return ("ntt_forward", f"{label}: [{tb.k},{batch},{n}]",
            lambda: ntt_cuda.ntt_forward(x, tb), lambda: plain_ntt.ntt_forward(x, tb),
            ntt_work(tb.k, batch, False, n))


def forward_and_keyswitch_cases(gen: torch.Generator, ctx, ctx_s, ctx8, ctx16) -> list:
    """B1 and B7/B12 around the main path's shapes: B1 at n = 256 (k = 5),
    16384, level views (level 2 of n = 256, level 1 of k = 3, level 2 of
    k = 8), keygen's [k, 3, n], mod t = 786433 at B = 1 and 16; B7/B12 at
    kd = 1 (the top level), 2 and 3 (k = 3), 8 and 6 (k = 8, two digits per
    pair), the prereduced kd = 4 and 3 (k8_omega, its level 2), n = 256 at
    levels 0, 2 and 4, n = 16384, B = 1, 2 and 8."""
    tt = plain_ntt.build_tables(N, (786433,), "cuda")
    return [ntt_forward_case(gen, level_tables(ctx_s, 0, "q"), 1, "n=256, k=5"),
            ntt_forward_case(gen, level_tables(ctx_s, 2, "q"), 3, "level 2 of n=256, k=5"),
            ntt_forward_case(gen, level_tables(ctx, 0, "q"), 3, "keygen's rows"),
            ntt_forward_case(gen, level_tables(ctx, 1, "q"), 16, "level 1 of k=3"),
            ntt_forward_case(gen, level_tables(ctx8, 2, "q"), 3, "level 2 of k=8"),
            ntt_forward_case(gen, tt, 1, "t=786433"),
            ntt_forward_case(gen, tt, 16, "t=786433"),
            ntt_forward_case(gen, level_tables(ctx16, 0, "q"), 1, "n=16384"),
            ntt_forward_case(gen, level_tables(ctx16, 0, "q"), 16, "n=16384"),
            keyswitch_case(gen, ctx, 0, 3, 2, False, "k=3"),
            keyswitch_case(gen, ctx, 2, 1, None, False, "level 2 of k=3"),
            keyswitch_case(gen, ctx, 2, 1, BATCH, False, "level 2 of k=3"),
            keyswitch_case(gen, ctx, 1, 2, None, False, "level 1 of k=3"),
            keyswitch_case(gen, ctx8, 0, 8, None, False, "k=8"),
            keyswitch_case(gen, ctx8, 0, 8, BATCH, False, "k=8"),
            keyswitch_case(gen, ctx8, 2, 6, 2, False, "level 2 of k=8"),
            keyswitch_case(gen, ctx8, 2, 3, 2, True, "level 2 of k=8"),
            keyswitch_case(gen, ctx_s, 0, 5, None, False, "n=256, k=5"),
            keyswitch_case(gen, ctx_s, 2, 3, BATCH, False, "level 2 of n=256, k=5"),
            keyswitch_case(gen, ctx_s, 4, 1, None, False, "level 4 of n=256, k=5"),
            keyswitch_case(gen, ctx16, 0, 3, None, False, "n=16384"),
            keyswitch_case(gen, ctx16, 0, 3, 2, False, "n=16384"),
            keyswitch_case(gen, ctx16, 0, 2, None, True, "n=16384"),
            keyswitch_case(gen, ctx16, 0, 2, 2, True, "n=16384")]


def offset_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of x whose storage starts one word past a 16-byte boundary, so
    a kernel reads its rows a word at a time."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 4, "offset_copy: expected a 4-byte offset")
    return out


def ntt_inverse_case(gen: torch.Generator, tb, batch: int, label: str, offset: bool = False):
    """An ntt_inverse case on tb (a level's row views, or a table mod t);
    ``offset``: rows off a 16-byte boundary."""
    n = tb.n
    x = residues(gen, tb.primes, batch, n)
    if offset:
        x, label = offset_copy(x), label + ", rows off 16 bytes"
    return ("ntt_inverse", f"{label}: [{tb.k},{batch},{n}]",
            lambda: ntt_cuda.ntt_inverse(x, tb), lambda: plain_ntt.ntt_inverse(x, tb),
            ntt_work(tb.k, batch, True, n))


def ks_inner_case(gen: torch.Generator, ctx, level: int, kd: int, stacks: int,
                  key_sets: int, grouped: bool, label: str, offset: bool = False,
                  lane: str = "inner"):
    """A ks_inner_batch case (one digit stack shared by the key sets'
    elements, or one stack per element) or a ks_inner_grouped one (stack c
    with key set e) on ctx's level-L tables; ``offset``: digits, keys and c0
    off a 16-byte boundary.  ``lane``: "inner" or "galois" (the key sets'
    elements 3^1, 3^2, ..., a c0 per digit stack; a run of c0 and of the
    digits is zero, so the negations of c0 meet zeros)."""
    tb, n = level_tables(ctx, level, "q"), ctx.n
    dg = residues(gen, tb.primes, kd * stacks, n).view(tb.k, kd, stacks, n)
    keys = residues(gen, tb.primes, kd * key_sets * 2, n).view(tb.k, kd, key_sets, 2, n)
    c0 = residues(gen, tb.primes, stacks, n)
    c0 = c0[:, 0] if stacks == 1 else c0
    if lane != "inner":
        c0[..., :64] = 0
        dg[..., :64] = 0
    if offset:
        dg, keys, c0 = offset_copy(dg), offset_copy(keys), offset_copy(c0)
        label += ", rows off 16 bytes"
    elements = tuple(pow(3, s, 2 * n) for s in range(1, key_sets + 1))
    name = "ks_inner_grouped" if grouped else "ks_inner_batch"
    batch = stacks * key_sets if grouped else key_sets
    shape = f"dg [{tb.k},{kd},{stacks},{n}], keys [{tb.k},{kd},{key_sets},2,{n}]"
    if lane == "galois":
        outputs = elements * (stacks if grouped else 1)
        return (name + "_galois", f"{label}: {shape}",
                lambda: getattr(ntt_cuda, name)(dg, keys, tb, elements, c0),
                lambda: getattr(plain_ntt, name)(dg, keys, tb, elements, c0),
                ks_inner_galois_work(tb.k, kd, stacks, key_sets, outputs, stacks, n))
    return (name, f"Inner lane, {label}: {shape}",
            lambda: getattr(ntt_cuda, name)(dg, keys, tb),
            lambda: getattr(plain_ntt, name)(dg, keys, tb),
            ks_inner_work(tb.k, kd, stacks, key_sets, batch, n))


def lane_cases(gen: torch.Generator, ctx, ctx_s, ctx8, ctx16) -> list:
    """The Galois lanes of ks_inner and keyswitch_fused around the paths'
    shapes: level views, n = 256, 1024, 16384 and (ks_inner, c0 read in
    place) 32768, the grouped digits of k8_omega, B = 2 and rows off a
    16-byte boundary."""
    ctx1k = make_context(quiet_params(1024, LOG_Q), device="cuda")
    ctx32k = make_context(quiet_params(32768, LOG_Q), device="cuda")
    cases = []
    for c, lvl, kd, stacks, sets, grouped, label in (
            (ctx, 1, 2, 1, 3, False, "level 1 of k=3"),
            (ctx8, 4, 4, 1, 3, False, "level 4 of k=8"),
            (ctx_s, 1, 4, 1, 3, False, "level 1 of n=256, k=5"),
            (ctx1k, 0, 3, 1, 3, False, "n=1024"),
            (ctx16, 0, 3, 1, 3, False, "n=16384"),
            (ctx32k, 0, 3, 1, 3, False, "n=32768"),
            (ctx32k, 0, 3, 2, 2, True, "n=32768"),
            (ctx, 0, 3, 1, 8, False, "k=3")):
        cases.append(ks_inner_case(gen, c, lvl, kd, stacks, sets, grouped, label,
                                   offset=label == "k=3", lane="galois"))
    cases += [ks_inner_case(gen, ctx, 0, 3, BATCH, BATCH, False, "per-element stacks, k=3",
                            lane="galois"),
              ks_inner_case(gen, ctx8, 4, 4, C_HOIST, BATCH, True, "level 4 of k=8",
                            lane="galois"),
              ks_inner_case(gen, ctx_s, 1, 4, C_HOIST, BATCH, True, "level 1 of n=256, k=5",
                            lane="galois"),
              ks_inner_case(gen, ctx16, 0, 3, C_HOIST, 2, True, "n=16384", lane="galois")]
    for c, lvl, batch, label in ((ctx, 1, None, "level 1 of k=3"),
                                 (ctx8, 0, 2, "k=8"), (ctx_s, 2, None, "level 2 of n=256"),
                                 (ctx16, 0, None, "n=16384"), (ctx16, 0, 2, "n=16384")):
        cases.append(keyswitch_galois_case(gen, c, lvl, batch, label))
    return cases


def inverse_and_ks_inner_cases(gen: torch.Generator, ctx, ctx_s, ctx8, ctx16) -> list:
    """B2 and B17/B18 around the main path's shapes: B2 at n = 32, 256
    (k = 5, and its level 2), 16384, level views (level 1 of k = 3 at
    B = 16, level 2 of k = 8), keygen's [k, 3, n], the key down-switch's
    [k, 2 kd_l, n] rows (level 2 of k = 8: [8, 12, n]), mod t = 786433 at
    B = 1 and 16, and rows off a 16-byte boundary; B17/B18 at kd = 1, 3, 4
    and 8, one digit stack shared by every element and one per element,
    C x E = 4 x 8, level views, n = 256, 1024 and 16384, and digits and keys
    off a 16-byte boundary."""
    tb32 = plain_ntt.build_tables(32, primes.find_ntt_primes(32, 3), "cuda")
    tt = plain_ntt.build_tables(N, (786433,), "cuda")
    ctx1k = make_context(quiet_params(1024, LOG_Q), device="cuda")
    return [ntt_inverse_case(gen, tb32, 1, "n=32"),
            ntt_inverse_case(gen, tb32, 3, "n=32"),
            ntt_inverse_case(gen, level_tables(ctx_s, 0, "q"), 1, "n=256, k=5"),
            ntt_inverse_case(gen, level_tables(ctx_s, 2, "q"), 3, "level 2 of n=256, k=5"),
            ntt_inverse_case(gen, level_tables(ctx, 0, "q"), 3, "keygen's rows"),
            ntt_inverse_case(gen, level_tables(ctx, 1, "q"), 16, "level 1 of k=3"),
            ntt_inverse_case(gen, level_tables(ctx8, 2, "q"), 3, "level 2 of k=8"),
            ntt_inverse_case(gen, ctx8.ntt_q, 12, "key down-switch rows, level 2 of k=8"),
            ntt_inverse_case(gen, tt, 1, "t=786433"),
            ntt_inverse_case(gen, tt, 16, "t=786433"),
            ntt_inverse_case(gen, level_tables(ctx16, 0, "q"), 1, "n=16384"),
            ntt_inverse_case(gen, level_tables(ctx16, 0, "q"), 16, "n=16384"),
            ntt_inverse_case(gen, level_tables(ctx, 0, "q"), 3, "k=3", offset=True),
            ks_inner_case(gen, ctx, 0, 3, BATCH, BATCH, False, "per-element stacks, k=3"),
            ks_inner_case(gen, ctx, 2, 1, 1, BATCH, False, "level 2 of k=3"),
            ks_inner_case(gen, ctx8, 0, 8, 1, BATCH, False, "k=8"),
            ks_inner_case(gen, ctx8, 0, 8, BATCH, BATCH, False, "per-element stacks, k=8"),
            ks_inner_case(gen, ctx8, 4, 4, 1, BATCH, False, "level 4 of k=8"),
            ks_inner_case(gen, ctx8, 4, 4, C_HOIST, BATCH, True, "level 4 of k=8"),
            ks_inner_case(gen, ctx_s, 1, 4, 1, BATCH, False, "level 1 of n=256, k=5"),
            ks_inner_case(gen, ctx_s, 1, 4, C_HOIST, BATCH, True, "level 1 of n=256, k=5"),
            ks_inner_case(gen, ctx1k, 0, 3, 1, 3, False, "n=1024"),
            ks_inner_case(gen, ctx1k, 0, 3, 2, 3, True, "n=1024"),
            ks_inner_case(gen, ctx16, 0, 3, 1, BATCH, False, "n=16384"),
            ks_inner_case(gen, ctx16, 0, 3, C_HOIST, 2, True, "n=16384"),
            ks_inner_case(gen, ctx, 0, 3, 1, BATCH, False, "k=3", offset=True),
            ks_inner_case(gen, ctx, 0, 3, C_HOIST, BATCH, True, "k=3", offset=True)]


def cluster_cases(gen: torch.Generator, ctx, ctx_s) -> list:
    """The cluster kernels around the main path's shapes: B3/B13 and B4/B11
    at n = 256 (k = 5), 8192 and 16384, level views (level 1 of k = 3, level
    2 of k = 8; the Bsk suffix at n = 256), t = 786433 tables, B = 1, 2 and
    8, B3 on strided views and with C = 1 and 2; B5 and B8 at k = 8, B = 8,
    level 1, t = 786433, n = 256 and n = 16384 (B8 also at k = 12); B1 and
    B7/B12 (forward_and_keyswitch_cases); B2 and B17/B18
    (inverse_and_ks_inner_cases); the Galois lanes (lane_cases)."""
    ctx8 = make_context(params_leveled(), device="cuda")
    ctx_t = make_context(quiet_params(N, LOG_Q, plain_modulus=786433), device="cuda")
    ctx16 = make_context(quiet_params(16384, LOG_Q), device="cuda")
    ctx16_t = make_context(quiet_params(16384, LOG_Q, plain_modulus=786433), device="cuda")
    prm = ctx.params
    return [mul_case(gen, ctx_s, 0, "q", 2, None, "n=256, k=5"),
            mul_case(gen, ctx_s, 1, "mul", 1, BATCH, "level 1 of n=256, k=5"),
            mul_case(gen, ctx, 0, "q", 1, None, "C=1"),
            mul_case(gen, ctx, 1, "q", 2, None, "level 1 of k=3"),
            mul_case(gen, ctx, 1, "q", 2, 2, "level 1 of k=3"),
            mul_case(gen, ctx8, 2, "q", 2, None, "level 2 of k=8"),
            mul_case(gen, ctx8, 2, "q", 1, BATCH, "level 2 of k=8"),
            mul_case(gen, ctx_t, 0, "mul", 2, None, "t=786433"),
            mul_case(gen, ctx_t, 0, "mul", 2, BATCH, "t=786433"),
            mul_case(gen, ctx16, 0, "q", 2, None, "n=16384"),
            mul_case(gen, ctx16, 0, "q", 1, 2, "n=16384"),
            mul_case(gen, ctx16_t, 0, "mul", 2, BATCH, "n=16384, t=786433"),
            product_case(gen, ctx_s, 0, "mul", None, "n=256, k=5"),
            product_case(gen, ctx_s, 1, "bsk", None, "level 1 of n=256, k=5"),
            product_case(gen, ctx_s, 1, "mul", BATCH, "level 1 of n=256, k=5"),
            product_case(gen, ctx, 0, "q", None, "k=3"),
            product_case(gen, ctx, 1, "mul", None, "level 1 of k=3"),
            product_case(gen, ctx, 1, "mul", 2, "level 1 of k=3"),
            product_case(gen, ctx8, 2, "mul", None, "level 2 of k=8"),
            product_case(gen, ctx8, 2, "bsk", BATCH, "level 2 of k=8"),
            product_case(gen, ctx_t, 0, "mul", None, "t=786433"),
            product_case(gen, ctx_t, 0, "mul", BATCH, "t=786433"),
            product_case(gen, ctx16, 0, "mul", None, "n=16384"),
            product_case(gen, ctx16, 0, "mul", 2, "n=16384"),
            product_case(gen, ctx16_t, 0, "mul", BATCH, "n=16384, t=786433"),
            bsk_case(gen, ctx8, 0, None, "k=8"),
            bsk_case(gen, ctx8, 0, BATCH, "k=8"),
            bsk_case(gen, ctx, 1, None, "level 1 of k=3"),
            bsk_case(gen, ctx8, 2, BATCH, "level 2 of k=8"),
            bsk_case(gen, ctx_t, 0, None, "t=786433"),
            bsk_case(gen, ctx_t, 0, BATCH, "t=786433"),
            bsk_case(gen, ctx_s, 0, BATCH, "n=256, k=5"),
            bsk_case(gen, ctx_s, 1, BATCH, "level 1 of n=256, k=5"),
            bsk_case(gen, ctx16, 0, None, "n=16384"),
            bsk_case(gen, ctx16, 0, 2, "n=16384"),
            decrypt_case(gen, ctx8.params, 0, 1, "k=8"),
            decrypt_case(gen, ctx8.params, 0, BATCH, "k=8"),
            decrypt_case(gen, quiet_params(N, 360), 0, 1, "k=12"),
            decrypt_case(gen, quiet_params(N, 360, plain_modulus=786433), 0, BATCH, "k=12"),
            decrypt_case(gen, prm, 1, 1, "level 1 of k=3"),
            decrypt_case(gen, ctx8.params, 3, BATCH, "level 3 of k=8"),
            decrypt_case(gen, ctx_t.params, 0, BATCH, "k=3"),
            decrypt_case(gen, ctx_s.params, 2, BATCH, "level 2 of n=256, k=5"),
            decrypt_case(gen, ctx16.params, 0, 1, "n=16384"),
            decrypt_case(gen, ctx16.params, 0, BATCH, "n=16384")] + forward_and_keyswitch_cases(
                gen, ctx, ctx_s, ctx8, ctx16) + inverse_and_ks_inner_cases(
                gen, ctx, ctx_s, ctx8, ctx16) + lane_cases(gen, ctx, ctx_s, ctx8, ctx16)


def phase_geometry() -> None:
    """The launch shape of each cluster kernel at the main path's shapes
    (n = 8192, k = 3, kb = 5; c = 2 operand rows; kd = 3; B = 8; keygen's
    three rows; the hoisted rotations' 8 elements and their batch's 4 x 8;
    keyswitch_fused's Galois lane and a sum_slots stage's 3 elements) and at
    n = 16384; keyswitch_fused at k = 8 (kd = 8, and the prereduced kd = 4),
    ntt_forward and ntt_inverse at n = 32768."""
    for n in (N, 16384):
        for name, geo in (("ntt_forward", ntt_cuda.ntt_forward_geometry(n, 3)),
                          ("ntt_forward keygen", ntt_cuda.ntt_forward_geometry(n, 3, 3)),
                          ("ntt_inverse", ntt_cuda.ntt_inverse_geometry(n, 3)),
                          ("ntt_inverse encode", ntt_cuda.ntt_inverse_geometry(n, 1)),
                          ("ks_inner_batch", ntt_cuda.ks_inner_geometry(n, 3, BATCH)),
                          ("ks_inner_grouped",
                           ntt_cuda.ks_inner_geometry(n, 3, C_HOIST * BATCH,
                                                      "ks_inner_grouped")),
                          ("ks_inner_batch Galois lane",
                           ntt_cuda.ks_inner_geometry(n, 3, BATCH, c0=True)),
                          ("keyswitch_fused", ntt_cuda.keyswitch_geometry(n, 3, 3)),
                          ("keyswitch_fused Galois lane",
                           ntt_cuda.keyswitch_geometry(n, 3, 3, galois=True)),
                          ("keyswitch_fused_batch",
                           ntt_cuda.keyswitch_geometry(n, 3, 3, BATCH)),
                          ("mul_by_ntt_operand", ntt_cuda.mul_by_ntt_operand_geometry(n, 3, 2)),
                          ("mul_by_ntt_operand_batch",
                           ntt_cuda.mul_by_ntt_operand_geometry(n, 3, 2, BATCH)),
                          ("tensor_product", ntt_cuda.tensor_product_geometry(n, 3)),
                          ("tensor_product_batch",
                           ntt_cuda.tensor_product_geometry(n, 3, BATCH)),
                          ("bsk_branch_fused", rns_cuda.bsk_branch_geometry(n, 5)),
                          ("bsk_branch_fused_batch",
                           rns_cuda.bsk_branch_geometry(n, 5, BATCH)),
                          ("decrypt_fused", decrypt_cuda.decrypt_geometry(n, 3)),
                          ("decrypt_fused_batch",
                           decrypt_cuda.decrypt_geometry(n, 3, BATCH))):
            print(f"phase geometry {name} n={n}", json.dumps(geo))
    for name, n, geo in (("keyswitch_fused k=8 kd=8", N, ntt_cuda.keyswitch_geometry(N, 8, 8)),
                         ("keyswitch_fused_prereduced k=8 kd=4", N,
                          ntt_cuda.keyswitch_geometry(N, 8, 4)),
                         ("ntt_forward", 32768, ntt_cuda.ntt_forward_geometry(32768, 3)),
                         ("ntt_inverse", 32768, ntt_cuda.ntt_inverse_geometry(32768, 3))):
        print(f"phase geometry {name} n={n}", json.dumps(geo))


# the kernels of the n = 16384 multiply and of what makes and checks its
# inputs; the key switch is the prereduced lane at ks_omega = 2
N16384_KERNELS = ("ntt_forward", "mul_by_ntt_operand", "tensor_product", "bsk_branch_fused",
                  "fast_bconv_sk_fused", "decrypt_fused")


def phase_n16384() -> None:
    """n = 16384, the JAX bench's g_n16384 (bench.py:777-815: log_q = 90,
    k = 3, seed 4) at ks_omega = 1 and 2: keygen, relinkey_gen, encrypt
    [5, 10] and [3, 6], multiply; it decodes [15, 60] and equals the CPU
    plain path bit for bit, and each kernel of the multiply launched.  Then
    the multiply's device and wall ms under the bench's metric names."""
    times = {}
    for omega, metric in ((1, "multiply_relin_ms_n16384"),
                          (2, "multiply_relin_ms_n16384_omega2")):
        fhe = FHE(quiet_params(16384, LOG_Q, ks_omega=omega), seed=4, device="cuda")
        reset_counts()
        pk, sk = fhe.keygen()
        rlk = fhe.relinkey_gen(sk)
        a = fhe.encrypt(fhe.encode([5, 10]), pk)
        b = fhe.encrypt(fhe.encode([3, 6]), pk)
        prod = fhe.multiply(a, b, rlk)
        got = [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:2]]
        torch.cuda.synchronize()
        launches = read_counts()
        check(got == [15, 60], f"n=16384 multiply (ks_omega={omega}) decoded {got}")
        for name in N16384_KERNELS + ("keyswitch_fused" if omega == 1
                                      else "keyswitch_fused_prereduced",):
            check(launches[name] > 0, f"{name} was never launched in the n=16384 multiply")
        cpu = make_context(fhe.params, device="cpu")
        to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
        want = bfv.multiply(cpu, to_cpu(a), to_cpu(b), RelinKeys(data=rlk.data.cpu()))
        check(torch.equal(prod.data.cpu(), want.data),
              f"n=16384 multiply (ks_omega={omega}) differs from the CPU plain path")
        print(f"phase n16384 launches ks_omega={omega}",
              json.dumps({k: v for k, v in launches.items() if v}))
        fn = lambda: fhe.multiply(a, b, rlk)
        times[metric] = {"device_ms": device_ms(fn), "wall_ms": wall_ms(fn)}
    print("phase n16384 check: the multiply decoded [15, 60] at ks_omega 1 and 2; card == "
          "CPU plain path")
    print("phase n16384", json.dumps(times))


def phase_n32768() -> None:
    """n = 32768, the JAX bench's g_n32768 (bench.py:932-945): 3 NTT primes
    for n = 32768, one [1, 32768] row per prime from numpy seed 5; ntt_forward
    equals its plain twin on the card, and its device and wall ms print under
    the bench's metric name beside the card's name and power limit.  Then
    ntt_inverse of the same rows equals its plain twin (a check, with its
    device ms, not a bench metric)."""
    ps = primes.find_ntt_primes(32768, 3)
    x = np.stack([np.random.default_rng(5).integers(0, p, (1, 32768), dtype=np.uint32)
                  for p in ps])
    tb = plain_ntt.build_tables(32768, ps, "cuda")
    a = torch.from_numpy(x.astype(np.int32)).to("cuda")
    times = {}
    for name, metric in (("ntt_forward", "forward_ntt_ms_n32768"),
                         ("ntt_inverse", "ntt_inverse_ms_n32768")):
        got, want = getattr(ntt_cuda, name)(a, tb), getattr(plain_ntt, name)(a, tb)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"n=32768 {name} differs from its plain twin")
        fn = lambda name=name: getattr(ntt_cuda, name)(a, tb)
        times[metric] = {"device_ms": device_ms(fn), "wall_ms": wall_ms(fn)}
    print("phase n32768 check: ntt_forward and ntt_inverse of g_n32768's [3,1,32768] equal "
          "their plain twins")
    print("phase n32768", json.dumps({"card": card_name(), **times}))


def run_slice(fhe: FHE):
    """The main path once: returns the decoded values and the state."""
    pk, sk = fhe.keygen()
    p1, p2 = fhe.encode([5, 10, 15, 20]), fhe.encode([3, 6, 9, 12])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(p2, pk)
    added = fhe.decode(fhe.decrypt(fhe.add(c1, c2), sk))[:4]
    plain_added = fhe.decode(fhe.decrypt(fhe.add_plain(c1, p2), sk))[:4]
    pts = [fhe.encode([i + 1, 2 * i + 1, 3, 4]) for i in range(8)]
    ct = fhe.to_ntt(c1)
    acc = None
    for pt in pts:
        term = fhe.multiply_plain(ct, pt, cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    acc = fhe.to_coeff(acc)
    mac = fhe.decode(fhe.decrypt(acc, sk))
    return added, plain_added, mac, dict(pk=pk, sk=sk, p1=p1, c1=c1, pts=pts, acc=acc)


def phase_slice() -> dict:
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=0, device="cuda")
    check(fhe.params.k == 3, f"expected k = 3, got {fhe.params.k}")
    reset_counts()
    added, plain_added, mac, st = run_slice(fhe)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase slice launches", json.dumps(launches))
    check(list(added) == [8, 16, 24, 32], f"add decoded {list(added)}")
    check(list(plain_added) == [8, 16, 24, 32], f"add_plain decoded {list(plain_added)}")
    check(int(mac[0]) == 180, f"MAC slot 0 decoded {int(mac[0])}")
    check_launched(launches, "slice")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    sk_cpu = SecretKey(data=st["sk"].data.cpu())
    for ct in (st["c1"], st["acc"]):
        got = fhe.decrypt(ct, st["sk"]).data.cpu()
        check(torch.equal(got, bfv.decrypt(cpu, to_cpu(ct), sk_cpu).data),
              "card decrypt differs from the CPU plain path")
    ct_cpu = bfv.to_ntt(cpu, to_cpu(st["c1"]))
    acc_cpu = None
    for pt in st["pts"]:
        pt_cpu = Plaintext(data=pt.data.cpu())
        term = bfv.multiply_plain(cpu, ct_cpu, pt_cpu,
                                  bfv.plain_ntt_operand(cpu, pt_cpu))
        acc_cpu = term if acc_cpu is None else bfv.add(cpu, acc_cpu, term)
    check(torch.equal(bfv.to_coeff(cpu, acc_cpu).data, st["acc"].data.cpu()),
          "card MAC differs from the CPU plain path")
    gen = torch.Generator(device="cuda").manual_seed(9)
    primes = fhe.ctx.ntt_q.p
    s, a, e = (sampling.ternary_rns(gen, primes, 1, N, H),
               sampling.uniform_rns(gen, primes, 1, N),
               sampling.gaussian_rns(gen, primes, 3.2, 1, N))
    pk_card, sk_card = bfv.keygen_from_noise(fhe.ctx, s, a, e)
    pk_cpu, sk_cpu2 = bfv.keygen_from_noise(cpu, s.cpu(), a.cpu(), e.cpu())
    check(torch.equal(pk_card.data.cpu(), pk_cpu.data)
          and torch.equal(sk_card.data.cpu(), sk_cpu2.data),
          "card keygen differs from the CPU plain path")
    # u = s and e1 = e2 = e: any residues serve to compare the two paths
    enc_card = bfv.encrypt_from_noise(fhe.ctx, pk_card, st["p1"], s, e, e)
    enc_cpu = bfv.encrypt_from_noise(cpu, pk_cpu, Plaintext(data=st["p1"].data.cpu()),
                                     s.cpu(), e.cpu(), e.cpu())
    check(torch.equal(enc_card.data.cpu(), enc_cpu.data),
          "card encrypt differs from the CPU plain path")
    print("phase slice check: decoded [8,16,24,32] twice and 180; card == CPU plain path "
          "for keygen, encrypt, the MAC and decrypt")

    pk, sk, p1, c1, pts = st["pk"], st["sk"], st["p1"], st["c1"], st["pts"]
    ops = [fhe.plain_operand(pt) for pt in pts]
    ct_ntt = fhe.to_ntt(c1)

    def mac8():
        ct = fhe.to_ntt(c1)
        acc = None
        for pt, op in zip(pts, ops):
            term = bfv.multiply_plain(fhe.ctx, ct, pt, op)
            acc = term if acc is None else fhe.add(acc, term)
        return fhe.to_coeff(acc)

    timings = {
        "keygen": wall_ms(fhe.keygen),
        "encode": wall_ms(lambda: fhe.encode([5, 10, 15, 20])),
        "encrypt": wall_ms(lambda: fhe.encrypt(p1, pk)),
        "add": wall_ms(lambda: fhe.add(c1, c1)),
        "add_plain": wall_ms(lambda: fhe.add_plain(c1, p1)),
        "to_ntt": wall_ms(lambda: fhe.to_ntt(c1)),
        "multiply_plain_resident": wall_ms(
            lambda: bfv.multiply_plain(fhe.ctx, ct_ntt, pts[0], ops[0])),
        "mac8_resident": wall_ms(mac8),
        "decrypt": wall_ms(lambda: fhe.decrypt(c1, sk)),
        "decode": wall_ms(lambda: fhe.decode(p1)),
    }
    print("phase slice wall_ms", json.dumps(timings))
    return launches


PRODUCT = [15, 60, 135, 240]


def phase_multiply() -> dict:
    """The ciphertext multiply path through the facade, then the same state
    through the plain versions on the CPU, then end-to-end times."""
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=3, device="cuda")
    dec = lambda ct: [int(v) for v in fhe.decode(fhe.decrypt(ct, sk))[:4]]
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    c1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    c2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    m3 = fhe.multiply_no_relin(c1, c2)
    dec3 = dec(m3)
    relin = fhe.relinearize(m3, rlk)
    dec_relin = dec(relin)
    prod = fhe.multiply(c1, c2, rlk)
    dec_prod = dec(prod)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase multiply launches", json.dumps(launches))
    for what, got in (("multiply_no_relin", dec3), ("relinearize", dec_relin),
                      ("multiply", dec_prod)):
        check(got == PRODUCT, f"{what} decoded {got}, expected {PRODUCT}")
    check(m3.num_components == 3 and prod.num_components == 2,
          "unexpected component counts")
    check_launched(launches, "multiply")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    sk_cpu = SecretKey(data=sk.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    gen = torch.Generator(device="cuda").manual_seed(11)
    primes = fhe.ctx.ntt_q.p
    a = torch.stack([sampling.uniform_rns(gen, primes, 1, N) for _ in range(3)])
    e = torch.stack([sampling.gaussian_rns(gen, primes, 3.2, 1, N) for _ in range(3)])
    check(torch.equal(bfv.relinkey_gen_from_noise(fhe.ctx, sk, a, e).data.cpu(),
                      bfv.relinkey_gen_from_noise(cpu, sk_cpu, a.cpu(), e.cpu()).data),
          "card relinkey_gen_from_noise differs from the CPU plain path")
    m3_cpu = bfv.multiply_no_relin(cpu, to_cpu(c1), to_cpu(c2))
    check(torch.equal(m3.data.cpu(), m3_cpu.data),
          "card multiply_no_relin differs from the CPU plain path")
    check(torch.equal(relin.data.cpu(), bfv.relinearize(cpu, m3_cpu, rlk_cpu).data),
          "card relinearize differs from the CPU plain path")
    check(torch.equal(prod.data.cpu(),
                      bfv.multiply(cpu, to_cpu(c1), to_cpu(c2), rlk_cpu).data),
          "card multiply differs from the CPU plain path")
    check(torch.equal(fhe.decrypt(m3, sk).data.cpu(), bfv.decrypt(cpu, m3_cpu, sk_cpu).data),
          "card 3-component decrypt differs from the CPU plain path")
    print(f"phase multiply check: decoded {PRODUCT} three times; card == CPU plain path "
          "for relinkey_gen_from_noise, multiply_no_relin, relinearize, multiply and "
          "the 3-component decrypt")

    timings = {
        "relinkey_gen": wall_ms(lambda: fhe.relinkey_gen(sk)),
        "multiply_no_relin": wall_ms(lambda: fhe.multiply_no_relin(c1, c2)),
        "relinearize": wall_ms(lambda: fhe.relinearize(m3, rlk)),
        "multiply": wall_ms(lambda: fhe.multiply(c1, c2, rlk)),
        "decrypt_3_components": wall_ms(lambda: fhe.decrypt(m3, sk)),
        "decrypt_after_multiply": wall_ms(lambda: fhe.decrypt(prod, sk)),
    }
    print("phase multiply wall_ms", json.dumps(timings))
    dev = {op: device_ms(fn) for op, fn in (
        ("multiply_no_relin", lambda: fhe.multiply_no_relin(c1, c2)),
        ("relinearize", lambda: fhe.relinearize(m3, rlk)),
        ("multiply", lambda: fhe.multiply(c1, c2, rlk)),
        ("decrypt_after_multiply", lambda: fhe.decrypt(prod, sk)))}
    print("phase multiply device_ms", json.dumps(dev))
    print_profiled("multiply", {
        "multiply": lambda: fhe.multiply(c1, c2, rlk),
        "multiply_no_relin": lambda: fhe.multiply_no_relin(c1, c2),
        "relinearize": lambda: fhe.relinearize(m3, rlk)})
    return launches


VALS_A = [[5 + i, 10 + i, 15 + i, 20 + i] for i in range(BATCH)]
VALS_B = [[3, 6, 9, 12 + i] for i in range(BATCH)]


def rotated(vals: list, steps: int) -> list:
    """The first slot row of an encoding of vals after rotate_rows(steps)."""
    row = vals + [0] * (N // 2 - len(vals))
    return row[steps:] + row[:steps]


def run_serving(fhe: FHE, pk: PublicKey, sk: SecretKey, rlk: RelinKeys,
                gk: GaloisKeys) -> dict:
    """The serving path once: two batches encrypted and decrypted, their
    products, and the rotations.  Returns every result."""
    cts_a = fhe.encrypt_batch([fhe.encode(v) for v in VALS_A], pk)
    cts_b = fhe.encrypt_batch([fhe.encode(v) for v in VALS_B], pk)
    prods = fhe.multiply_batch(cts_a, cts_b, rlk)
    rot = fhe.rotate_rows(cts_a[0], 1, gk)
    cols = fhe.rotate_columns(cts_a[0], gk)
    rot_b = fhe.rotate_rows_batch(cts_a, 1, gk)
    dec = lambda pts: [[int(x) for x in fhe.decode(pt)] for pt in pts]
    return dict(cts_a=cts_a, cts_b=cts_b, prods=prods, rot=rot, cols=cols, rot_b=rot_b,
                dec_a=dec(fhe.decrypt_batch(cts_a, sk)),
                dec_prods=dec(fhe.decrypt_batch(prods, sk)),
                dec_rot=dec([fhe.decrypt(rot, sk)]), dec_cols=dec([fhe.decrypt(cols, sk)]),
                dec_rot_b=dec(fhe.decrypt_batch(rot_b, sk)))


def phase_serving() -> dict:
    """The serving batch and rotation path through the facade at B = 8, then
    the same state through the plain versions on the CPU, then end-to-end
    times per op and per ciphertext."""
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=5, device="cuda")
    n2, t = 2 * N, fhe.params.t
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3, n2 - 1))
    st = run_serving(fhe, pk, sk, rlk, gk)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase serving launches", json.dumps(launches))
    prods_want = [[x * y % t for x, y in zip(a, b)] for a, b in zip(VALS_A, VALS_B)]
    check([d[:4] for d in st["dec_a"]] == VALS_A, "encrypt_batch/decrypt_batch decoded "
          f"{[d[:4] for d in st['dec_a']]}")
    check([d[:4] for d in st["dec_prods"]] == prods_want,
          f"multiply_batch decoded {[d[:4] for d in st['dec_prods']]}, expected {prods_want}")
    check(st["dec_rot"][0][:N // 2] == rotated(VALS_A[0], 1),
          f"rotate_rows by 1 decoded {st['dec_rot'][0][:6]}")
    check(st["dec_cols"][0][N // 2:N // 2 + 4] == VALS_A[0]
          and st["dec_cols"][0][:4] == [0] * 4,
          f"rotate_columns decoded {st['dec_cols'][0][:4]} / "
          f"{st['dec_cols'][0][N // 2:N // 2 + 4]}")
    check(all(d[:N // 2] == rotated(v, 1) for d, v in zip(st["dec_rot_b"], VALS_A)),
          f"rotate_rows_batch decoded {[d[:4] for d in st['dec_rot_b']]}")
    check_launched(launches, "serving", ("ntt_inverse",))
    for i in range(BATCH):
        single = fhe.multiply(st["cts_a"][i], st["cts_b"][i], rlk)
        check(torch.equal(single.data, st["prods"][i].data)
              and single.noise_budget == st["prods"][i].noise_budget,
              f"multiply_batch element {i} differs from the single multiply")
        check(torch.equal(fhe.rotate_rows(st["cts_a"][i], 1, gk).data,
                          st["rot_b"][i].data),
              f"rotate_rows_batch element {i} differs from the single rotate_rows")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    same = lambda card, plain: all(torch.equal(a.data.cpu(), b.data)
                                   for a, b in zip(card, plain))
    sk_cpu, pk_cpu = SecretKey(data=sk.data.cpu()), PublicKey(data=pk.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    gk_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk.data.items()})
    gen = torch.Generator(device="cuda").manual_seed(13)
    primes = fhe.ctx.ntt_q.p
    u = sampling.ternary_rns(gen, primes, BATCH, N, H)
    e1, e2 = (sampling.gaussian_rns(gen, primes, 3.2, BATCH, N) for _ in range(2))
    pts = [fhe.encode(v) for v in VALS_A]
    enc_card = bfv.encrypt_batch_from_noise(fhe.ctx, pk, pts, u, e1, e2)
    enc_cpu = bfv.encrypt_batch_from_noise(
        cpu, pk_cpu, [Plaintext(data=pt.data.cpu()) for pt in pts], u.cpu(), e1.cpu(),
        e2.cpu())
    check(same(enc_card, enc_cpu), "card encrypt_batch_from_noise differs from the CPU")
    col = lambda x, i: x[:, i:i + 1]
    check(all(torch.equal(bfv.encrypt_from_noise(fhe.ctx, pk, pts[i], col(u, i), col(e1, i),
                                                 col(e2, i)).data, enc_card[i].data)
              for i in range(BATCH)), "encrypt_batch element differs from encrypt")
    a = torch.stack([torch.stack([sampling.uniform_rns(gen, primes, 1, N) for _ in range(3)])
                     for _ in range(2)])
    e = torch.stack([torch.stack([sampling.gaussian_rns(gen, primes, 3.2, 1, N)
                                  for _ in range(3)]) for _ in range(2)])
    gk_card = bfv.galoiskey_gen_from_noise(fhe.ctx, sk, (3, n2 - 1), a, e)
    gk_plain = bfv.galoiskey_gen_from_noise(cpu, sk_cpu, (3, n2 - 1), a.cpu(), e.cpu())
    check(all(torch.equal(gk_card.data[g].cpu(), gk_plain.data[g]) for g in (3, n2 - 1)),
          "card galoiskey_gen_from_noise differs from the CPU plain path")
    cts_a_cpu = [to_cpu(c) for c in st["cts_a"]]
    cts_b_cpu = [to_cpu(c) for c in st["cts_b"]]
    dec_cpu = bfv.decrypt_batch(cpu, cts_a_cpu, sk_cpu)
    check(all(torch.equal(x.data.cpu(), y.data) for x, y in
              zip(fhe.decrypt_batch(st["cts_a"], sk), dec_cpu)),
          "card decrypt_batch differs from the CPU plain path")
    check(same(st["prods"], bfv.multiply_batch(cpu, cts_a_cpu, cts_b_cpu, rlk_cpu)),
          "card multiply_batch differs from the CPU plain path")
    check(same([st["rot"], st["cols"]],
               [bfv.rotate_rows(cpu, cts_a_cpu[0], 1, gk_cpu),
                bfv.rotate_columns(cpu, cts_a_cpu[0], gk_cpu)]),
          "card rotate_rows / rotate_columns differ from the CPU plain path")
    check(same(st["rot_b"], bfv.rotate_rows_batch(cpu, cts_a_cpu, 1, gk_cpu)),
          "card rotate_rows_batch differs from the CPU plain path")
    print(f"phase serving check: B={BATCH}; decoded the batch, the products, rotate_rows, "
          "rotate_columns and rotate_rows_batch; multiply_batch and rotate_rows_batch "
          "element i == the single op; card == CPU plain path for encrypt_batch_from_noise, "
          "galoiskey_gen_from_noise, decrypt_batch, multiply_batch and the rotations")

    # a rotation at ks_omega = 1 is one launch of the key switch's Galois lane,
    # with no automorphism kernel and no classic key switch of its own
    rot_ops = {"rotate_rows_1": lambda: fhe.rotate_rows(st["cts_a"][0], 1, gk),
               "rotate_columns": lambda: fhe.rotate_columns(st["cts_a"][0], gk),
               "rotate_rows_batch_1": lambda: fhe.rotate_rows_batch(st["cts_a"], 1, gk)}
    reset_counts()
    for fn in rot_ops.values():
        fn()
    torch.cuda.synchronize()
    rc = read_counts()
    print("phase serving rotation launches", json.dumps(
        {name: c for name, c in rc.items() if c}))
    check(rc["keyswitch_fused_galois"] == 2 and rc["keyswitch_fused_batch_galois"] == 1
          and rc["automorphism_single"] == 0 and rc["automorphism_fused"] == 0
          and rc["keyswitch_fused"] == 0 and rc["keyswitch_fused_batch"] == 0,
          f"the rotations launched {rc}, expected the Galois lanes only")
    print_profiled("serving", rot_ops)

    cts_a, cts_b = st["cts_a"], st["cts_b"]
    pts_a = [fhe.encode(v) for v in VALS_A]
    timings = {
        "galoiskey_gen_2_elements": wall_ms(
            lambda: fhe.galoiskey_gen(sk, elements=(3, n2 - 1))),
        "encrypt": wall_ms(lambda: fhe.encrypt(pts_a[0], pk)),
        "encrypt_batch": wall_ms(lambda: fhe.encrypt_batch(pts_a, pk)),
        "decrypt": wall_ms(lambda: fhe.decrypt(cts_a[0], sk)),
        "decrypt_batch": wall_ms(lambda: fhe.decrypt_batch(cts_a, sk)),
        "multiply": wall_ms(lambda: fhe.multiply(cts_a[0], cts_b[0], rlk)),
        "multiply_batch": wall_ms(lambda: fhe.multiply_batch(cts_a, cts_b, rlk)),
        "rotate_rows_1": wall_ms(lambda: fhe.rotate_rows(cts_a[0], 1, gk)),
        "rotate_columns": wall_ms(lambda: fhe.rotate_columns(cts_a[0], gk)),
        "rotate_rows_batch_1": wall_ms(lambda: fhe.rotate_rows_batch(cts_a, 1, gk)),
    }
    per_ct = {op: ms / BATCH for op, ms in timings.items() if "_batch" in op}
    print("phase serving wall_ms", json.dumps(timings))
    print(f"phase serving wall_ms per ciphertext (B={BATCH})", json.dumps(per_ct))
    big = 3 * BATCH
    a24 = (cts_a * 3)[:big]
    b24 = (cts_b * 3)[:big]
    # the B = 24 batch repeats the B = 8 pairs: each product equals the
    # B = 8 one, which equals the CPU plain path (above)
    prods24 = fhe.multiply_batch(a24, b24, rlk)
    check(len(prods24) == big and all(torch.equal(x.data, y.data)
                                      for x, y in zip(prods24, st["prods"] * 3)),
          f"card multiply_batch at B={big} differs from the B={BATCH} products")
    ms24 = wall_ms(lambda: fhe.multiply_batch(a24, b24, rlk))
    # device time of the whole op (host overhead excluded, device_ms): flat in B
    # while every kernel of the op still runs in one wave of blocks
    print("phase serving multiply_batch B=24", json.dumps({
        "wall_ms": ms24, "per_ciphertext_ms": ms24 / big,
        "multiply_batch_B8_wall_ms": timings["multiply_batch"],
        "device_ms_B1_multiply": device_ms(lambda: fhe.multiply(cts_a[0], cts_b[0], rlk)),
        "device_ms_B8": device_ms(lambda: fhe.multiply_batch(cts_a, cts_b, rlk)),
        "device_ms_B24": device_ms(lambda: fhe.multiply_batch(a24, b24, rlk))}))
    return launches


STEPS = tuple(range(1, 9))                      # the bench's hoisted set
HOIST = tuple(pow(3, s, 2 * N) for s in STEPS)
VALS_H = [5, 10, 15, 20]


def same_cts(card: list, plain: list) -> bool:
    return all(torch.equal(a.data.cpu(), b.data) for a, b in zip(card, plain))


def hoisted_timings(fhe: FHE, ct, cts: list, gk: GaloisKeys) -> dict:
    """wall_ms and device_ms of the hoisted rotations beside rotate_rows by
    1, and per rotation (8 elements; C x 8 in the batch)."""
    ops = {
        "hoisted_galois_keys_8": lambda: bfv.hoisted_galois_keys(fhe.ctx, gk, HOIST),
        "rotate_rows_hoisted_8": lambda: fhe.rotate_rows_hoisted(ct, STEPS, gk),
        f"rotate_rows_hoisted_batch_{len(cts)}x8":
            lambda: fhe.rotate_rows_hoisted_batch(cts, STEPS, gk),
        "rotate_rows_1": lambda: fhe.rotate_rows(ct, 1, gk),
    }
    wall = {op: wall_ms(fn) for op, fn in ops.items()}
    dev = {op: device_ms(fn) for op, fn in ops.items()}
    per_rot = {
        "rotate_rows_hoisted_ms_per_rot": wall["rotate_rows_hoisted_8"] / len(STEPS),
        "rotate_rows_hoisted_batch_ms_per_rot":
            wall[f"rotate_rows_hoisted_batch_{len(cts)}x8"] / (len(cts) * len(STEPS)),
        "rotate_rows_1_ms": wall["rotate_rows_1"],
        "device_rotate_rows_hoisted_ms_per_rot": dev["rotate_rows_hoisted_8"] / len(STEPS),
        "device_rotate_rows_hoisted_batch_ms_per_rot":
            dev[f"rotate_rows_hoisted_batch_{len(cts)}x8"] / (len(cts) * len(STEPS)),
        "device_rotate_rows_1_ms": dev["rotate_rows_1"]}
    return {"wall_ms": wall, "device_ms": dev, "per_rotation": per_rot}


def check_hoisted(fhe: FHE, sk: SecretKey, ct, vals: list, outs: list, cts: list,
                  vals_c: list, outs_b: list, gk: GaloisKeys) -> None:
    """Element s of the hoisted rotations decodes to the row rotated by s and
    to the sequential rotate_rows(ct, s) (by decryption only: the hoisted
    digits carry -d representatives); element [c][e] of the batch equals
    rotate_rows_hoisted(cts[c])[e] bit for bit and decodes."""
    dec = lambda c: [int(v) for v in fhe.decode(fhe.decrypt(c, sk))]
    for s, out in zip(STEPS, outs):
        got = dec(out)
        check(got[:N // 2] == rotated(vals, s), f"rotate_rows_hoisted step {s} decoded "
              f"{got[:6]}")
        check(got == dec(fhe.rotate_rows(ct, s, gk)),
              f"rotate_rows_hoisted step {s} decrypts unlike rotate_rows")
    for c, (row, v) in enumerate(zip(outs_b, vals_c)):
        single = fhe.rotate_rows_hoisted(cts[c], STEPS, gk)
        check(all(torch.equal(a.data, b.data) and a.noise_budget == b.noise_budget
                  for a, b in zip(row, single)),
              f"rotate_rows_hoisted_batch ciphertext {c} differs from rotate_rows_hoisted")
        decs = [[int(x) for x in fhe.decode(pt)] for pt in fhe.decrypt_batch(row, sk)]
        check(all(d[:N // 2] == rotated(v, s) for d, s in zip(decs, STEPS)),
              f"rotate_rows_hoisted_batch ciphertext {c} decoded {[d[:2] for d in decs]}")


def phase_hoisted() -> dict:
    """The hoisted rotations and sum_slots through the facade at the headline
    width (the JAX bench's rotations group), then the same state through the
    plain versions on the CPU, then times."""
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=7, device="cuda")
    check(fhe.params.k == 3, f"expected k = 3, got {fhe.params.k}")
    vals_c = [[v + 100 * c for v in VALS_H] for c in range(C_HOIST)]
    reset_counts()
    pk, sk = fhe.keygen()
    gk = fhe.galoiskey_gen(sk, elements=HOIST)
    ct = fhe.encrypt(fhe.encode(VALS_H), pk)
    outs = fhe.rotate_rows_hoisted(ct, STEPS, gk)
    cts = fhe.encrypt_batch([fhe.encode(v) for v in vals_c], pk)
    outs_b = fhe.rotate_rows_hoisted_batch(cts, STEPS, gk)
    gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    total = fhe.sum_slots(ct, gk_ss)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase hoisted launches", json.dumps(launches))
    check_hoisted(fhe, sk, ct, VALS_H, outs, cts, vals_c, outs_b, gk)
    got = {int(v) for v in fhe.decode(fhe.decrypt(total, sk))}
    check(got == {sum(VALS_H)}, f"sum_slots decoded {sorted(got)[:4]}, expected "
          f"every slot {sum(VALS_H)}")
    check_launched(launches, "hoisted", ("ntt_inverse",))

    # the same state through the plain versions on the CPU, at full size
    cpu = FHE(fhe.params, device="cpu")
    to_cpu = lambda c: c.replace(data=c.data.cpu())
    gk_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk.data.items()})
    gk_ss_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk_ss.data.items()})
    check(torch.equal(bfv.hoisted_galois_keys(fhe.ctx, gk, HOIST).cpu(),
                      bfv.hoisted_galois_keys(cpu.ctx, gk_cpu, HOIST)),
          "card hoisted_galois_keys differ from the CPU plain path")
    check(same_cts(outs, bfv.apply_galois_hoisted(cpu.ctx, to_cpu(ct), HOIST, gk_cpu)),
          "card rotate_rows_hoisted differs from the CPU plain path")
    plain_b = bfv.apply_galois_hoisted_batch(cpu.ctx, [to_cpu(c) for c in cts], HOIST,
                                             gk_cpu)
    check(all(same_cts(a, b) for a, b in zip(outs_b, plain_b)),
          "card rotate_rows_hoisted_batch differs from the CPU plain path")
    check(same_cts([total], [cpu.sum_slots(to_cpu(ct), gk_ss_cpu)]),
          "card sum_slots differs from the CPU plain path")
    print(f"phase hoisted check: n={N}, k=3, 8 steps; rotate_rows_hoisted decodes each "
          f"rotation and decrypts as rotate_rows; rotate_rows_hoisted_batch (C={C_HOIST}) "
          f"element [c][e] == rotate_rows_hoisted(cts[c])[e]; sum_slots decodes "
          f"{sum(VALS_H)} in every slot; card == CPU plain path for hoisted_galois_keys, "
          "rotate_rows_hoisted, rotate_rows_hoisted_batch and sum_slots")

    # the hoisted rotations run their automorphisms inside ks_inner (its
    # Galois lanes, once each); each sum_slots stage is ks_inner_batch's
    # Inner lane and automorphism_fused_sum (six radix-4 stages at n = 8192),
    # and its closing rotate_columns the key switch's Galois lane; no other
    # automorphism kernel
    hoisted_ops = {"rotate_rows_hoisted_8": lambda: fhe.rotate_rows_hoisted(ct, STEPS, gk),
                   f"rotate_rows_hoisted_batch_{C_HOIST}x8":
                       lambda: fhe.rotate_rows_hoisted_batch(cts, STEPS, gk),
                   "sum_slots": lambda: fhe.sum_slots(ct, gk_ss)}
    grouped0 = ntt_cuda.ks_inner_grouped.launches
    reset_counts()
    for fn in hoisted_ops.values():
        fn()
    torch.cuda.synchronize()
    rc = read_counts()
    grouped = ntt_cuda.ks_inner_grouped.launches - grouped0
    print("phase hoisted lane launches", json.dumps(
        {name: c for name, c in rc.items() if c}), "ks_inner_grouped Inner lane", grouped)
    check(rc["ks_inner_batch"] == 6 and rc["automorphism_fused_sum"] == 6
          and rc["ks_inner_batch_galois"] == 1 and rc["ks_inner_grouped_galois"] == 1
          and rc["keyswitch_fused_galois"] == 1 and rc["automorphism_fused"] == 0
          and rc["automorphism_single"] == 0 and grouped == 0,
          f"the hoisted calls and sum_slots launched {rc} and {grouped} grouped Inner lanes")
    print_profiled("hoisted", hoisted_ops)

    times = hoisted_timings(fhe, ct, cts, gk)
    times["wall_ms"]["sum_slots"] = wall_ms(lambda: fhe.sum_slots(ct, gk_ss))
    times["device_ms"]["sum_slots"] = device_ms(lambda: fhe.sum_slots(ct, gk_ss))
    for key, row in times.items():
        print(f"phase hoisted {key}", json.dumps(row))
    return launches


def phase_omega() -> dict:
    """Grouped gadget key switching (ks_omega = 2) at the JAX bench's
    k8_omega configuration: the multiply, its batch, and the rotations,
    hoisted and not; then the CPU plain path, then times."""
    fhe = FHE(params_k8(), seed=2, device="cuda")
    prm = fhe.params
    check((prm.k, len(prm.bsk_primes)) == (8, 10), f"expected k = 8, kb = 10, got "
          f"{prm.k}, {len(prm.bsk_primes)}")
    t = prm.t
    vals_a = [[5 + i, 10 + i] for i in range(BATCH)]
    vals_b = [[3, 6 + i] for i in range(BATCH)]
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a, b = fhe.encrypt(fhe.encode([5, 10]), pk), fhe.encrypt(fhe.encode([3, 6]), pk)
    prod = fhe.multiply(a, b, rlk)
    cts_a = fhe.encrypt_batch([fhe.encode(v) for v in vals_a], pk)
    cts_b = fhe.encrypt_batch([fhe.encode(v) for v in vals_b], pk)
    prods = fhe.multiply_batch(cts_a, cts_b, rlk)
    gk = fhe.galoiskey_gen(sk, elements=HOIST)
    rot = fhe.rotate_rows(a, 1, gk)
    rot_b = fhe.rotate_rows_batch(cts_a, 1, gk)
    outs = fhe.rotate_rows_hoisted(a, STEPS, gk)
    outs_b = fhe.rotate_rows_hoisted_batch(cts_a[:C_HOIST], STEPS, gk)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase omega launches", json.dumps(launches))
    # at ks_omega = 2 a rotation keeps its automorphism launch (B16, and B14
    # for the batch) before the prereduced key switch
    reset_counts()
    fhe.rotate_rows(a, 1, gk)
    fhe.rotate_rows_batch(cts_a, 1, gk)
    torch.cuda.synchronize()
    rc = read_counts()
    check(rc["automorphism_single"] == 1 and rc["automorphism_fused"] == 1
          and rc["keyswitch_fused_prereduced"] == 1
          and rc["keyswitch_fused_batch_prereduced"] == 1
          and rc["keyswitch_fused_galois"] == 0 and rc["keyswitch_fused_batch_galois"] == 0,
          f"the rotations at ks_omega = 2 launched {rc}")
    for i in (0, BATCH - 1):
        check(torch.equal(rot_b[i].data, fhe.rotate_rows(cts_a[i], 1, gk).data),
              f"rotate_rows_batch element {i} differs from rotate_rows at ks_omega = 2")
    got = [int(fhe.decode(pt)[0]) for pt in fhe.decrypt_batch(rot_b, sk)]
    check(got == [v[1] for v in vals_a], f"rotate_rows_batch by 1 decoded {got}")
    check(rlk.data.shape[0] == 4, f"expected kd = 4 gadget digits, got {rlk.data.shape[0]}")
    dec = lambda c: [int(v) for v in fhe.decode(fhe.decrypt(c, sk))]
    check(dec(prod)[:2] == [15, 60], f"multiply decoded {dec(prod)[:2]}")
    want = [[x * y % t for x, y in zip(va, vb)] for va, vb in zip(vals_a, vals_b)]
    got = [[int(x) for x in fhe.decode(pt)[:2]] for pt in fhe.decrypt_batch(prods, sk)]
    check(got == want, f"multiply_batch decoded {got}, expected {want}")
    for i in range(BATCH):
        single = fhe.multiply(cts_a[i], cts_b[i], rlk)
        check(torch.equal(single.data, prods[i].data)
              and single.noise_budget == prods[i].noise_budget,
              f"multiply_batch element {i} differs from the single multiply")
    check(dec(rot)[0] == 10, f"rotate_rows by 1 decoded {dec(rot)[:2]}")
    check_hoisted(fhe, sk, a, [5, 10], outs, cts_a[:C_HOIST], vals_a[:C_HOIST], outs_b, gk)
    check_launched(launches, "omega")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(prm, device="cpu")
    to_cpu = lambda c: c.replace(data=c.data.cpu())
    sk_cpu = SecretKey(data=sk.data.cpu())
    gk_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk.data.items()})
    gen = torch.Generator(device="cuda").manual_seed(17)
    primes = fhe.ctx.ntt_q.p
    dr_a = torch.stack([sampling.uniform_rns(gen, primes, 1, N) for _ in range(4)])
    dr_e = torch.stack([sampling.gaussian_rns(gen, primes, 3.2, 1, N) for _ in range(4)])
    check(torch.equal(bfv.relinkey_gen_from_noise(fhe.ctx, sk, dr_a, dr_e).data.cpu(),
                      bfv.relinkey_gen_from_noise(cpu, sk_cpu, dr_a.cpu(), dr_e.cpu()).data),
          "card relinkey_gen_from_noise differs from the CPU plain path")
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    check(same_cts([prod], [bfv.multiply(cpu, to_cpu(a), to_cpu(b), rlk_cpu)]),
          "card multiply differs from the CPU plain path")
    check(same_cts([rot], [bfv.rotate_rows(cpu, to_cpu(a), 1, gk_cpu)]),
          "card rotate_rows differs from the CPU plain path")
    check(same_cts(outs, bfv.apply_galois_hoisted(cpu, to_cpu(a), HOIST, gk_cpu)),
          "card rotate_rows_hoisted differs from the CPU plain path")
    print(f"phase omega check: n={N}, k=8, kb=10, ks_omega=2, kd=4; multiply decoded "
          f"[15,60]; multiply_batch (B={BATCH}) decoded and element i == multiply; "
          "rotate_rows by 1 decoded 10, rotate_rows_batch (B16/B14 launches) decoded and "
          "element i == rotate_rows; rotate_rows_hoisted and rotate_rows_hoisted_batch "
          f"(C={C_HOIST}) as in the hoisted phase; card == CPU plain path for "
          "relinkey_gen_from_noise, multiply, rotate_rows and rotate_rows_hoisted")

    ops = {"multiply": lambda: fhe.multiply(a, b, rlk),
           "multiply_batch": lambda: fhe.multiply_batch(cts_a, cts_b, rlk)}
    wall = {op: wall_ms(fn) for op, fn in ops.items()}
    dev = {op: device_ms(fn) for op, fn in ops.items()}
    wall["multiply_batch_per_ciphertext"] = wall["multiply_batch"] / BATCH
    times = hoisted_timings(fhe, a, cts_a[:C_HOIST], gk)
    times["wall_ms"].update(wall)
    times["device_ms"].update(dev)
    for key, row in times.items():
        print(f"phase omega {key}", json.dumps(row))
    return launches


LEVEL_DEEP = 4      # the leveled path's deeper level: 4 of k = 8 primes left
SLOTS_A, SLOTS_B = [5, 10, 15, 20], [3, 6, 9, 12]


def leveled_times(fhe: FHE, a, b, rlk: RelinKeys) -> dict:
    """multiply at levels 0 and 1, the level-1 keys passed as they are
    (keys_at_level, as bench.py's mul_l1), wall and device ms, and the
    per-prime ratio (t_L1 / (k-1)) / (t_L0 / k) of bench.py's
    leveled_per_prime_ratio."""
    k = fhe.params.k
    a1, b1 = fhe.mod_switch_to_next(a), fhe.mod_switch_to_next(b)
    rlk1 = fhe._rlk_at(rlk, 1)
    ops = {"multiply_l0": lambda: bfv.multiply(fhe.ctx, a, b, rlk),
           "multiply_l1": lambda: bfv.multiply(fhe.ctx, a1, b1, rlk1, keys_at_level=True)}
    out = {}
    for what, timer in (("wall_ms", wall_ms), ("device_ms", device_ms)):
        t = {op: timer(fn) for op, fn in ops.items()}
        t["per_prime_ratio"] = (t["multiply_l1"] / (k - 1)) / (t["multiply_l0"] / k)
        out[what] = t
    return out


def phase_leveled() -> dict:
    """Every op below level 0 through the facade at the JAX bench's k8
    configuration, then the CPU plain path, the ks_omega = 2 levels, then
    times (also at the headline k = 3)."""
    fhe = FHE(params_leveled(), seed=19, device="cuda")
    prm, t, L = fhe.params, fhe.params.t, LEVEL_DEEP
    check((prm.k, len(prm.bsk_primes)) == (8, 10), f"expected k = 8, kb = 10, got "
          f"{prm.k}, {len(prm.bsk_primes)}")
    vals_a = [[5 + i, 10 + i] for i in range(BATCH)]
    vals_b = [[3, 6 + i] for i in range(BATCH)]
    two = fhe.encode([2, 2, 2, 2])
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=HOIST)
    gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    a, b = fhe.encrypt(fhe.encode(SLOTS_A), pk), fhe.encrypt(fhe.encode(SLOTS_B), pk)
    p0 = fhe.multiply(a, b, rlk)                                   # level 0
    p0_1, b1 = fhe.mod_switch_to_next(p0), fhe.mod_switch_to_next(b)
    p1 = fhe.multiply(p0_1, b1, rlk)                               # level 1
    d = fhe.mod_switch_to_level(p1, L)
    mp, ap = fhe.multiply_plain(d, two), fhe.add_plain(d, two)
    rot = fhe.rotate_rows(d, 1, gk)
    outs = fhe.rotate_rows_hoisted(d, STEPS, gk)
    d_c = [fhe.mod_switch_to_level(c, L) for c in fhe.encrypt_batch(
        [fhe.encode([v + 100 * c for v in SLOTS_A]) for c in range(C_HOIST)], pk)]
    outs_b = fhe.rotate_rows_hoisted_batch(d_c, STEPS, gk)
    total = fhe.sum_slots(d, gk_ss)
    cts_a = [fhe.mod_switch_to_level(c, 2) for c in
             fhe.encrypt_batch([fhe.encode(v) for v in vals_a], pk)]
    cts_b = [fhe.mod_switch_to_level(c, 2) for c in
             fhe.encrypt_batch([fhe.encode(v) for v in vals_b], pk)]
    prods = fhe.multiply_batch(cts_a, cts_b, rlk)
    # decryption is on the path too: the counts are read after the decodes
    dec = lambda c, m=4: [int(v) for v in fhe.decode(fhe.decrypt(c, sk))[:m]]
    abb = [x * y * y % t for x, y in zip(SLOTS_A, SLOTS_B)]
    for what, ct, want in (("multiply at level 0", p0, PRODUCT),
                           ("mod_switch_to_next", p0_1, PRODUCT),
                           ("multiply at level 1", p1, abb),
                           (f"mod_switch_to_level {L}", d, abb),
                           (f"multiply_plain at level {L}", mp, [2 * v for v in abb]),
                           (f"add_plain at level {L}", ap, [v + 2 for v in abb]),
                           (f"rotate_rows by 1 at level {L}", rot, abb[1:] + [0])):
        check(dec(ct) == want, f"{what} decoded {dec(ct)}, expected {want}")
    check((p1.level, d.level, rot.level) == (1, L, L), "unexpected levels")
    check_hoisted(fhe, sk, d, abb, outs, d_c,
                  [[v + 100 * c for v in SLOTS_A] for c in range(C_HOIST)], outs_b, gk)
    got = {int(v) for v in fhe.decode(fhe.decrypt(total, sk))}
    check(got == {sum(abb) % t}, f"sum_slots at level {L} decoded {sorted(got)[:4]}")
    want = [[x * y % t for x, y in zip(va, vb)] for va, vb in zip(vals_a, vals_b)]
    got = [[int(x) for x in fhe.decode(pt)[:2]] for pt in fhe.decrypt_batch(prods, sk)]
    check(got == want, f"multiply_batch at level 2 decoded {got}, expected {want}")
    for i in range(BATCH):
        check(torch.equal(prods[i].data, fhe.multiply(cts_a[i], cts_b[i], rlk).data),
              f"multiply_batch element {i} at level 2 differs from the single multiply")
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase leveled launches", json.dumps(launches))
    check_launched(launches, "leveled", LEVELED_KERNELS)

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(prm, device="cpu")
    to_cpu = lambda c: c.replace(data=c.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    gk3_cpu = GaloisKeys(data={3: gk.data[3].cpu()})
    check(torch.equal(fhe._rlk_cache[(id(rlk), 1)].data.cpu(),
                      bfv.switch_relin_keys(cpu, rlk_cpu, 1).data),
          "card switch_relin_keys (level 1) differs from the CPU plain path")
    check(torch.equal(fhe._gal_cache[(id(gk), L)].data[3].cpu(),
                      bfv.switch_galois_keys(cpu, gk3_cpu, L).data[3]),
          f"card switch_galois_keys (level {L}) differs from the CPU plain path")
    check(same_cts([p0], [bfv.multiply(cpu, to_cpu(a), to_cpu(b), rlk_cpu)]),
          "card multiply at level 0 differs from the CPU plain path")
    p0_1_cpu = bfv.mod_switch_to_next(cpu, to_cpu(p0))
    check(same_cts([p0_1], [p0_1_cpu]), "card mod_switch_to_next differs from the CPU")
    p1_cpu = bfv.multiply(cpu, p0_1_cpu, bfv.mod_switch_to_next(cpu, to_cpu(b)), rlk_cpu)
    check(same_cts([p1], [p1_cpu]), "card multiply at level 1 differs from the CPU")
    check(same_cts([d], [bfv.mod_switch_to_level(cpu, p1_cpu, L)]),
          "card mod_switch_to_level differs from the CPU plain path")
    check(same_cts([rot], [bfv.rotate_rows(cpu, to_cpu(d), 1, gk3_cpu)]),
          f"card rotate_rows at level {L} differs from the CPU plain path")
    print(f"phase leveled check: n={N}, k=8, kb=10; decoded multiply at levels 0 and 1, "
          f"the mod switches, multiply_plain, add_plain, rotate_rows, the hoisted "
          f"rotations (8 steps, batch of {C_HOIST}) and sum_slots at level {L}, "
          f"multiply_batch (B={BATCH}) at level 2 (element i == multiply); card == CPU "
          "plain path for switch_relin_keys, switch_galois_keys, multiply at levels 0 "
          "and 1, mod_switch_to_next, mod_switch_to_level and rotate_rows")

    # ks_omega = 2 at k = 8: level 2 keeps whole gadget groups, level 1 not
    fw = FHE(params_k8(), seed=21, device="cuda")
    pkw, skw = fw.keygen()
    rlkw = fw.relinkey_gen(skw)
    aw, bw = (fw.encrypt(fw.encode(v), pkw) for v in (SLOTS_A, SLOTS_B))
    pw = fw.multiply(fw.mod_switch_to_level(aw, 2), fw.mod_switch_to_level(bw, 2), rlkw)
    got = [int(v) for v in fw.decode(fw.decrypt(pw, skw))[:4]]
    check(got == PRODUCT, f"ks_omega=2 multiply at level 2 decoded {got}")
    a1w = fw.mod_switch_to_next(aw)
    try:
        fw.multiply(a1w, a1w, rlkw)
        raised = False
    except ValueError as err:
        raised = "gadget groups" in str(err)
    check(raised, "ks_omega=2 multiply at level 1 did not raise")
    print("phase leveled omega check: k=8, ks_omega=2: multiply at level 2 decoded "
          f"{PRODUCT}; level 1 raised")

    times = {"k8": leveled_times(fhe, a, b, rlk)}
    head = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=23, device="cuda")
    pkh, skh = head.keygen()
    rlkh = head.relinkey_gen(skh)
    ah, bh = (head.encrypt(head.encode(v), pkh) for v in (SLOTS_A, SLOTS_B))
    times["k3"] = leveled_times(head, ah, bh, rlkh)
    for cfg, row in times.items():
        for what, t in row.items():
            print(f"phase leveled {cfg} multiply {what}", json.dumps(t))
    gk_l = fhe._gal_at(gk, L)
    ops = {"mod_switch_to_next": lambda: fhe.mod_switch_to_next(p0),
           "switch_relin_keys_l1": lambda: bfv.switch_relin_keys(fhe.ctx, rlk, 1),
           f"switch_relin_keys_l{L}": lambda: bfv.switch_relin_keys(fhe.ctx, rlk, L),
           f"rotate_rows_1_l{L}": lambda: bfv.rotate_rows(fhe.ctx, d, 1, gk_l,
                                                          keys_at_level=True),
           f"rotate_rows_1_l0": lambda: fhe.rotate_rows(a, 1, gk),
           f"rotate_rows_hoisted_8_l{L}": lambda: fhe.rotate_rows_hoisted(d, STEPS, gk),
           f"multiply_batch_B{BATCH}_l2": lambda: fhe.multiply_batch(cts_a, cts_b, rlk)}
    print("phase leveled k8 wall_ms", json.dumps({op: wall_ms(fn) for op, fn in ops.items()}))
    print("phase leveled k8 device_ms",
          json.dumps({op: device_ms(fn) for op, fn in ops.items()}))
    return launches


def phase_small() -> dict:
    """The n < 1024 multiply (tensor_product's Lift lane, fast_floor_fused)
    at levels 0, 1 and 2 and multiply_batch at level 1, then the CPU plain
    path, then times, and what one multiply launches."""
    fhe = FHE(params_small(), seed=29, device="cuda")
    n, t = fhe.params.n, fhe.params.t
    check((n, fhe.params.k) == (256, 5), f"expected n = 256, k = 5, got {n}, {fhe.params.k}")
    vals_a = [[5 + i, 10 + i] for i in range(BATCH)]
    vals_b = [[3, 6 + i] for i in range(BATCH)]
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a, b = fhe.encrypt(fhe.encode(SLOTS_A), pk), fhe.encrypt(fhe.encode(SLOTS_B), pk)
    pairs = {lv: (fhe.mod_switch_to_level(a, lv), fhe.mod_switch_to_level(b, lv))
             for lv in (0, 1, 2)}
    prods = {lv: fhe.multiply(x, y, rlk) for lv, (x, y) in pairs.items()}
    cts_a = [fhe.mod_switch_to_next(c) for c in
             fhe.encrypt_batch([fhe.encode(v) for v in vals_a], pk)]
    cts_b = [fhe.mod_switch_to_next(c) for c in
             fhe.encrypt_batch([fhe.encode(v) for v in vals_b], pk)]
    batch = fhe.multiply_batch(cts_a, cts_b, rlk)
    for lv, ct in prods.items():
        got = [int(v) for v in fhe.decode(fhe.decrypt(ct, sk))[:4]]
        check(got == PRODUCT and ct.level == lv,
              f"multiply at level {lv} (n=256) decoded {got}")
    want = [[x * y % t for x, y in zip(va, vb)] for va, vb in zip(vals_a, vals_b)]
    got = [[int(x) for x in fhe.decode(pt)[:2]] for pt in fhe.decrypt_batch(batch, sk)]
    check(got == want, f"multiply_batch at level 1 (n=256) decoded {got}")
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase small launches", json.dumps(launches))
    check_launched(launches, "small", SMALL_KERNELS)

    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda c: c.replace(data=c.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    for lv, (x, y) in pairs.items():
        check(same_cts([prods[lv]], [bfv.multiply(cpu, to_cpu(x), to_cpu(y), rlk_cpu)]),
              f"card multiply at level {lv} (n=256) differs from the CPU plain path")
    check(same_cts(batch, bfv.multiply_batch(cpu, [to_cpu(c) for c in cts_a],
                                             [to_cpu(c) for c in cts_b], rlk_cpu)),
          "card multiply_batch (n=256) differs from the CPU plain path")
    print(f"phase small check: n=256, k=5; multiply at levels 0, 1, 2 and multiply_batch "
          f"(B={BATCH}) at level 1 decoded; card == CPU plain path for each")
    rlk1 = fhe._rlk_at(rlk, 1)
    ops = {f"multiply_l{lv}": (lambda x=x, y=y, lv=lv: bfv.multiply(
        fhe.ctx, x, y, fhe._rlk_at(rlk, lv), keys_at_level=True))
        for lv, (x, y) in pairs.items()}
    ops["multiply_no_relin_l1"] = lambda: fhe.multiply_no_relin(*pairs[1])
    ops[f"multiply_batch_B{BATCH}_l1"] = lambda: bfv.multiply_batch(
        fhe.ctx, cts_a, cts_b, rlk1, keys_at_level=True)
    print("phase small wall_ms", json.dumps({op: wall_ms(fn) for op, fn in ops.items()}))
    print("phase small device_ms", json.dumps({op: device_ms(fn) for op, fn in ops.items()}))
    # one multiply forms both products and the lift in one launch (the Lift
    # lane), and floors and converts to q in one more: no B6 of its own, and
    # no cat
    before = read_counts()
    ops["multiply_l0"]()
    torch.cuda.synchronize()
    one = {name: c - before[name] for name, c in read_counts().items()}
    want = {"tensor_product_lift": 1, "tensor_product": 0, "fast_floor_fused": 1,
            "fast_bconv_sk_fused": 0, "bsk_branch_fused": 0}
    got = {name: one[name] for name in want}
    check(got == want, f"the n=256 multiply launched {got}, expected {want}")
    names = profiled_kernels(ops["multiply_l0"])
    cats = [name for name in names if "CatArray" in name]      # torch.cat's kernels
    check(not cats, f"the n=256 multiply launched {cats}")
    print("phase small one multiply", json.dumps({"launches": got,
                                                  "kernels_per_call": len(names)}))
    print_profiled("small", {op: ops[op] for op in ("multiply_l0", "multiply_l1",
                                                    "multiply_no_relin_l1")})
    return launches


ROOF_REPS = (64, 320)


def phase_roofline(gen: torch.Generator) -> dict:
    """B19 at two reps values per variant: the slope over reps cancels the
    launch and the memory traffic, as the JAX bench's two-point chains do."""
    ctx = make_context(make_scheme_params(SecurityParams(
        poly_degree=N, log_q=LOG_Q, hamming_weight=H)), device="cuda")
    x, consts = chain_input(gen, ctx)
    elems = x.numel()
    runs = [(v, 1) for v in ubench.VARIANTS] + [("lazy", 2), ("lazy", 4)]
    reset_counts()
    ms = {(v, ilp, r): device_ms(lambda v=v, ilp=ilp, r=r: ubench.modmul_chain(
        x, *consts, r, v, ilp=ilp)) for v, ilp in runs for r in ROOF_REPS}
    torch.cuda.synchronize()
    launches = read_counts()
    check_launched(launches, "roofline")
    steps = {}                              # chain steps per second
    for v, ilp in runs:
        slope_s = (ms[(v, ilp, ROOF_REPS[1])] - ms[(v, ilp, ROOF_REPS[0])]) * 1e-3 / (
            ROOF_REPS[1] - ROOF_REPS[0])
        check(slope_s > 0, f"modmul_chain {v} ilp={ilp}: no slope over reps")
        steps[(v, ilp)] = elems * ilp / slope_s
    out = {f"{v}_gmodmul_per_s": steps[(v, 1)] / 1e9 for v in ("exact", "lazy", "barrett")}
    out.update({f"{v}_tops_per_s": steps[(v, 1)] * CHAIN_OPS[v] / 1e12
                for v in ("mul17", "cheap17")})
    out.update({f"lazy_ilp{i}_gmodmul_per_s": steps[("lazy", i)] / 1e9 for i in (2, 4)})
    for v in ("exact", "lazy", "barrett"):
        ops_per_s = steps[(v, 1)] * CHAIN_OPS[v]
        out[f"{v}_share_of_one_pipe"] = ops_per_s / INT32_PIPE_OPS_PER_S
        out[f"{v}_share_of_int32_peak"] = ops_per_s / INT32_OPS_PER_S
    out["exact_one_pipe_gmodmul_per_s"] = INT32_PIPE_OPS_PER_S / CHAIN_OPS["exact"] / 1e9
    out["device_ms"] = {f"{v}_ilp{ilp}_reps{r}": t for (v, ilp, r), t in ms.items()}
    print("phase roofline", json.dumps(out))
    return launches


# the BGV path's kernels (B1-B4, B7 and its Galois lane, B11, B12, the Galois
# lanes of B17/B18, and sum_slots' B17 Inner lane and B15), and the kernels
# only BFV runs: the BEHZ branch and conversions (B5, B6, B9, B10), B8's
# fused BFV decrypt, and B13 (BGV has no encrypt_batch)
BGV_KERNELS = ("ntt_forward", "ntt_inverse", "mul_by_ntt_operand", "tensor_product",
               "keyswitch_fused", "keyswitch_fused_galois", "tensor_product_batch",
               "keyswitch_fused_batch", "ks_inner_batch_galois", "ks_inner_grouped_galois",
               "ks_inner_batch", "automorphism_fused_sum")
BFV_ONLY_KERNELS = ("bsk_branch_fused", "fast_bconv_sk_fused", "decrypt_fused",
                    "bsk_branch_fused_batch", "tensor_product_lift", "fast_floor_fused",
                    "mul_by_ntt_operand_batch")


def phase_bgv() -> dict:
    """BGV through the facade at the JAX bench's g_bgv configuration, then the
    same state through the plain versions on the CPU, then the multiply's
    times and kernels beside BFV's, and the noise budgets of both schemes."""
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=1, scheme="bgv",
              device="cuda")
    prm, t = fhe.params, fhe.params.t
    check((prm.k, t) == (3, 65537), f"expected k = 3, t = 65537, got {prm.k}, {t}")
    dec = lambda ct, count=4: [int(v) for v in fhe.decode(fhe.decrypt(ct, sk))[:count]]
    vals_c = [[v + 100 * c for v in VALS_H] for c in range(C_HOIST)]
    reset_counts()
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3, 2 * N - 1))
    gk_h = fhe.galoiskey_gen(sk, elements=HOIST)
    gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    p1 = fhe.encode([5, 10, 15, 20])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    m3 = fhe.multiply_no_relin(c1, c2)
    relin = fhe.relinearize(m3, rlk)
    prod = fhe.multiply(c1, c2, rlk)
    cts_a = [fhe.encrypt(fhe.encode(v), pk) for v in VALS_A]
    cts_b = [fhe.encrypt(fhe.encode(v), pk) for v in VALS_B]
    prods = fhe.multiply_batch(cts_a, cts_b, rlk)
    rot, cols = fhe.rotate_rows(c1, 1, gk), fhe.rotate_columns(c1, gk)
    cts_h = [fhe.encrypt(fhe.encode(v), pk) for v in vals_c]
    outs = fhe.rotate_rows_hoisted(c1, STEPS, gk_h)
    outs_b = fhe.rotate_rows_hoisted_batch(cts_h, STEPS, gk_h)
    total = fhe.sum_slots(c1, gk_ss)
    low = fhe.mod_switch_to_next(prod)
    low_add = fhe.add_plain(low, fhe.encode([1, 2, 3, 4]))
    low_mul = fhe.multiply_plain(low, fhe.encode([2, 2, 2, 2]))
    low_rot = fhe.rotate_rows(low, 1, gk)
    low_sq = fhe.multiply(low, low, rlk)
    decoded = {"multiply_no_relin": dec(m3), "relinearize": dec(relin), "multiply": dec(prod),
               "mod_switch_to_next": dec(low), "add_plain_l1": dec(low_add),
               "multiply_plain_l1": dec(low_mul), "rotate_rows_l1": dec(low_rot, 3),
               "rotate_rows": dec(rot, N // 2), "rotate_columns": dec(cols, N),
               "multiply_batch": [dec(c) for c in prods],
               "sum_slots": sorted({int(v) for v in fhe.decode(fhe.decrypt(total, sk))})}
    mismatch = None
    try:
        fhe.add(low_sq, low)
    except ValueError as err:
        mismatch = str(err)
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase bgv launches", json.dumps(launches))
    for what in ("multiply_no_relin", "relinearize", "multiply", "mod_switch_to_next"):
        check(decoded[what] == PRODUCT, f"BGV {what} decoded {decoded[what]}")
    check(decoded["add_plain_l1"] == [16, 62, 138, 244]
          and decoded["multiply_plain_l1"] == [30, 120, 270, 480]
          and decoded["rotate_rows_l1"] == [60, 135, 240],
          f"BGV at level 1 decoded {decoded}")
    check(low.level == 1 and low.scale_t == prm.q_primes[-1] % t != 1
          and low_sq.scale_t == low.scale_t ** 2 % t, f"BGV scale_t {low.scale_t}")
    check(mismatch is not None and "scale_t" in mismatch,
          "BGV add of mismatched scale_t did not raise")
    check(decoded["rotate_rows"] == rotated([5, 10, 15, 20], 1),
          f"BGV rotate_rows decoded {decoded['rotate_rows'][:6]}")
    check(decoded["rotate_columns"][N // 2:N // 2 + 4] == [5, 10, 15, 20]
          and decoded["rotate_columns"][:4] == [0] * 4, "BGV rotate_columns decoded wrong")
    want_b = [[x * y % t for x, y in zip(a, b)] for a, b in zip(VALS_A, VALS_B)]
    check(decoded["multiply_batch"] == want_b,
          f"BGV multiply_batch decoded {decoded['multiply_batch']}")
    check(decoded["sum_slots"] == [50], f"BGV sum_slots decoded {decoded['sum_slots'][:4]}")
    check_hoisted(fhe, sk, c1, [5, 10, 15, 20], outs, cts_h, vals_c, outs_b, gk_h)
    for i in range(BATCH):
        single = fhe.multiply(cts_a[i], cts_b[i], rlk)
        check(torch.equal(single.data, prods[i].data)
              and single.noise_budget == prods[i].noise_budget,
              f"BGV multiply_batch element {i} differs from the single multiply")
    check_launched(launches, "bgv", BGV_KERNELS)
    ran = {name: launches[name] for name in BFV_ONLY_KERNELS if launches[name]}
    check(not ran, f"the BGV path launched BFV-only kernels {ran}")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(prm, device="cpu")
    to_cpu = lambda c: c.replace(data=c.data.cpu())
    sk_cpu, pk_cpu = SecretKey(data=sk.data.cpu()), PublicKey(data=pk.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    gk_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk.data.items()})
    gk_h_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk_h.data.items()})
    gen = torch.Generator(device="cuda").manual_seed(37)
    primes = fhe.ctx.ntt_q.p
    s, a, e = (sampling.ternary_rns(gen, primes, 1, N, H), sampling.uniform_rns(gen, primes, 1, N),
               sampling.gaussian_rns(gen, primes, 3.2, 1, N))
    keys_card, keys_cpu = (bgv.keygen_from_noise(fhe.ctx, s, a, e),
                           bgv.keygen_from_noise(cpu, s.cpu(), a.cpu(), e.cpu()))
    check(all(torch.equal(x.data.cpu(), y.data) for x, y in zip(keys_card, keys_cpu)),
          "card BGV keygen_from_noise differs from the CPU plain path")
    ka = torch.stack([torch.stack([sampling.uniform_rns(gen, primes, 1, N) for _ in range(3)])
                      for _ in range(2)])
    ke = torch.stack([torch.stack([sampling.gaussian_rns(gen, primes, 3.2, 1, N)
                                   for _ in range(3)]) for _ in range(2)])
    check(torch.equal(bgv.relinkey_gen_from_noise(fhe.ctx, sk, ka[0], ke[0]).data.cpu(),
                      bgv.relinkey_gen_from_noise(cpu, sk_cpu, ka[0].cpu(), ke[0].cpu()).data),
          "card BGV relinkey_gen_from_noise differs from the CPU plain path")
    gcard = bgv.galoiskey_gen_from_noise(fhe.ctx, sk, (3, 2 * N - 1), ka, ke)
    gplain = bgv.galoiskey_gen_from_noise(cpu, sk_cpu, (3, 2 * N - 1), ka.cpu(), ke.cpu())
    check(all(torch.equal(gcard.data[g].cpu(), gplain.data[g]) for g in gplain.data),
          "card BGV galoiskey_gen_from_noise differs from the CPU plain path")
    # u = s and e1 = e2 = e: any residues serve to compare the two paths
    enc_card = bgv.encrypt_from_noise(fhe.ctx, pk, p1, s, e, e)
    enc_cpu = bgv.encrypt_from_noise(cpu, pk_cpu, Plaintext(data=p1.data.cpu()), s.cpu(),
                                     e.cpu(), e.cpu())
    check(torch.equal(enc_card.data.cpu(), enc_cpu.data),
          "card BGV encrypt_from_noise differs from the CPU plain path")
    m3_cpu = bgv.multiply_no_relin(cpu, to_cpu(c1), to_cpu(c2))
    prod_cpu = bgv.multiply(cpu, to_cpu(c1), to_cpu(c2), rlk_cpu)
    low_cpu = bgv.mod_switch_to_next(cpu, prod_cpu)
    pairs = {
        "multiply_no_relin": ([m3], [m3_cpu]),
        "relinearize": ([relin], [bgv.relinearize(cpu, m3_cpu, rlk_cpu)]),
        "multiply": ([prod], [prod_cpu]),
        "multiply_batch": (prods, bgv.multiply_batch(cpu, [to_cpu(c) for c in cts_a],
                                                     [to_cpu(c) for c in cts_b], rlk_cpu)),
        "mod_switch_to_next": ([low], [low_cpu]),
        "rotate_rows": ([rot], [bgv.rotate_rows(cpu, to_cpu(c1), 1, gk_cpu)]),
        "rotate_columns": ([cols], [bgv.rotate_columns(cpu, to_cpu(c1), gk_cpu)]),
        "rotate_rows_hoisted": (outs, bgv.apply_galois_hoisted(cpu, to_cpu(c1), HOIST,
                                                               gk_h_cpu)),
        "add_plain_l1": ([low_add], [bgv.add_plain(cpu, low_cpu, Plaintext(
            data=fhe.encode([1, 2, 3, 4]).data.cpu()))]),
        "rotate_rows_l1": ([low_rot], [bgv.rotate_rows(cpu, low_cpu, 1, gk_cpu)]),
    }
    for what, (card, plain) in pairs.items():
        check(same_cts(card, plain) and all(x.scale_t == y.scale_t and x.level == y.level
                                            for x, y in zip(card, plain)),
              f"card BGV {what} differs from the CPU plain path")
    for what, ct, ct_cpu in (("3-component", m3, m3_cpu), ("level-1", low, low_cpu)):
        check(torch.equal(fhe.decrypt(ct, sk).data.cpu(), bgv.decrypt(cpu, ct_cpu, sk_cpu).data),
              f"card BGV {what} decrypt differs from the CPU plain path")
    print(f"phase bgv check: n={N}, k=3, t={t}; decoded {PRODUCT} (multiply_no_relin, the "
          "3-component decrypt, relinearize, multiply, mod_switch_to_next), multiply_batch "
          f"(B={BATCH}, element i == multiply), rotate_rows, rotate_columns, the hoisted "
          f"rotations, sum_slots; at level 1 (scale_t {low.scale_t}) add_plain, "
          "multiply_plain, rotate_rows, and the mismatched add raised; no BFV-only kernel "
          "launched; card == CPU plain path for the keys from noise, encrypt_from_noise, "
          f"{', '.join(pairs)} and the decrypts, scale_t included")

    # BGV's multiply beside the BFV headline multiply, measured in the same run
    bfv_fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=3, device="cuda")
    bpk, bsk = bfv_fhe.keygen()
    brlk = bfv_fhe.relinkey_gen(bsk)
    b1 = bfv_fhe.encrypt(bfv_fhe.encode([5, 10, 15, 20]), bpk)
    b2 = bfv_fhe.encrypt(bfv_fhe.encode([3, 6, 9, 12]), bpk)
    bprod = bfv_fhe.multiply(b1, b2, brlk)
    ops = {"bgv_multiply_relin": lambda: fhe.multiply(c1, c2, rlk),
           "bfv_multiply_relin": lambda: bfv_fhe.multiply(b1, b2, brlk),
           "bgv_multiply_no_relin": lambda: fhe.multiply_no_relin(c1, c2),
           "bgv_relinearize": lambda: fhe.relinearize(m3, rlk),
           "bgv_decrypt": lambda: fhe.decrypt(prod, sk),
           "bgv_mod_switch_to_next": lambda: fhe.mod_switch_to_next(prod),
           "bgv_rotate_rows_1": lambda: fhe.rotate_rows(c1, 1, gk),
           f"bgv_multiply_batch_B{BATCH}": lambda: fhe.multiply_batch(cts_a, cts_b, rlk)}
    wall = {op: wall_ms(fn) for op, fn in ops.items()}
    dev = {op: device_ms(fn) for op, fn in ops.items()}
    print("phase bgv wall_ms", json.dumps(wall))
    print("phase bgv device_ms", json.dumps(dev))
    print("phase bgv bgv_multiply_relin_ms", json.dumps({
        "wall_ms": wall["bgv_multiply_relin"], "device_ms": dev["bgv_multiply_relin"],
        "bfv_headline_wall_ms": wall["bfv_multiply_relin"],
        "bfv_headline_device_ms": dev["bfv_multiply_relin"]}))
    print_profiled("bgv", {op: ops[op] for op in (
        "bgv_multiply_relin", "bfv_multiply_relin", "bgv_multiply_no_relin", "bgv_decrypt")})
    budgets = {}
    for scheme, f, s_, fresh, product, vals in (
            ("bgv", fhe, sk, c1, prod, [5, 10, 15, 20]),
            ("bfv", bfv_fhe, bsk, b1, bprod, [5, 10, 15, 20])):
        budgets[scheme] = {
            "fresh_estimate": f.estimate_noise_budget(fresh, s_),
            "fresh_exact": f.exact_noise_budget(fresh, s_, f.encode(vals)),
            "fresh_tracked": fresh.noise_budget,
            "product_estimate": f.estimate_noise_budget(product, s_),
            "product_exact": f.exact_noise_budget(product, s_, f.encode(PRODUCT)),
            "product_tracked": product.noise_budget}
        check(budgets[scheme]["fresh_estimate"] > budgets[scheme]["product_estimate"] > 10,
              f"{scheme} noise budgets {budgets[scheme]}")
    print("phase bgv noise_budget_bits", json.dumps(budgets))
    return launches


# the JAX bench's g_bootstrap (bench.py:833-840): n = 1024, log_q = 120 (k = 4),
# lambda_ = 0, h = 16, seed 5; and tests/test_bootstrap.py's n = 256
BOOT_N, BOOT_LOG_Q, BOOT_H = 1024, 120, 16
BOOT_LUT = [0, 1, 4, 4]
BOOT_TRUNC = 16        # steps of the truncated rotation held against the CPU
# the kernels of the bootstrap path (its input's keygen and encrypt, and the
# decrypt of its outputs included) and those it must never launch
BOOTSTRAP_KERNELS = ("ntt_forward", "ntt_inverse", "mul_by_ntt_operand", "decrypt_fused",
                     "keyswitch_fused", "keyswitch_fused_batch")
NOT_BOOTSTRAP_KERNELS = tuple(name for name in KERNELS if name not in BOOTSTRAP_KERNELS)


def boot_fhe(n: int, seed: int) -> FHE:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FHE(poly_degree=n, log_q=BOOT_LOG_Q, lambda_=0, hamming_weight=BOOT_H,
                   seed=seed, device="cuda")


def trace_span(fn) -> dict:
    """Device kernels of one call of fn() (``device_kernels``), the span from
    the first kernel's start to the last one's end, the time inside kernels,
    and the idle share of the span."""
    ks = device_kernels(fn)
    if not ks:
        return {"kernels": 0}
    span = ks[-1][1] - ks[0][0]
    inside = sum(e - s for s, e, _ in ks)
    return {"kernels": len(ks), "keyswitch_kernels": sum("keyswitch" in x for *_, x in ks),
            "span_us": span, "in_kernels_us": inside, "idle_share": 1 - inside / span}


def bootstrap_kernel_cases(gen: torch.Generator, ctx) -> list:
    """Each kernel of the bootstrap path at the shapes it gives it, n = 1024,
    k = 4: B7 on an external product's digits [2k, n] of both accumulator
    components against a coefficient's RGSW rows read in place ([k, 2k, 2, n]
    view of the stored [2k, k, 2, n] rows; the final key switch is B7's
    headline lane), B12 on the batch's [2k, 8, n]; B1 on the key's draw
    stack [k, 4nk, n] (make_bootstrap_key transforms a and e so), B2 on
    the secret [k, 1, n], B3 on encrypt's u [k, 1, n] against pk [k, 2, n],
    and B8 on views of a [k, 1, 2, n] ciphertext."""
    tb, n, k = ctx.ntt_q, ctx.n, ctx.k
    qs = tb.primes
    rows = torch.stack([residues(gen, qs, 2, n) for _ in range(2 * k)])   # [2k, k, 2, n]
    keys_t = rows.permute(1, 0, 2, 3)
    d = torch.cat([torch.stack([residues(gen, (q,), 1, n)[0, 0] for q in qs])] * 2)
    db = torch.cat([torch.stack([residues(gen, (q,), BATCH, n)[0] for q in qs])] * 2)
    draws = residues(gen, qs, 4 * n * k, n)          # a (or e): n * 2 signs * 2k rows
    s1, u, w = residues(gen, qs, 1, n), residues(gen, qs, 1, n), residues(gen, qs, 2, n)
    return [("keyswitch_fused", f"external product: d [{2 * k},{n}], rows [{2 * k},{k},2,{n}]",
             lambda: ntt_cuda.keyswitch_fused(d, keys_t, tb),
             lambda: plain_ntt.keyswitch_fused(d, keys_t, tb),
             keyswitch_work(k, 2 * k, 1, n=n)),
            ("keyswitch_fused_batch",
             f"batched external product: d [{2 * k},{BATCH},{n}], rows [{2 * k},{k},2,{n}]",
             lambda: ntt_cuda.keyswitch_fused_batch(db, keys_t, tb),
             lambda: plain_ntt.keyswitch_fused_batch(db, keys_t, tb),
             keyswitch_work(k, 2 * k, BATCH, n=n)),
            ("ntt_forward", f"bootstrap key draws [{k},{draws.shape[1]},{n}]",
             lambda: ntt_cuda.ntt_forward(draws, tb), lambda: plain_ntt.ntt_forward(draws, tb),
             ntt_work(k, draws.shape[1], False, n)),
            ("ntt_inverse", f"secret [{k},1,{n}]",
             lambda: ntt_cuda.ntt_inverse(s1, tb), lambda: plain_ntt.ntt_inverse(s1, tb),
             ntt_work(k, 1, True, n)),
            ("mul_by_ntt_operand", f"u [{k},1,{n}], w [{k},2,{n}]",
             lambda: ntt_cuda.mul_by_ntt_operand(u, w, tb),
             lambda: plain_ntt.mul_by_ntt_operand(u, w, tb), mul_work(k, 2, 1, n)),
            decrypt_case(gen, ctx.params, 0, 1, "bootstrap decrypt")]


def check_bootstrap_small() -> None:
    """tests/test_bootstrap.py's configuration (n = 256, k = 4): the whole
    pipeline on the card equals the CPU plain path: extract_payload (w = 1
    and 3), make_bootstrap_key_from_noise and bootstrap_binary."""
    fhe = boot_fhe(256, 3)
    ctx, n = fhe.ctx, fhe.params.n
    cpu = make_context(fhe.params, device="cpu")
    pk, sk = fhe.keygen()
    sk_cpu = SecretKey(data=sk.data.cpu())
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    ct = fhe.encrypt(fhe.encode_coeff([1]), pk)
    for w in (1, 3):
        lwe, lwe_cpu = (bootstrap.extract_payload(ctx, ct, w),
                        bootstrap.extract_payload(cpu, to_cpu(ct), w))
        check(torch.equal(lwe.a.cpu(), lwe_cpu.a) and int(lwe.b) == int(lwe_cpu.b),
              f"card extract_payload (w={w}) differs from the CPU plain path")
    gen = torch.Generator(device="cuda").manual_seed(29)
    total = n * 2 * 2 * ctx.k
    a = sampling.uniform_rns(gen, ctx.ntt_q.p, total, n)
    e = sampling.gaussian_rns(gen, ctx.ntt_q.p, 3.2, total, n)
    bsk = bootstrap.make_bootstrap_key_from_noise(ctx, sk, a, e)
    bsk_c = bootstrap.make_bootstrap_key_from_noise(cpu, sk_cpu, a.cpu(), e.cpu())
    check(torch.equal(bsk.pos.cpu(), bsk_c.pos) and torch.equal(bsk.neg.cpu(), bsk_c.neg),
          "card make_bootstrap_key_from_noise differs from the CPU plain path")
    ks = bootstrap.keyswitch_keygen(ctx, fhe.gen, sk, sk)
    out = bootstrap.bootstrap_binary(ctx, None, ct, sk, bsk, ks)
    out_cpu = bootstrap.bootstrap_binary(cpu, None, to_cpu(ct), sk_cpu, bsk_c, ks.cpu())
    check(torch.equal(out.data.cpu(), out_cpu.data) and out.noise_budget == out_cpu.noise_budget,
          "card bootstrap_binary at n=256 differs from the CPU plain path")
    check(int(fhe.decode_coeff(fhe.decrypt(out, sk))[0]) == 1, "n=256 bootstrap decoded wrong")
    print("phase bootstrap check n=256: card == CPU plain path for extract_payload (w = 1, "
          "3), make_bootstrap_key_from_noise and bootstrap_binary (decodes 1)")


def phase_bootstrap(gen: torch.Generator) -> dict:
    """The bootstrapping pipeline through the facade at the JAX bench's
    g_bootstrap configuration, then the card against the CPU plain path
    (whole at n = 256, a CMUX gate, its external product and the first
    BOOT_TRUNC steps of the rotation at n = 1024), then times and a
    trace."""
    fhe = boot_fhe(BOOT_N, 5)
    ctx, n, prm = fhe.ctx, BOOT_N, fhe.params
    check(prm.k == 4, f"expected k = 4 at log_q = {BOOT_LOG_Q}, got {prm.k}")
    dec0 = lambda ct: int(fhe.decode_coeff(fhe.decrypt(ct, sk))[0])
    enc = lambda m: fhe.encrypt(fhe.encode_coeff([m]), pk)
    reset_counts()
    pk, sk = fhe.keygen()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bsk = fhe.make_bootstrap_key(sk)
    torch.cuda.synchronize()
    bsk_s = time.perf_counter() - t0
    bsk1 = fhe.make_bootstrap_key(sk, level=1)
    cts8 = [enc(i % 2) for i in range(BATCH)]
    cts_bit = cts8[:2]                 # bits 0 and 1, also elements 0 and 1 of the batch
    ct_l1 = fhe.mod_switch_to_next(enc(1))
    cts_lut = [enc(m) for m in range(len(BOOT_LUT))]
    fhe._bootstrap_ks(sk)              # the facade's switching keys, made once per sk
    torch.cuda.synchronize()
    before = read_counts()
    out_bit = [fhe.bootstrap_binary(c, sk, bsk) for c in cts_bit]
    torch.cuda.synchronize()
    mid = read_counts()
    outs8 = fhe.bootstrap_binary_batch(cts8, sk, bsk)
    torch.cuda.synchronize()
    after = read_counts()
    out_l1 = fhe.bootstrap_binary(ct_l1, sk, bsk1)
    outs_lut = [fhe.bootstrap_lut(c, BOOT_LUT, sk, bsk) for c in cts_lut]
    decoded = {"binary": [dec0(o) for o in out_bit], "level1": dec0(out_l1),
               "lut": [dec0(o) for o in outs_lut], "batch": [dec0(o) for o in outs8]}
    torch.cuda.synchronize()
    launches = read_counts()
    print("phase bootstrap launches", json.dumps(launches))
    print("phase bootstrap decoded", json.dumps(decoded))
    check(decoded["binary"] == [0, 1] and decoded["level1"] == 1, f"decoded {decoded}")
    check(decoded["lut"] == BOOT_LUT, f"bootstrap_lut decoded {decoded['lut']}")
    check(decoded["batch"] == [i % 2 for i in range(BATCH)], f"batch decoded {decoded}")
    check(out_l1.level == 0 and all(o.level == 0 for o in out_bit + outs8 + outs_lut),
          "a bootstrap output is not at level 0")
    for i in (0, 1):
        check(torch.equal(outs8[i].data, out_bit[i].data)
              and outs8[i].noise_budget == out_bit[i].noise_budget,
              f"bootstrap_binary_batch element {i} differs from bootstrap_binary")
    delta = lambda a, b, name: b[name] - a[name]
    per_single = {name: delta(before, mid, name) / 2 for name in ("keyswitch_fused",
                                                                  "keyswitch_fused_batch")}
    per_batch = {name: delta(mid, after, name) for name in ("keyswitch_fused",
                                                            "keyswitch_fused_batch")}
    print("phase bootstrap launches per call", json.dumps(
        {"bootstrap_binary": per_single, f"bootstrap_binary_batch_B{BATCH}": per_batch}))
    # n steps of two external products, then the final key switch
    check(per_single == {"keyswitch_fused": 2 * n + 1, "keyswitch_fused_batch": 0},
          f"bootstrap_binary launched {per_single}, expected {2 * n + 1} keyswitch_fused")
    check(per_batch == {"keyswitch_fused": BATCH, "keyswitch_fused_batch": 2 * n},
          f"bootstrap_binary_batch launched {per_batch}")
    check_launched(launches, "bootstrap", BOOTSTRAP_KERNELS)
    ran = {name: launches[name] for name in NOT_BOOTSTRAP_KERNELS if launches[name]}
    check(not ran, f"the bootstrap path launched {ran}")

    # card == CPU plain path: the whole pipeline at n = 256; at n = 1024 a
    # CMUX gate, its external product and the first BOOT_TRUNC steps of the
    # rotation
    check_bootstrap_small()
    cpu = make_context(prm, device="cpu")
    # one CMUX gate, as the rotation calls it, and the external product in
    # it, on a contiguous component-major accumulator, as the rotation holds
    # it: [2, k, n], and [2, k, B, n] with a rotation per sample
    acc = cts_bit[1].data.transpose(0, 1).contiguous()
    acc_b = torch.stack([c.data for c in cts8], dim=2).transpose(0, 1).contiguous()
    rows = bsk.pos[3]
    table = bootstrap._shift_table(n, acc.device)
    idx, idx_b = table[5], table[torch.arange(BATCH, device=acc.device) + 5]

    def gate_args(c, x: torch.Tensor) -> tuple:
        tb = bfv._tb(c, 0)
        return (bootstrap._keys_t(rows.to(tb.device)), tb,
                *bootstrap._cmux_consts(tb, c.inv_qhat_levels[0], x.dim()))

    args, args_b = gate_args(ctx, acc), gate_args(ctx, acc_b)
    gates = {"_external_product": (lambda: bootstrap._external_product(acc, *args),
                                   lambda: bootstrap._external_product(
                                       acc.cpu(), *gate_args(cpu, acc)), "keyswitch_fused"),
             "_external_product batch": (lambda: bootstrap._external_product(acc_b, *args_b),
                                         lambda: bootstrap._external_product(
                                             acc_b.cpu(), *gate_args(cpu, acc_b)),
                                         "keyswitch_fused_batch"),
             "_cmux": (lambda: bootstrap._cmux(acc, idx, *args),
                       lambda: bootstrap._cmux(acc.cpu(), idx.cpu(), *gate_args(cpu, acc)),
                       "keyswitch_fused"),
             "_cmux batch": (lambda: bootstrap._cmux(acc_b, idx_b, *args_b),
                             lambda: bootstrap._cmux(acc_b.cpu(), idx_b.cpu(),
                                                     *gate_args(cpu, acc_b)),
                             "keyswitch_fused_batch")}
    for label, (card_fn, cpu_fn, kernel) in gates.items():
        c0 = read_counts()
        got = card_fn()
        c1 = read_counts()
        check(delta(c0, c1, kernel) == 1 and sum(c1.values()) - sum(c0.values()) == 1,
              f"{label} is not one {kernel} launch")
        check(torch.equal(got.cpu(), cpu_fn()), f"card {label} differs from the CPU plain path")
    lwe = fhe.extract_lsb(cts_bit[1])
    trunc = LWECiphertext(a=lwe.a[:BOOT_TRUNC], b=lwe.b)
    bsk_t = BootstrapKey(pos=bsk.pos[:BOOT_TRUNC], neg=bsk.neg[:BOOT_TRUNC], level=0)
    rot = bootstrap.blind_rotate(ctx, trunc, bsk_t)
    rot_cpu = bootstrap.blind_rotate(cpu, LWECiphertext(a=trunc.a.cpu(), b=trunc.b.cpu()),
                                     BootstrapKey(pos=bsk_t.pos.cpu(), neg=bsk_t.neg.cpu()))
    check(torch.equal(rot.data.cpu(), rot_cpu.data),
          f"card blind_rotate ({BOOT_TRUNC} steps) differs from the CPU plain path")
    print(f"phase bootstrap check: n={n}, k={prm.k}; bootstrap_binary of 0 and 1 and of a "
          f"level-1 input decode, bootstrap_lut {BOOT_LUT} decodes lut[m] for m = 0..3, "
          f"bootstrap_binary_batch of {BATCH} decodes and equals bootstrap_binary; "
          f"launches per bootstrap {per_single}, per batch {per_batch}; card == CPU plain "
          f"path for _external_product and _cmux (single and B={BATCH}, one launch each) "
          f"and {BOOT_TRUNC} steps of blind_rotate")

    # the path's kernels at the bootstrap's shapes
    for name, label, kern, plain, work in bootstrap_kernel_cases(gen, ctx):
        got, want = flat(kern()), flat(plain())
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        check(err == 0, f"{name} {label}: kernel differs from its plain version")
        b_ms, b_by = bound(*work)
        print("phase bootstrap kernel", name, json.dumps(
            {"shape": label, "max_abs_err": err, "ms": device_ms(kern),
             "plain_ms": device_ms(plain), "bound_ms": b_ms, "bound_by": b_by}))

    # times: wall medians of 5 as bench.py:863-871 (per ciphertext for the
    # batch); the time inside kernels of one call (torch.profiler: a
    # bootstrap is host-bound, so events behind a busy card would time the
    # host's launches); the device ms of a CMUX gate and of the external
    # product in it; key generation;
    # and a trace of the truncated rotation
    def wall5(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    boot = lambda: fhe.bootstrap_binary(cts_bit[1], sk, bsk)
    boot8 = lambda: fhe.bootstrap_binary_batch(cts8, sk, bsk)
    tr_boot, tr_boot8 = trace_span(boot), trace_span(boot8)
    times = {"bootstrap_ms_n1024": wall5(boot),
             "bootstrap_ms_n1024_b8": wall5(boot8) / BATCH,
             "bootstrap_in_kernels_ms_n1024": tr_boot["in_kernels_us"] / 1e3,
             "bootstrap_b8_in_kernels_ms_n1024": tr_boot8["in_kernels_us"] / 1e3,
             "cmux_device_ms": device_ms(gates["_cmux"][0]),
             "cmux_b8_device_ms": device_ms(gates["_cmux batch"][0]),
             "external_product_device_ms": device_ms(gates["_external_product"][0]),
             "external_product_b8_device_ms": device_ms(gates["_external_product batch"][0]),
             "make_bootstrap_key_s": bsk_s,
             "bootstrap_key_bytes": bsk.pos.numel() * 4 + bsk.neg.numel() * 4}
    print("phase bootstrap times", json.dumps(times))
    empty = LWECiphertext(a=lwe.a[:0], b=lwe.b)
    tr = trace_span(lambda: bootstrap.blind_rotate(ctx, trunc, bsk_t))
    tr0 = trace_span(lambda: bootstrap.blind_rotate(ctx, empty, bsk_t))
    tr["kernels_per_cmux"] = (tr["kernels"] - tr0["kernels"]) / (2 * BOOT_TRUNC)
    tr["kernels_per_step"] = 2 * tr["kernels_per_cmux"]
    print(f"phase bootstrap trace blind_rotate {BOOT_TRUNC} steps", json.dumps(tr))
    print("phase bootstrap trace bootstrap_binary", json.dumps(tr_boot))
    print(f"phase bootstrap trace bootstrap_binary_batch B={BATCH}", json.dumps(tr_boot8))
    print("phase bootstrap profiler kernels of one _cmux gate", json.dumps(
        [name[:48] for name in profiled_kernels(gates["_cmux"][0])]))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = phase_kernels(gen)
    phase_geometry()
    phase_n16384()
    phase_n32768()
    launches = {"slice": phase_slice(), "multiply": phase_multiply(),
                "serving": phase_serving(), "hoisted": phase_hoisted(),
                "omega": phase_omega(), "leveled": phase_leveled(),
                "small": phase_small(), "roofline": phase_roofline(gen),
                "bgv": phase_bgv(), "bootstrap": phase_bootstrap(gen)}
    rows = []
    for name, meta in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"],
                     "launches": launches[meta["path"]][name],
                     "bgv_launches": launches["bgv"][name],
                     "bootstrap_launches": launches["bootstrap"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "shape": r["shape"]})
    print("phase total seconds", time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
