"""Kernels A and D's f32 tensor-core body ("tf32x3") against JAX, on the CPU.

The body (csrc/fused_attention.cu attention_tf32x3_kernel) runs only on a
card. Its arithmetic is emulated here in torch: every operand of the two
products is split into hi = TF32(x) and lo = TF32(x - hi), TF32 rounding
by bit operations with ties away from zero as `cvt.rna.tf32.f32` rounds,
and each product is the f32 sum of lo.hi + hi.lo + hi.hi (the products of
two TF32 values are exact in f32). The emulation is held to the JAX
package's references on seeded numpy inputs at the f32 contract: 1e-4 for
A (the main shape) and 2e-5 for D at JAX's shapes (tests/test_pallas.py).
The error of a single TF32 pass is printed beside it. The routing and the
shared memory of the body are checked here too; tests/test_torch_kernels.py
holds the kernel itself to its plain version on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.ops.attention import masked_attention as jax_masked_attention
from llamole_tpu.ops.pallas.fused_attention import _fused_attention_reference
from llamole_tpu_torch.ops.cuda_lib import MAX_SHARED_BYTES
from llamole_tpu_torch.ops.fused_attention import (
    attention_body, check_body, count_launch, reset_launches, shared_bytes)
from llamole_tpu_torch.ops.nn import layer_norm

MAIN_SHAPE = (16, 50, 1024, 16)          # CFG-doubled batch 8, N, H, heads
ATTN_CONTRACT = [(2, 4, 13, 24), (1, 2, 64, 64), (3, 8, 50, 32)]
ATTN_MAIN = (16, 16, 50, 64)
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in f32 from TF32 parts: three passes (lo.hi + hi.lo, then
    hi.hi, the kernel's order) or one (hi.hi)."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def emulated_attention(q, k, v, key_mask, passes: int):
    """The body's attention on [B, heads, N, dh] f32 heads: logits from
    split products, scaled by 1/sqrt(dh), masked keys at -1e30, the row
    softmax in f32 (one reciprocal a row), P.V from split products."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = product(q, k.transpose(-1, -2), passes) * scale
    if key_mask is not None:
        logits = logits + torch.where(key_mask, 0.0, NEG)[:, None, None, :]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    return product(p, v, passes)


def emulated_fused(qkv, mask, qs, qb, ks, kb, heads, passes):
    b, n, three_h = qkv.shape
    h = three_h // 3
    q, k, v = qkv.reshape(b, n, 3, heads, h // heads).permute(2, 0, 3, 1, 4)
    q, k = layer_norm(q, qs, qb), layer_norm(k, ks, kb)
    out = emulated_attention(q, k, v, mask, passes)
    return out.transpose(1, 2).reshape(b, n, h)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                        # TF32's spacing above 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, one + ulp * (1 - 2.0 ** -13)],
                     dtype=torch.float32)
    want = [one, one + ulp, -(one + ulp), one, one + ulp, one + ulp]
    assert tf32(x).tolist() == want
    # hi + lo keeps 22 of f32's 24 significant bits
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    rel = ((hi.double() + lo.double() - y.double()).abs()
           / y.double().abs()).max()
    assert rel <= 2.0 ** -21, float(rel)


def test_split_body_matches_jax_fused_attention_at_the_main_shape(capsys):
    b, n, h, heads = MAIN_SHAPE
    dh = h // heads
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(b, n, 3 * h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.3
    mask[:, 0] = True
    qs, qb, ks, kb = (rng.normal(size=(dh,)).astype(np.float32)
                      for _ in range(4))
    want = np.asarray(_fused_attention_reference(
        jnp.asarray(qkv), jnp.asarray(mask), {"scale": qs, "bias": qb},
        {"scale": ks, "bias": kb}, heads))
    keep = mask[:, :, None]            # only surviving rows are defined
    errs = {}
    for passes in (3, 1):
        got = emulated_fused(_t(qkv), _t(mask), _t(qs), _t(qb), _t(ks),
                             _t(kb), heads, passes).numpy()
        errs[passes] = float(np.max(np.abs((got - want) * keep)))
    with capsys.disabled():
        print(f"\nA at {MAIN_SHAPE} f32: three TF32 passes max abs err "
              f"{errs[3]:.3e}, one pass {errs[1]:.3e} (tol 1e-4)")
    assert errs[3] < 1e-4
    assert errs[1] > 10 * errs[3]


@pytest.mark.parametrize("shape,tol", [(s, 2e-5) for s in ATTN_CONTRACT]
                         + [(ATTN_MAIN, 1e-4)])
def test_split_body_matches_jax_masked_attention(shape, tol, capsys):
    b, heads, n, dh = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = rng.random((b, n)) < 0.7
    mask[:, 0] = True
    want = np.asarray(jax_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    errs = {passes: float(np.max(np.abs(emulated_attention(
        _t(q), _t(k), _t(v), _t(mask), passes).numpy() - want)))
        for passes in (3, 1)}
    with capsys.disabled():
        print(f"\nD at {shape} f32: three TF32 passes max abs err "
              f"{errs[3]:.3e}, one pass {errs[1]:.3e} (tol {tol:g})")
    assert errs[3] < tol
    assert errs[1] > 10 * errs[3]


@pytest.mark.parametrize("n,dh,dtype,body", [
    (50, 64, torch.float32, "tf32x3"),    # the f32 denoiser's shape
    (64, 128, torch.float32, "tf32x3"),
    (1, 16, torch.float32, "tf32x3"),
    (17, 32, torch.float32, "tf32x3"),
    (50, 64, torch.bfloat16, "mma"),      # bf16 stays on its body
    (64, 16, torch.bfloat16, "mma"),
    (65, 64, torch.float32, "fma"),       # more keys than four warps of 16
    (13, 24, torch.float32, "fma"),       # dh not in the tensor-core widths
    (50, 256, torch.float32, "fma"),
    (65, 64, torch.bfloat16, "fma"),
    (13, 24, torch.bfloat16, "fma"),
    (50, 64, torch.float16, "fma"),       # the wrappers refuse it first
])
def test_routing_of_the_three_bodies(n, dh, dtype, body):
    assert attention_body(n, dh, dtype) == body


@pytest.mark.parametrize("n,dh,want", [
    (50, 64, 3 * 64 * 68 * 4 + 64 * 4),      # the main shape: 52480 bytes
    (64, 128, 3 * 64 * 132 * 4 + 64 * 4),    # the largest: 101632 bytes
    (64, 16, 3 * 64 * 20 * 4 + 64 * 4),
    (1, 16, 3 * 16 * 20 * 4 + 16 * 4),
])
def test_tf32x3_shared_memory_fits(n, dh, want):
    """q, k, v as [N rounded up to 16, dh + 4] f32 tiles and the f32 key
    mask, within what one H100 block may opt into (the main shape and dh
    128 need the opt-in above 48 KB)."""
    assert shared_bytes(n, dh, "tf32x3") == want <= MAX_SHARED_BYTES
    check_body("tf32x3", n, dh, (torch.empty(16),))


def test_tf32x3_refuses_misaligned_rows_and_counts_its_launches():
    base = torch.empty(64)
    with pytest.raises(ValueError, match="aligned"):
        check_body("tf32x3", 8, 16, (base[1:],))
    check_body("fma", 8, 16, (base[1:],))     # the FMA body reads scalars
    wrapper = types.SimpleNamespace()
    reset_launches(wrapper)
    for body in ("tf32x3", "tf32x3", "mma", "fma"):
        count_launch(wrapper, body)
    assert (wrapper.launches, wrapper.launches_tf32x3, wrapper.launches_mma,
            wrapper.launches_fma) == (4, 2, 1, 1)
