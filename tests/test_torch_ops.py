"""llamole_tpu_torch ops against the JAX reference (llamole_tpu.ops).

Same seeded numpy inputs through both packages, compared in f32 on the
CPU. The fused-attention kernel itself runs only on a CUDA card: its
CPU tests pin the plain version it is checked against on the card
(tests/test_torch_kernels.py holds the card tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.ops import nn as jnn
from llamole_tpu.ops.pallas.fused_attention import (
    _fused_attention_reference, fused_block_attention as jax_fused)
from llamole_tpu.ops.pallas.graph_attention import (
    graph_attention as jax_graph_attention)
from llamole_tpu_torch.ops import nn as tnn
from llamole_tpu_torch.ops.fused_attention import (
    attention_body, fused_attention_reference, fused_block_attention,
    shared_bytes)
from llamole_tpu_torch.ops.graph_attention import graph_attention

ATOL_NN = 1e-5      # f32, a handful of ops
ATOL_ATTN = 1e-4    # the JAX kernel's own contract


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_nn_blocks_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    w1 = rng.normal(size=(16, 32)).astype(np.float32) * 0.3
    b1 = rng.normal(size=(32,)).astype(np.float32)
    w2 = rng.normal(size=(32, 8)).astype(np.float32) * 0.3
    b2 = rng.normal(size=(8,)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)

    got = tnn.dense(_t(x), _t(w1).T, _t(b1)).numpy()
    want = np.asarray(jnn.dense({"w": w1, "b": b1}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL_NN)

    got = tnn.layer_norm(_t(x), _t(scale), _t(bias)).numpy()
    want = np.asarray(jnn.layer_norm(jnp.asarray(x),
                                     {"scale": scale, "bias": bias}))
    np.testing.assert_allclose(got, want, atol=ATOL_NN)
    np.testing.assert_allclose(tnn.layer_norm(_t(x)).numpy(),
                               np.asarray(jnn.layer_norm(jnp.asarray(x))),
                               atol=ATOL_NN)

    mlp = tnn.MLP(16, 32, 8)
    mlp.load_state_dict({"fc1.weight": _t(w1).T, "fc1.bias": _t(b1),
                         "fc2.weight": _t(w2).T, "fc2.bias": _t(b2)})
    with torch.no_grad():
        got = mlp(_t(x)).numpy()
    want = np.asarray(jnn.mlp_apply({"fc1": {"w": w1, "b": b1},
                                     "fc2": {"w": w2, "b": b2}},
                                    jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL_NN)

    np.testing.assert_allclose(tnn.softsign(_t(x)).numpy(),
                               np.asarray(jnn.softsign(jnp.asarray(x))),
                               atol=ATOL_NN)


def _attn_inputs(b, n, h, heads, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3 * h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.3
    mask[:, 0] = True   # every graph keeps >= 1 node
    dh = h // heads
    norms = [rng.normal(size=(dh,)).astype(np.float32) for _ in range(4)]
    return qkv, mask, norms


@pytest.mark.parametrize("b,n,h,heads", [
    (5, 50, 128, 4),      # odd batch, unpadded N
    (8, 64, 256, 8),      # aligned
    (3, 17, 64, 2),       # tiny
])
def test_plain_fused_attention_matches_jax(b, n, h, heads):
    qkv, mask, (qs, qb, ks, kb) = _attn_inputs(b, n, h, heads)
    got = fused_attention_reference(_t(qkv), _t(mask), _t(qs), _t(qb),
                                    _t(ks), _t(kb), heads).numpy()
    qn, kn = {"scale": qs, "bias": qb}, {"scale": ks, "bias": kb}
    ref = np.asarray(_fused_attention_reference(
        jnp.asarray(qkv), jnp.asarray(mask), qn, kn, heads))
    pallas = np.asarray(jax_fused(jnp.asarray(qkv), jnp.asarray(mask), qn,
                                  kn, heads, interpret=True))
    keep = mask[:, :, None]   # only surviving rows are defined
    for want in (ref, pallas):
        err = float(np.max(np.abs((got - want) * keep)))
        assert err < ATOL_ATTN, err


def test_wrapper_on_cpu_takes_plain_path_without_counting():
    qkv, mask, norms = _attn_inputs(2, 9, 32, 4, seed=1)
    before = fused_block_attention.launches
    out = fused_block_attention(_t(qkv), _t(mask), *map(_t, norms), 4)
    assert fused_block_attention.launches == before
    ref = fused_attention_reference(_t(qkv), _t(mask), *map(_t, norms), 4)
    assert torch.equal(out, ref)


def test_wrapper_rejects_other_devices():
    qkv, mask, norms = _attn_inputs(1, 4, 8, 2, seed=2)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block_attention(_t(qkv).to(meta), _t(mask).to(meta),
                              *[_t(p).to(meta) for p in norms], 2)


@pytest.mark.parametrize("shape", [(2, 4, 13, 24), (1, 2, 64, 64),
                                   (3, 8, 50, 32)])
def test_graph_attention_matches_jax_kernel(shape):
    """Kernel D's CPU path (masked_attention) against the JAX kernel in
    interpret mode at the JAX contract shapes, 2e-5 (tests/test_pallas.py);
    a missing mask keeps every key."""
    b, h, n, dh = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = rng.random((b, n)) < 0.7
    mask[:, 0] = True
    for m in (mask, None):
        want = np.asarray(jax_graph_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m), use_pallas=True,
            interpret=True))
        before = graph_attention.launches
        got = graph_attention(_t(q), _t(k), _t(v),
                              None if m is None else _t(m)).numpy()
        assert graph_attention.launches == before   # CPU: plain, uncounted
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        graph_attention(*(_t(a).to("meta") for a in (q, k, v)))


@pytest.mark.parametrize("n,dh,dtype,body", [
    (50, 64, torch.bfloat16, "mma"),    # the denoiser's path (A) and D's
    (17, 32, torch.bfloat16, "mma"),
    (64, 32, torch.bfloat16, "mma"),
    (1, 16, torch.bfloat16, "mma"),
    (9, 128, torch.bfloat16, "mma"),
    (50, 64, torch.float32, "tf32x3"),  # f32: the f32 denoiser, split TF32
    (13, 24, torch.bfloat16, "fma"),    # dh not a multiple of 16
    (13, 24, torch.float32, "fma"),
    (65, 64, torch.bfloat16, "fma"),    # more keys than four warps of 16
    (50, 256, torch.bfloat16, "fma"),
])
def test_attention_body_routing(n, dh, dtype, body):
    assert attention_body(n, dh, dtype) == body


@pytest.mark.parametrize("n,dh,body,want", [
    # mma: q, k, v as [16 * ceil(N / 16), dh + 8] bf16 + an f32 mask row
    (50, 64, "mma", 3 * 64 * 72 * 2 + 64 * 4),
    (17, 32, "mma", 3 * 32 * 40 * 2 + 32 * 4),
    (16, 16, "mma", 3 * 16 * 24 * 2 + 16 * 4),
    # fma: q, k, v as [N, dh + 1] and the [N, N + 1] logits, f32
    (50, 64, "fma", (3 * 50 * 65 + 50 * 51) * 4),
    (13, 24, "fma", (3 * 13 * 25 + 13 * 14) * 4),
])
def test_shared_bytes_layout(n, dh, body, want):
    assert shared_bytes(n, dh, body) == want
    # the tensor-core body of the main shape fits the default 48 KB and
    # leaves room for eight blocks on an SM
    assert shared_bytes(50, 64, "mma") < 48 * 1024 < shared_bytes(50, 64,
                                                                 "fma")
