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
from llamole_tpu_torch.ops import nn as tnn
from llamole_tpu_torch.ops.fused_attention import (
    fused_attention_reference, fused_block_attention)

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
