"""The arithmetic of kernel E's warpgroup forward, emulated on the CPU and
held to JAX's flash forward (jaxlib's Pallas kernel in TPU interpret mode).

`flash_fwd_wgmma_kernel` (llamole_tpu_torch/csrc/flash_attention.cu) runs
only on the card. `emulate_forward` repeats its arithmetic in torch:
blocks of 128 query rows as two warpgroups of 64, key steps of BK = 128
(64 at head_dim 256) up to the block's diagonal, the logits scaled by
scale * log2 e, a masked logit at the finite MASK_VALUE in that log2
domain, the online softmax on exp2, the per-step gate read from the
segment ids (a step whose keys all lie outside the rows' one segment is
skipped, one whose keys all lie in it and precede every row skips the
mask, the rest are masked), P cast to v's dtype before P.V, and the
log-sum-exp given back in natural log as (m + log2 l) * ln 2. In f32 its
output is held within 2e-5 of the JAX package's `_flash_attention` and
its log-sum-exp within 1e-5 of the residuals (l, m) of jaxlib's
`_flash_attention_impl`, at padded shapes with a split segment, one with
more than 128 right-padded rows (whose first key steps are all masked).
Each interpret-mode call runs as one jitted computation: eager JAX
operations dispatched beside its host callbacks can deadlock the CPU
client.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, _flash_attention_impl)

import llamole_tpu.models.gllm.model as jax_model
from llamole_tpu_torch.ops.flash_attention import MASK_VALUE

OUT_ATOL = 2e-5
LSE_ATOL = 1e-5
ROWS = 128          # query rows of a block
WG_ROWS = 64        # rows of a warpgroup
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# (b, s, h, kv, d), then per row (left pad, start of a second segment or
# None, right pad): segment 0 pads, 1 the text, 2 a packed second sequence
CASES = {
    "2x256x4x2x128": ((2, 256, 4, 2, 128), ((9, 100, 0), (0, None, 128))),
    "1x384x4x1x128": ((1, 384, 4, 1, 128), ((9, 150, 140),)),
    "2x384x2x1x128": ((2, 384, 2, 1, 128), ((0, None, 0), (0, 300, 200))),
    "1x256x2x1x256": ((1, 256, 2, 1, 256), ((7, 90, 130),)),
}


def _segments(s, rows):
    seg = np.ones((len(rows), s), np.int32)
    for r, (left, split, right) in enumerate(rows):
        if split is not None:
            seg[r, split:] = 2
        seg[r, :left] = 0
        seg[r, s - right:] = 0
    return seg


def key_step(d: int) -> int:
    """Keys a step of the kernel: 128 at head_dim 128, 64 at 256."""
    return 128 if d == 128 else 64


def emulate_forward(q, k, v, seg, counts=None, skip=True):
    """The warpgroup forward's arithmetic: q [B, S, H, D], k / v [B, S, KV,
    D], seg [B, S] -> (out [B, S, H * D] in q's dtype, lse [B, H, S] f32).
    `counts`, where given, gathers the steps per gate: skipped, unmasked,
    masked. With `skip` off, a step the kernel skips runs masked."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    bk = key_step(d)
    scale2 = (1.0 / math.sqrt(d)) * LOG2E
    out = torch.empty((b, s, h, d), dtype=torch.float32)
    lse = torch.empty((b, h, s), dtype=torch.float32)
    pos = torch.arange(s)
    for bi in range(b):
        sg = seg[bi]
        for w0 in range(0, s, WG_ROWS):
            rows = slice(w0, w0 + WG_ROWS)
            wseg = int(sg[w0])
            rows_one = bool((sg[rows] == wseg).all())
            nkt = (w0 // ROWS * ROWS + ROWS) // bk
            qr = q[bi, rows].float().transpose(0, 1)        # [H, 64, D]
            m = torch.full((h, WG_ROWS), -math.inf)
            l = torch.zeros((h, WG_ROWS))
            o = torch.zeros((h, WG_ROWS, d))
            for kt in range(nkt):
                j0 = kt * bk
                if j0 > w0 + WG_ROWS - 1:
                    continue
                keys = slice(j0, j0 + bk)
                ks = torch.repeat_interleave(k[bi, keys].float().transpose(0, 1),
                                             g, dim=0)      # [H, BK, D]
                vs = torch.repeat_interleave(v[bi, keys].transpose(0, 1), g,
                                             dim=0)
                keys_in = rows_one and bool((sg[keys] == wseg).all())
                if skip and rows_one and bool((sg[keys] != wseg).all()):
                    _count(counts, "skipped")
                    continue
                unmasked = keys_in and j0 + bk - 1 <= w0
                _count(counts, "unmasked" if unmasked else "masked")
                sc = qr @ ks.transpose(1, 2)                # [H, 64, BK]
                if unmasked:
                    mx = sc.amax(-1) * scale2
                else:
                    allowed = ((pos[keys][None, :] <= pos[rows][:, None])
                               & (sg[keys][None, :] == sg[rows][:, None]))
                    sc = torch.where(allowed, sc * scale2,
                                     torch.tensor(MASK_VALUE))
                    mx = sc.amax(-1)
                mn = torch.maximum(m, mx)
                alpha = torch.exp2(m - mn)
                m = mn
                # the kernel's fmaf(s, f, -m): one rounding, as in f64
                f = scale2 if unmasked else 1.0
                p = torch.exp2((sc.double() * f - mn.double()[..., None])
                               .float())
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + p.to(v.dtype).float() @ vs.float()
            out[bi, rows] = (o / l[..., None]).transpose(0, 1)
            lse[bi, :, rows] = (m + torch.log2(l)) * LN2
    return out.reshape(b, s, h * d).to(q.dtype), lse


def _count(counts, key):
    if counts is not None:
        counts[key] = counts.get(key, 0) + 1


def _interpret(fn, *args):
    """fn(*args) as one jitted computation, waited for."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _inputs(shape, rows, seed=0):
    b, s, h, kv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v, _segments(s, rows)


def _jax_forward(q, k, v, seg):
    """The JAX package's flash forward and jaxlib's log-sum-exp residual
    (m + log l, natural log), both in interpret mode."""
    b, s, h, d = q.shape
    g = h // k.shape[2]

    def lse_of(q, k, v, seg):
        to_heads = lambda t: jnp.moveaxis(jnp.repeat(t, g, axis=2), 2, 1)
        ids = SegmentIds(q=seg, kv=seg)
        _, l, m = _flash_attention_impl(
            jnp.moveaxis(q, 2, 1), to_heads(k), to_heads(v), None, ids, True,
            True, 1.0 / np.sqrt(d), 1, 128, 128, 128, False)
        return m + jnp.log(l)

    args = tuple(jnp.asarray(a) for a in (q, k, v, seg))
    with pltpu.force_tpu_interpret_mode():
        out = _interpret(
            lambda q, k, v, seg: jax_model._flash_attention(q, k, v, seg,
                                                            None), *args)
        lse = _interpret(lse_of, *args)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_forward_matches_jax_interpret_kernel(case):
    """The emulated warpgroup forward against JAX's flash forward in f32:
    output within 2e-5 and log-sum-exp within 1e-5, pad rows included."""
    shape, rows = CASES[case]
    q, k, v, seg = _inputs(shape, rows)
    want_out, want_lse = _jax_forward(q, k, v, seg)
    got_out, got_lse = emulate_forward(*(torch.from_numpy(a)
                                         for a in (q, k, v, seg)))
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=LSE_ATOL,
                               rtol=0)


def test_the_cases_take_every_gate():
    """The cases reach each of the kernel's three kinds of key step: a
    step skipped (rows right-padded past 128 keys, every key in another
    segment), a step without the mask (a warpgroup of one segment past a
    whole key step of it) and a masked one; and the skipped steps change
    no result (the same forward with the skip turned off agrees)."""
    counts = {}
    for shape, rows in CASES.values():
        q, k, v, seg = (torch.from_numpy(a) for a in _inputs(shape, rows))
        before = counts.get("skipped", 0)
        got = emulate_forward(q, k, v, seg, counts)
        if counts.get("skipped", 0) > before:
            every = emulate_forward(q, k, v, seg, skip=False)
            assert all(torch.equal(a, b) for a, b in zip(got, every))
    assert counts["skipped"] > 0 and counts["unmasked"] > 0
    assert counts["masked"] > 0
