"""The arithmetic of kernel E's f32 forward, emulated on the CPU and held
to jaxlib's flash forward in TPU interpret mode.

`flash_fwd_tf32_kernel<D>` (llamole_tpu_torch/csrc/flash_attention.cu)
runs only on the card. `emulate_forward` repeats its arithmetic in torch:

- blocks of ROWS[D] query rows, a tile of 16 rows a warp (at D = 256 two
  warps a tile, each over one half of D), key steps of KEYS[D] keys up to
  the block's diagonal; a tile skips a step wholly above its rows and one
  where its rows lie in one segment and no key of the step does, and runs
  a step wholly inside that segment and before every row without the
  mask;
- S = Q.K^T in split TF32 (test_torch_flash_backward_f32's `product` on
  test_torch_attention_tf32x3's `split`: hi = TF32(x), lo = TF32(x - hi),
  the product the f32 sum lo.hi + hi.lo + hi.hi), at D = 256 the sum of
  the two warps' partial S over one half of D each;
- the online softmax in the log2 domain: the logits scaled by scale *
  log2 e, a masked one at the finite MASK_VALUE, P = 2^(s * f - m) (the
  kernel's fmaf and ex2.approx: in f64 here, one rounding as the fmaf),
  O += P.V in split TF32, out = O * (1 / l) and lse = (m + log2 l) * ln 2.

Its output is held within 2e-5 of the JAX package's `_flash_attention`
and its log-sum-exp within 1e-5 of the residuals of jaxlib's
`_flash_attention_impl`, both in TPU interpret mode (the limits and the
`_jax_forward` / `_interpret` helpers of test_torch_flash_forward_tiles:
each interpret-mode call one jitted computation), at both head dims with
G = 1 and G = 2, padded on both sides, with a split segment and more than
one block of right padding. Planted mutants (the lo.hi pass dropped, a
key step skipped, the wrong KV head, at D = 256 the partial-S exchange
dropped) fail the same limits.
"""

import functools
import math

import numpy as np
import pytest
import torch

from llamole_tpu_torch.ops import flash_attention as E
from llamole_tpu_torch.ops.cuda_lib import MAX_SHARED_BYTES
from llamole_tpu_torch.ops.flash_attention import MASK_VALUE
from test_torch_flash_backward_f32 import product
from test_torch_flash_forward_tiles import (LN2, LOG2E, LSE_ATOL, OUT_ATOL,
                                            _inputs, _jax_forward)

# csrc/flash_attention.cu's Tf32Fwd<D>: query rows a block, keys a step,
# warps (parts of D) a 16-row tile
ROWS = {128: 128, 256: 64}
KEYS = {128: 64, 256: 32}
SPLIT = {128: 1, 256: 2}
WARP_ROWS = 16
WARPS = 8
STAGES = 2
MUTANTS = ("drop_lo_hi", "skip_key_step", "wrong_kv_head", "drop_exchange")

# (b, s, h, kv, d), then per row (left pad, start of a second segment or
# None, right pad): segment 0 pads, 1 the text, 2 a packed second sequence
CASES = {
    "2x256x4x2x128": ((2, 256, 4, 2, 128), ((9, 100, 0), (0, None, 130))),
    "1x384x2x2x128": ((1, 384, 2, 2, 128), ((7, 150, 140),)),
    "1x256x2x1x256": ((1, 256, 2, 1, 256), ((7, 90, 70),)),
    "1x256x2x2x256": ((1, 256, 2, 2, 256), ((0, None, 130),)),
}


def _count(counts, key):
    if counts is not None:
        counts[key] = counts.get(key, 0) + 1


def emulate_forward(q, k, v, seg, mutant=None, counts=None, skip=True):
    """The f32 forward's arithmetic: q [B, S, H, D], k / v [B, S, KV, D],
    seg [B, S] -> (out [B, S, H * D], lse [B, H, S]), f32. `mutant` plants
    one of MUTANTS; `counts`, where given, gathers the tiles' steps per
    gate (skipped, unmasked, masked); with `skip` off, a step the kernel
    skips runs masked."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rows_n, bk = ROWS[d], KEYS[d]
    scale2 = (1.0 / math.sqrt(d)) * LOG2E
    mul = functools.partial(product, mutant=mutant)
    heads = torch.arange(h)
    # query head h reads KV head h // G (the mutant: h % KV)
    kvh = heads % kv if mutant == "wrong_kv_head" else heads // (h // kv)
    parts = [slice(i * d // SPLIT[d], (i + 1) * d // SPLIT[d])
             for i in range(SPLIT[d])]
    # each warp's view: the partial sums it adds into S, the dims of O it
    # keeps (both warps of a pair form the same P, so one view serves
    # them; without the exchange each forms its own from its half)
    if mutant == "drop_exchange":
        views = [([i], p) for i, p in enumerate(parts)]
    else:
        views = [(list(range(len(parts))), slice(None))]
    pos = torch.arange(s)
    mask = torch.tensor(MASK_VALUE)
    out = torch.empty((b, s, h, d))
    lse = torch.empty((b, h, s))
    for bi in range(b):
        sg = seg[bi]
        qh = q[bi].float().transpose(0, 1)                   # [H, S, D]
        kh = k[bi].float().transpose(0, 1)[kvh]
        vh = v[bi].float().transpose(0, 1)[kvh]
        for w0 in range(0, s, WARP_ROWS):
            rows = slice(w0, w0 + WARP_ROWS)
            q0 = w0 // rows_n * rows_n
            wseg = int(sg[w0])
            rows_one = bool((sg[rows] == wseg).all())
            state = [(torch.full((h, WARP_ROWS), -math.inf),
                      torch.zeros((h, WARP_ROWS)),
                      torch.zeros((h, WARP_ROWS, d))[..., dims])
                     for _, dims in views]
            for kt in range((q0 + rows_n) // bk):
                j0 = kt * bk
                if j0 > w0 + WARP_ROWS - 1:
                    continue
                keys = slice(j0, j0 + bk)
                if skip and rows_one and bool((sg[keys] != wseg).all()):
                    _count(counts, "skipped")
                    continue
                if mutant == "skip_key_step" and kt == 1:
                    continue
                unmasked = (rows_one and bool((sg[keys] == wseg).all())
                            and j0 + bk - 1 <= w0)
                _count(counts, "unmasked" if unmasked else "masked")
                partial = [mul(qh[:, rows, p], kh[:, keys, p].transpose(1, 2))
                           for p in parts]
                allowed = ((pos[keys][None, :] <= pos[rows][:, None])
                           & (sg[keys][None, :] == sg[rows][:, None]))
                for vi, (adds, dims) in enumerate(views):
                    sc = partial[adds[0]]
                    for i in adds[1:]:
                        sc = sc + partial[i]
                    m, l, o = state[vi]
                    if unmasked:
                        mx = sc.amax(-1) * scale2
                    else:
                        sc = torch.where(allowed, sc * scale2, mask)
                        mx = sc.amax(-1)
                    mn = torch.maximum(m, mx)
                    alpha = torch.exp2(m - mn)
                    # the kernel's fmaf(s, f, -m): one rounding, as in f64
                    f = scale2 if unmasked else 1.0
                    p = torch.exp2((sc.double() * f - mn.double()[..., None])
                                   .float())
                    state[vi] = (mn, l * alpha + p.sum(-1),
                                 o * alpha[..., None]
                                 + mul(p, vh[:, keys, dims]))
            out[bi, rows] = torch.cat(
                [o * (1.0 / l)[..., None] for _, l, o in state],
                -1).transpose(0, 1)
            m, l, _ = state[0]        # the first warp of a pair writes lse
            lse[bi, :, rows] = (m + torch.log2(l)) * LN2
    return out.reshape(b, s, h * d), lse


@functools.lru_cache(maxsize=None)
def _case(name):
    """A case's seeded inputs and the JAX forward's (out, lse), once."""
    shape, rows = CASES[name]
    q, k, v, seg = _inputs(shape, rows, seed=2)
    return (q, k, v, seg), _jax_forward(q, k, v, seg)


def _gaps(name, mutant=None):
    """max |emulated - JAX| of out and of lse."""
    ins, want = _case(name)
    got = emulate_forward(*(torch.from_numpy(a) for a in ins), mutant)
    return [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_f32_forward_matches_jax_interpret_kernel(case):
    """The emulated split-TF32 forward against jaxlib's flash forward in
    f32: out within 2e-5 and lse within 1e-5, pad rows included."""
    out_gap, lse_gap = _gaps(case)
    assert out_gap <= OUT_ATOL and lse_gap <= LSE_ATOL, (out_gap, lse_gap)


def test_the_cases_cover_both_head_dims_groups_pads_and_every_gate():
    """Both head dims with G = 1 and G = 2 each; left and right padding, a
    split segment, a row right-padded past a whole block at each head
    dim; and the tiles reach each kind of key step (skipped, unmasked,
    masked), the skipped steps changing no bit of the result."""
    cover = {(shape[4], shape[2] // shape[3]) for shape, _ in CASES.values()}
    assert cover == {(128, 1), (128, 2), (256, 1), (256, 2)}
    rows = [r for _, rs in CASES.values() for r in rs]
    assert any(r[0] for r in rows) and any(r[1] for r in rows)
    for d in E.HEAD_DIMS:
        assert max(r[2] for shape, rs in CASES.values() if shape[4] == d
                   for r in rs) > ROWS[d]
    counts = {}
    for name, (shape, rows) in CASES.items():
        ins = [torch.from_numpy(a) for a in _inputs(shape, rows, seed=2)]
        before = counts.get("skipped", 0)
        got = emulate_forward(*ins, counts=counts)
        if counts.get("skipped", 0) > before:
            every = emulate_forward(*ins, skip=False)
            assert all(torch.equal(a, b) for a, b in zip(got, every)), name
    assert counts["skipped"] and counts["unmasked"] and counts["masked"]


@pytest.mark.parametrize("mutant", MUTANTS)
def test_planted_mutants_fail(mutant):
    """Each planted fault moves out past 2e-5 or lse past 1e-5 of JAX's
    (or makes either NaN):
    the lo.hi pass of every product dropped, each tile's second key step
    skipped, query head h reading KV head h % KV in place of h // G (G = 2
    on two KV heads), and at D = 256 each warp forming P from its own half
    of S without the other's."""
    case = "1x256x2x1x256" if mutant == "drop_exchange" else "2x256x4x2x128"
    out_gap, lse_gap = _gaps(case, mutant)
    # a row left without a key gives NaN, which no limit passes
    assert not (out_gap <= OUT_ATOL and lse_gap <= LSE_ATOL), (out_gap,
                                                               lse_gap)


def test_f32_forward_routes_to_the_split_tf32_body_and_fits_shared_memory():
    """forward_body names "tf32x3" for f32 at both head dims; the body's
    8 warps cover a block's rows (at D = 256 two a tile, each over half of
    D); its blocks and key steps divide every S the route takes; its
    shared memory (Q of a block and two stages of K, V and the keys' ids,
    rows of D + 4 floats, the partial S where warps split D) fits under
    the card's 227 KB."""
    f32 = torch.float32
    assert [E.forward_body(f32, d) for d in E.HEAD_DIMS] == ["tf32x3"] * 2
    for d in E.HEAD_DIMS:
        row = d + 4
        assert ROWS[d] // WARP_ROWS * SPLIT[d] == WARPS
        partials = WARPS * KEYS[d] * 16 if SPLIT[d] > 1 else 0
        shared = (ROWS[d] * row + STAGES * (2 * KEYS[d] * row + KEYS[d])
                  + partials) * 4
        assert shared <= MAX_SHARED_BYTES, (d, shared)
        for n in (ROWS[d], KEYS[d]):
            assert E.SEQ_MULTIPLE % n == 0
