"""The port's CUDA kernels on the card (marked `gpu`; they skip without one,
since a CUDA kernel has no CPU mode).

This file imports only torch and the port, so the machine with the card,
which has no JAX, runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from llamole_tpu_torch.ops import flash_attention as E
from llamole_tpu_torch.ops.attention import masked_attention
from llamole_tpu_torch.ops.fused_attention import (
    attention_body, fused_attention_reference, fused_block_attention)
from llamole_tpu_torch.ops.gin_aggregate import (
    gin_aggregate, gin_aggregate_backward, gin_aggregate_backward_reference,
    gin_aggregate_reference)
from llamole_tpu_torch.ops.graph_attention import graph_attention

pytestmark = pytest.mark.gpu

MAIN_SHAPE = (16, 50, 1024, 16)   # CFG-doubled batch 8, N, H, heads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, b, n, h, heads, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h, device=dev, generator=gen).to(dtype)
    mask = torch.rand(b, n, device=dev, generator=gen) > 0.3
    mask[:, 0] = True
    norms = [torch.randn(h // heads, device=dev, generator=gen).to(dtype)
             for _ in range(4)]
    return qkv, mask, norms


@pytest.mark.parametrize("shape", [MAIN_SHAPE, (5, 17, 128, 4),
                                   (8, 64, 256, 8)])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),     # the JAX kernel's contract
    (torch.bfloat16, 2e-2),    # convex combination of O(1) rows, bf16 ~4e-3
])
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    b, n, h, heads = shape
    qkv, mask, norms = _inputs(cuda, dtype, *shape)
    counter = f"launches_{attention_body(n, h // heads, dtype)}"
    before = (fused_block_attention.launches,
              getattr(fused_block_attention, counter))
    out = fused_block_attention(qkv, mask, *norms, heads)
    torch.cuda.synchronize()
    assert (fused_block_attention.launches,
            getattr(fused_block_attention, counter)) == (before[0] + 1,
                                                         before[1] + 1)
    ref = fused_attention_reference(qkv, mask, *norms, heads)
    assert out.shape == (b, n, h) and out.dtype == dtype
    err = float(((out.float() - ref.float()) * mask[..., None]).abs().max())
    assert err < tol, err


def test_kernel_rejects_what_it_does_not_take(cuda):
    qkv, mask, norms = _inputs(cuda, torch.float32, 2, 8, 64, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_block_attention(qkv.half(), mask, *[p.half() for p in norms], 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block_attention(qkv.transpose(0, 1), mask, *norms, 4)
    with pytest.raises(ValueError, match="q_scale"):
        fused_block_attention(qkv, mask, norms[0].bfloat16(), *norms[1:], 4)
    big, big_mask, big_norms = _inputs(cuda, torch.float32, 1, 256, 256, 2)
    with pytest.raises(ValueError, match="shared memory"):
        fused_block_attention(big, big_mask, *big_norms, 2)
    # no backward: an input that would record a graph is refused
    with pytest.raises(RuntimeError, match="no backward"):
        fused_block_attention(qkv.clone().requires_grad_(), mask, *norms, 4)
    with torch.no_grad():
        fused_block_attention(qkv.clone().requires_grad_(), mask, *norms, 4)
    # the tensor-core body copies 16-byte rows: a misaligned view is refused
    x16, _, n16 = _inputs(cuda, torch.bfloat16, 2, 8, 64, 4)
    shifted = torch.empty(x16.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(x16.shape)
    with pytest.raises(ValueError, match="aligned"):
        fused_block_attention(shifted, mask, *n16, 4)


def _padded_masks(dev, gen, b, n):
    """Random key masks that keep node 0, with graph 0 a molecule padded
    by its last 14 nodes and graph 1 (when there is one) masked entirely."""
    mask = torch.rand(b, n, device=dev, generator=gen) > 0.3
    mask[:, 0] = True
    mask[0, max(n - 14, 1):] = False
    if b > 1:
        mask[1] = False
    return mask


@pytest.mark.parametrize("shape", [MAIN_SHAPE, (5, 17, 128, 4),
                                   (8, 64, 256, 8),
                                   (4, 9, 64, 4),       # dh 16
                                   (3, 33, 512, 4)])    # dh 128
def test_tensor_core_body_matches_plain(cuda, shape):
    """Kernel A's bf16 tensor-core body on every row (masking is on the
    key side only), padded and fully masked graphs included; the launch
    counts on the mma body."""
    b, n, h, heads = shape
    assert attention_body(n, h // heads, torch.bfloat16) == "mma"
    qkv, _, norms = _inputs(cuda, torch.bfloat16, *shape, seed=7)
    mask = _padded_masks(cuda, torch.Generator(device=cuda).manual_seed(8),
                         b, n)
    before = (fused_block_attention.launches_mma,
              fused_block_attention.launches_fma)
    out = fused_block_attention(qkv, mask, *norms, heads)
    torch.cuda.synchronize()
    assert (fused_block_attention.launches_mma,
            fused_block_attention.launches_fma) == (before[0] + 1, before[1])
    ref = fused_attention_reference(qkv, mask, *norms, heads)
    assert torch.isfinite(out).all()
    assert float((out.float() - ref.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("shape", [(4, 64, 512, 4),    # N 64, dh 128
                                   (4, 64, 64, 4)])    # N 64, dh 16
def test_tf32x3_body_matches_plain(cuda, shape):
    """Kernel A's f32 tensor-core body at its largest N and at both ends
    of its head widths, with a padded and a fully masked graph, against
    the plain version at the f32 contract; the launch on its counter."""
    b, n, h, heads = shape
    assert attention_body(n, h // heads, torch.float32) == "tf32x3"
    qkv, _, norms = _inputs(cuda, torch.float32, *shape, seed=11)
    mask = _padded_masks(cuda, torch.Generator(device=cuda).manual_seed(12),
                         b, n)
    before = (fused_block_attention.launches_tf32x3,
              fused_block_attention.launches_fma)
    out = fused_block_attention(qkv, mask, *norms, heads)
    torch.cuda.synchronize()
    assert (fused_block_attention.launches_tf32x3,
            fused_block_attention.launches_fma) == (before[0] + 1, before[1])
    ref = fused_attention_reference(qkv, mask, *norms, heads)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) < 1e-4


# kernel B (GIN aggregation): the path shapes (GraphCLIP splice of a width-8
# frontier, one predictor product, the training bank's shape), two odd
# ones, H not a multiple of 4 (the scalar lanes), and dense graphs with N
# past kernel C's limit (the plain version forms [B, N, N, H]: 315 MB a
# graph at N = 512)
GIN_SHAPES = [(8, 56, 300), (1, 24, 300), (80, 50, 300), (3, 11, 40),
              (2, 17, 64), (4, 50, 42), (4, 50, 150)]
GIN_DENSE = [(2, 200, 300), (1, 512, 300)]


def gin_inputs(dev, dtype, b, n, h, seed=0, symmetric=True, dense=False):
    """Random graphs: edge classes 0-4 (symmetric like molecules unless
    asked), the last nodes of each graph padded away (every node kept with
    dense), adj = edge > 0 on valid pairs, a [5, H] bond table."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, n, h, device=dev, generator=gen).to(dtype)
    edge = torch.randint(0, 5, (b, n, n), device=dev, generator=gen)
    if symmetric:
        edge = edge.triu(1)
        edge = edge + edge.transpose(1, 2)
    valid = torch.arange(n, device=dev)[None] < torch.randint(
        1, n + 1, (b, 1), device=dev, generator=gen)
    if dense:
        valid = torch.ones_like(valid)
    pair = valid[:, :, None] & valid[:, None, :]
    adj = ((edge > 0) & pair).to(dtype)
    table = torch.randn(5, h, device=dev, generator=gen).to(dtype)
    return x, edge.to(torch.int32).contiguous(), adj, table


@pytest.mark.parametrize("shape,dense", [(s, False) for s in GIN_SHAPES]
                         + [(s, True) for s in GIN_DENSE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gin_kernel_matches_plain(cuda, shape, dense, dtype, symmetric):
    x, edge, adj, table = gin_inputs(cuda, dtype, *shape,
                                     symmetric=symmetric, dense=dense)
    before = gin_aggregate.launches
    with torch.no_grad():
        out = gin_aggregate(x, edge, adj, table)
    torch.cuda.synchronize()
    assert gin_aggregate.launches == before + 1
    ref = gin_aggregate_reference(x, edge, adj, table)
    assert out.shape == shape and out.dtype == dtype
    if dtype == torch.float32:      # the JAX kernel's contract
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    else:                           # the output rounds once to bf16
        err = float((out.float() - ref.float()).abs().max())
        assert err <= 1e-2 * float(ref.float().abs().max()), err
    # no atomics: the same bits on every run
    with torch.no_grad():
        assert torch.equal(gin_aggregate(x, edge, adj, table), out)


@pytest.mark.parametrize("shape", [(1, 4, 8), (80, 50, 300)])
def test_gin_kernel_empty_graph_is_zero(cuda, shape):
    """One graph without a bond, and a bank of 80 (the training bank's
    padding rows, all of it): exact zeros, whatever x holds."""
    b, n, h = shape
    x = torch.randn(b, n, h, device=cuda)
    edge = torch.zeros(b, n, n, dtype=torch.int32, device=cuda)
    adj = torch.zeros(b, n, n, device=cuda)
    table = torch.ones(5, h, device=cuda)
    out = gin_aggregate(x, edge, adj, table)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_gin_kernel_rejects_what_it_does_not_take(cuda):
    x, edge, adj, table = gin_inputs(cuda, torch.float32, 2, 9, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gin_aggregate(x.half(), edge, adj.half(), table.half())
    with pytest.raises(ValueError, match="contiguous"):
        gin_aggregate(x.transpose(0, 1).contiguous().transpose(0, 1), edge,
                      adj, table)
    with pytest.raises(ValueError, match="int32"):
        gin_aggregate(x, edge.long(), adj, table)
    with pytest.raises(ValueError, match="adj"):
        gin_aggregate(x, edge, adj.bfloat16(), table)
    with pytest.raises(ValueError, match="table"):
        gin_aggregate(x, edge, adj, table[:4].contiguous())
    with pytest.raises(ValueError, match="unsupported device"):
        gin_aggregate(x.to("meta"), edge.to("meta"), adj.to("meta"),
                      table.to("meta"))
    # the backward kernel checks its own inputs too
    g = torch.ones_like(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gin_aggregate_backward(x.half(), edge, adj.half(), table.half(),
                               g.half())
    with pytest.raises(ValueError, match="g must be"):
        gin_aggregate_backward(x, edge, adj, table, g.bfloat16())
    with pytest.raises(ValueError, match="int32"):
        gin_aggregate_backward(x, edge.long(), adj, table, g)


# kernel C (GIN backward): the JAX contract shape, an odd one, H not a
# multiple of 4 (the scalar lane path) and the training path's predictor
# batch
GIN_BWD_SHAPES = [(2, 9, 24), (3, 11, 40), (3, 11, 42), (4, 50, 150),
                  (80, 50, 300)]


@pytest.mark.parametrize("shape", GIN_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gin_backward_kernel_matches_plain(cuda, shape, dtype, symmetric):
    x, edge, adj, table = gin_inputs(cuda, dtype, *shape, symmetric=symmetric)
    g = torch.randn(shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(dtype)
    before = gin_aggregate_backward.launches
    dx, dt = gin_aggregate_backward(x, edge, adj, table, g)
    torch.cuda.synchronize()
    assert gin_aggregate_backward.launches == before + 1
    rdx, rdt = gin_aggregate_backward_reference(x, edge, adj, table, g)
    assert dx.dtype == dtype and dt.dtype == dtype and dt.shape == (5,
                                                                    shape[2])
    for got, ref, name in ((dx, rdx, "dx"), (dt, rdt, "dtable")):
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if dtype == torch.bfloat16:     # f32 sums rounded once to bf16
            assert err <= 1e-2 * scale, (name, err)
        elif name == "dtable" and shape == (80, 50, 300):
            # each entry sums ~B * N^2 / 5 = 40000 terms of these dense
            # random graphs (the path's molecules have ~1/20 of them), so
            # f32 reordering error scales with the sum: 1e-4 of its range
            assert err <= 1e-4 * scale, (name, err, scale)
        else:                           # the JAX kernel's contract
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    # no float atomics: the same bits on every run
    again = gin_aggregate_backward(x, edge, adj, table, g)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dt)


def test_gin_backward_kernel_empty_graph_is_zero(cuda):
    dx, dt = gin_aggregate_backward(
        torch.zeros(1, 4, 8, device=cuda),
        torch.zeros(1, 4, 4, dtype=torch.int32, device=cuda),
        torch.zeros(1, 4, 4, device=cuda), torch.ones(5, 8, device=cuda),
        torch.ones(1, 4, 8, device=cuda))
    torch.cuda.synchronize()
    assert not dx.any() and not dt.any()


def test_gin_backward_kernel_all_empty_bank_is_zero(cuda):
    """A bank of 80 graphs without a bond (the training bank's padding
    rows, all of it) gives exact zeros, whatever x and g hold."""
    b, n, h = 80, 50, 300
    none = torch.zeros(b, n, n, device=cuda)
    dx, dt = gin_aggregate_backward(
        torch.randn(b, n, h, device=cuda), none.to(torch.int32), none,
        torch.ones(5, h, device=cuda), torch.ones(b, n, h, device=cuda))
    torch.cuda.synchronize()
    assert not dx.any() and not dt.any()


def padded_bank(dev, last):
    """chip_smoke.py's MOLECULES in the first or the last rows of the
    training path's 80-graph bank (80, 50, 300), the rest empty: (x, edge,
    adj, table, g, node mask)."""
    import chip_smoke
    b, n, h = chip_smoke.GIN_TRAIN
    _, edge, mask, adj = chip_smoke.path_graphs(b, n, last, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x, g = (torch.randn(b, n, h, device=dev, generator=gen)
            for _ in range(2))
    table = torch.randn(5, h, device=dev, generator=gen)
    return x, edge, adj, table, g, mask


@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
def test_gin_kernel_molecules_in_a_padded_bank(cuda, last):
    """Kernel B on the training bank: the molecules' rows within the JAX
    contract, every row of the empty graphs exactly 0."""
    x, edge, adj, table, _, mask = padded_bank(cuda, last)
    with torch.no_grad():
        out = gin_aggregate(x, edge, adj, table)
    torch.cuda.synchronize()
    ref = gin_aggregate_reference(x, edge, adj, table)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert not out[mask.logical_not().all(dim=1)].any()


@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
def test_gin_backward_kernel_molecules_in_a_padded_bank(cuda, last):
    """Molecules in the first or the last rows of an 80-graph bank, the
    rest empty: the empty graphs' early exit must not disturb the rows
    around it."""
    x, edge, adj, table, g, mask = padded_bank(cuda, last)
    dx, dt = gin_aggregate_backward(x, edge, adj, table, g)
    torch.cuda.synchronize()
    rdx, rdt = gin_aggregate_backward_reference(x, edge, adj, table, g)
    torch.testing.assert_close(dx, rdx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dt, rdt, atol=1e-4, rtol=1e-4)
    assert not dx[mask.logical_not().all(dim=1)].any()


def _check_dense_backward(dx, dt, rdx, rdt, dtype):
    for got, ref, name in ((dx, rdx, "dx"), (dt, rdt, "dtable")):
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if dtype == torch.bfloat16:     # f32 sums rounded once to bf16
            assert err <= 1e-2 * scale, (name, err)
        elif name == "dtable":
            # an entry sums ~2 * N^2 / 5 terms (~10^4 and more): 1e-4 of
            # its range, as for the dense (80, 50, 300) case
            assert err <= 1e-4 * scale, (name, err, scale)
        else:                           # the JAX kernel's contract
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("body", ["smem", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gin_backward_kernel_at_its_largest_n(cuda, body, dtype):
    """Dense random graphs (every node kept) at the largest N each body's
    shared memory takes: 161 staged, 1292 with the column masks alone."""
    from llamole_tpu_torch.ops.gin_aggregate import (GIN_BWD_MAX_NODES,
                                                     GIN_BWD_SMEM_MAX_NODES,
                                                     gin_backward_body)
    n = GIN_BWD_SMEM_MAX_NODES if body == "smem" else GIN_BWD_MAX_NODES
    assert gin_backward_body(n) == body
    x, edge, adj, table = gin_inputs(cuda, dtype, 2 if body == "smem" else 1,
                                     n, 64)
    adj = (edge > 0).to(dtype)               # every node kept
    g = torch.randn_like(x)
    before = getattr(gin_aggregate_backward, f"launches_{body}")
    dx, dt = gin_aggregate_backward(x, edge, adj, table, g)
    torch.cuda.synchronize()
    assert getattr(gin_aggregate_backward, f"launches_{body}") == before + 1
    rdx, rdt = gin_aggregate_backward_reference(x, edge, adj, table, g)
    _check_dense_backward(dx, dt, rdx, rdt, dtype)


@pytest.mark.parametrize("n", [162, 168, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gin_backward_global_body_past_the_staged_limit(cuda, n, dtype):
    """N past the staged body's 161 (one large molecule widens a whole
    pretraining bank): dense graphs on the second body, within the
    tolerances of the first, the same bits on two runs, and each launch
    counted on the body its N routes to."""
    from llamole_tpu_torch.ops.gin_aggregate import gin_backward_body
    assert gin_backward_body(n) == "global"
    x, edge, adj, table = gin_inputs(cuda, dtype, 2, n, 64)
    adj = (edge > 0).to(dtype)
    g = torch.randn_like(x)
    counts = (gin_aggregate_backward.launches,
              gin_aggregate_backward.launches_smem,
              gin_aggregate_backward.launches_global)
    dx, dt = gin_aggregate_backward(x, edge, adj, table, g)
    again = gin_aggregate_backward(x, edge, adj, table, g)
    torch.cuda.synchronize()
    assert (gin_aggregate_backward.launches,
            gin_aggregate_backward.launches_smem,
            gin_aggregate_backward.launches_global) == (
        counts[0] + 2, counts[1], counts[2] + 2)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dt)
    rdx, rdt = gin_aggregate_backward_reference(x, edge, adj, table, g)
    _check_dense_backward(dx, dt, rdx, rdt, dtype)


@pytest.mark.parametrize("n", [24, 50, 161])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gin_backward_bodies_give_the_same_bits(cuda, n, dtype):
    """The two bodies differ only in where a pair's adj value and class are
    read, so at an N the staged body takes, the second body (launched past
    the routing) returns the same bits."""
    from llamole_tpu_torch.ops.gin_aggregate import _launch_backward
    x, edge, adj, table = gin_inputs(cuda, dtype, 3, n, 300)
    g = torch.randn_like(x)
    staged = gin_aggregate_backward(x, edge, adj, table, g)
    second = _launch_backward(x, edge, adj, table, g, "global")
    torch.cuda.synchronize()
    assert torch.equal(staged[0], second[0])
    assert torch.equal(staged[1], second[1])


def test_gin_backward_kernel_refuses_n_past_its_limit(cuda):
    """Past the second body's 1292 the column masks outgrow shared memory:
    a ValueError, nothing launched."""
    from llamole_tpu_torch.ops.gin_aggregate import GIN_BWD_MAX_NODES
    n = GIN_BWD_MAX_NODES + 1
    x, edge, adj, table = gin_inputs(cuda, torch.float32, 1, n, 8)
    before = gin_aggregate_backward.launches
    with pytest.raises(ValueError, match="shared memory"):
        gin_aggregate_backward(x, edge, adj, table, torch.ones_like(x))
    assert gin_aggregate_backward.launches == before


def test_gin_autograd_on_the_card_matches_plain_autograd(cuda):
    """gin_aggregate under autograd on the card (kernels B and C) against
    autograd through the plain forward."""
    x, edge, adj, table = gin_inputs(cuda, torch.float32, 3, 11, 40,
                                     symmetric=False)
    g = torch.randn_like(x)
    got_in = [x.clone().requires_grad_(), table.clone().requires_grad_()]
    ref_in = [x.clone().requires_grad_(), table.clone().requires_grad_()]
    before = (gin_aggregate.launches, gin_aggregate_backward.launches)
    out = gin_aggregate(got_in[0], edge, adj, got_in[1])
    out.backward(g)
    assert (gin_aggregate.launches, gin_aggregate_backward.launches) == (
        before[0] + 1, before[1] + 1)
    gin_aggregate_reference(ref_in[0], edge, adj, ref_in[1]).backward(g)
    for u, v in zip(got_in, ref_in):
        torch.testing.assert_close(u.grad, v.grad, atol=1e-4, rtol=1e-4)


# kernel D (pre-split graph attention): the JAX contract shapes and the
# denoiser's head shape
ATTN_SHAPES = [((2, 4, 13, 24), torch.float32, 2e-5),
               ((1, 2, 64, 64), torch.float32, 2e-5),
               ((3, 8, 50, 32), torch.float32, 2e-5),
               ((16, 16, 50, 64), torch.float32, 1e-4),
               ((16, 16, 50, 64), torch.bfloat16, 2e-2)]


@pytest.mark.parametrize("shape,dtype,tol", ATTN_SHAPES)
def test_graph_attention_kernel_matches_plain(cuda, shape, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
               for _ in range(3))
    mask = torch.rand(shape[0], shape[2], device=cuda, generator=gen) > 0.3
    mask[:, 0] = True
    counter = f"launches_{attention_body(shape[2], shape[3], dtype)}"
    before = graph_attention.launches, getattr(graph_attention, counter)
    out = graph_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert (graph_attention.launches, getattr(graph_attention, counter)) == (
        before[0] + 1, before[1] + 1)
    ref = masked_attention(q, k, v, key_mask=mask)
    assert out.shape == shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) < tol


def test_graph_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(2, 4, 9, 16, device=cuda)
    mask = torch.ones(2, 9, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        graph_attention(q.half(), q.half(), q.half(), mask)
    with pytest.raises(ValueError, match="k must be"):
        graph_attention(q, q.bfloat16(), q, mask)
    with pytest.raises(ValueError, match="v must be"):
        graph_attention(q, q, q.transpose(2, 3).contiguous().transpose(2, 3),
                        mask)
    with pytest.raises(ValueError, match="key_mask"):
        graph_attention(q, q, q, mask.float())
    with pytest.raises(RuntimeError, match="no backward"):
        graph_attention(q.clone().requires_grad_(), q, q, mask)
    big = torch.randn(1, 1, 256, 256, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        graph_attention(big, big, big)


@pytest.mark.parametrize("shape", [(16, 16, 50, 64), (3, 2, 7, 16),
                                   (2, 4, 64, 32), (2, 3, 40, 128)])
def test_graph_attention_tensor_core_body_matches_plain(cuda, shape):
    """Kernel D's bf16 tensor-core body at the denoiser's head shape and at
    every head width it takes, with a padded and a fully masked graph, on
    the mma counter."""
    assert attention_body(shape[2], shape[3], torch.bfloat16) == "mma"
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).bfloat16()
               for _ in range(3))
    mask = _padded_masks(cuda, gen, shape[0], shape[2])
    before = graph_attention.launches_mma, graph_attention.launches_fma
    out = graph_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert (graph_attention.launches_mma, graph_attention.launches_fma) == (
        before[0] + 1, before[1])
    ref = masked_attention(q, k, v, key_mask=mask)
    assert torch.isfinite(out).all()
    assert float((out.float() - ref.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("shape", [(2, 3, 64, 128), (3, 4, 64, 16)])
def test_graph_attention_tf32x3_body_matches_plain(cuda, shape):
    """Kernel D's f32 tensor-core body at N 64 with dh 128 and dh 16, a
    padded and a fully masked graph among them, within JAX's f32 contract
    (2e-5), on the tf32x3 counter."""
    assert attention_body(shape[2], shape[3], torch.float32) == "tf32x3"
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen)
               for _ in range(3))
    mask = _padded_masks(cuda, gen, shape[0], shape[2])
    before = graph_attention.launches_tf32x3, graph_attention.launches_fma
    out = graph_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert (graph_attention.launches_tf32x3, graph_attention.launches_fma) == (
        before[0] + 1, before[1])
    ref = masked_attention(q, k, v, key_mask=mask)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) < 2e-5


def _flash_inputs(dev, dtype, b, s, h, kv, d, seed=17, split=None,
                  right=19):
    """Seeded q, k, v, dO and segment ids: row 0 left-padded, the last
    row right-padded by `right` keys (a single row both); `split` starts a
    second segment (id 2) in the last row there, as packed sequences do."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(b, s, kv, d, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    dout = torch.randn(b, s, h * d, device=dev, generator=gen).to(dtype)
    seg = torch.ones(b, s, dtype=torch.int32, device=dev)
    seg[0, :11] = 0
    if split is not None:
        seg[-1, split:] = 2
    seg[-1, s - right:] = 0
    return q, k, v, dout, seg


def _flash_grads(fn, q, k, v, dout, seg):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, seg)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


def _bf16_step(x: float) -> float:
    """One bf16 step (a unit in the last of its 8 significant bits) at
    |x|: 2^(e - 8) for |x| in [2^(e - 1), 2^e)."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


# (B, S, H, KV, D), the start of a second segment in the last row, and
# whether a bf16 output may also be one bf16 step of its largest value
# from the plain version: the first two shapes are held to 2e-2 alone;
# then the bf16 backward's grid edges: a group of 8 (the dkv
# workspace's longest head-order sum; its dq, dK and dV reach past 4,
# where a step is 3.1e-2), G = 1 (no workspace: dK and dV written in
# bf16 by the block), B = 2 with a segment boundary at key 200 (inside
# the second 128-key tile, off the 64-row steps), the smallest S the
# kernels take, and G = 1 at head_dim 256 (in f32 dK and dV written by
# the split-TF32 dkv block itself)
FLASH_SHAPES = [
    pytest.param(shape, split, one_step, id="x".join(map(str, shape))
                 + ("" if split is None else f"-split{split}"))
    for shape, split, one_step in (((2, 256, 4, 2, 128), None, False),
                                   ((1, 128, 2, 1, 256), None, False),
                                   ((1, 256, 8, 1, 128), None, True),
                                   ((1, 256, 4, 4, 128), None, True),
                                   ((2, 256, 4, 2, 128), 200, True),
                                   ((1, 128, 2, 1, 128), None, True),
                                   ((1, 256, 2, 2, 256), None, True))]


@pytest.mark.parametrize("shape,split,one_step", FLASH_SHAPES)
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),     # split-TF32 forward and backward
    (torch.bfloat16, 2e-2),    # bf16 operands and outputs, ~4e-3 relative
])
def test_flash_attention_matches_plain(cuda, shape, split, one_step, dtype,
                                       tol):
    """Kernel E's forward, dq and dkv kernels against
    flash_attention_reference and its autograd at a padded GQA shape: the
    output and dq / dk / dv (pad rows included), one launch of each.
    Where `one_step`, a bf16 output may also be up to one bf16 step of its
    largest value off: the kernel and the plain version round f32 sums
    taken in other orders, so one rounding apart is a correct result."""
    q, k, v, dout, seg = _flash_inputs(cuda, dtype, *shape, split=split)
    E.reset_launches()
    out, grads = _flash_grads(E.flash_attention, q, k, v, dout, seg)
    torch.cuda.synchronize()
    assert (E.flash_attention.launches_fwd, E.flash_attention.launches_dq,
            E.flash_attention.launches_dkv) == (1, 1, 1)
    ref, ref_grads = _flash_grads(E.flash_attention_reference, q, k, v,
                                  dout, seg)
    assert out.shape == ref.shape and out.dtype == dtype
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (ref, *ref_grads)):
        assert torch.isfinite(got).all(), name
        err = float((got.float() - want.float()).abs().max())
        if one_step and dtype == torch.bfloat16:
            step = _bf16_step(float(want.float().abs().max()))
            assert err < tol or err <= step, (name, err, step)
        else:
            assert err < tol, (name, err)


# the backward at head_dim 256 (its wgmma_wide bodies: 64-row blocks,
# 64-key / 64-query steps): G = 1 (dK and dV written in bf16 by the
# block) at 8 steps, G = 2 (the dkv workspace and its group sum) with B =
# 2 and a second segment from key 200 (inside the fourth 64-key step),
# and G = 4 right-padded past a whole step
D256_SHAPES = [
    pytest.param(shape, split, right, id="x".join(map(str, shape))
                 + ("" if split is None else f"-split{split}")
                 + f"-right{right}")
    for shape, split, right in (((1, 512, 4, 4, 256), None, 19),
                                ((2, 384, 4, 2, 256), 200, 19),
                                ((1, 256, 8, 2, 256), None, 100))]


@pytest.mark.parametrize("shape,split,right", D256_SHAPES)
def test_flash_backward_d256_matches_plain(cuda, shape, split, right):
    """Kernel E's bf16 dq and dkv kernels at head_dim 256 (one launch of
    each, on the wgmma_wide bodies) against flash_attention_reference's
    autograd, pad rows included: dq / dk / dv within 2e-2 or one bf16
    step of the largest value (f32 sums in other orders), as
    test_flash_attention_matches_plain holds its later shapes."""
    assert E.backward_body(torch.bfloat16, 256) == "wgmma_wide"
    q, k, v, dout, seg = _flash_inputs(cuda, torch.bfloat16, *shape,
                                       split=split, right=right)
    E.reset_launches()
    _, grads = _flash_grads(E.flash_attention, q, k, v, dout, seg)
    torch.cuda.synchronize()
    assert (E.flash_attention.launches_dq,
            E.flash_attention.launches_dkv) == (1, 1)
    _, ref_grads = _flash_grads(E.flash_attention_reference, q, k, v, dout,
                                seg)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        step = _bf16_step(float(want.float().abs().max()))
        assert err < 2e-2 or err <= step, (name, err, step)


# the forward alone: FLASH_SHAPES (right-padded by 19), then two rows of
# which the last is right-padded by 200 keys: its pad rows' first two
# 128-key steps are all masked (rows 312-319 run them masked, the
# warpgroups of rows 320-511 skip them)
FORWARD_SHAPES = [pytest.param(*p.values, 19, id=p.id) for p in FLASH_SHAPES] + [
    pytest.param((2, 512, 4, 2, 128), None, True, 200,
                 id="2x512x4x2x128-right200")]


@pytest.mark.parametrize("shape,split,one_step,right", FORWARD_SHAPES)
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),
    (torch.bfloat16, 2e-2),
])
def test_flash_forward_matches_plain(cuda, shape, split, one_step, right,
                                     dtype, tol):
    """The forward kernel alone (flash_forward, one launch) against
    flash_forward_reference: the output held as
    test_flash_attention_matches_plain holds it, the f32 log-sum-exp that
    the backward reads within 1e-3, pad rows included."""
    q, k, v, _, seg = _flash_inputs(cuda, dtype, *shape, split=split,
                                    right=right)
    E.reset_launches()
    out, lse = E.flash_forward(q, k, v, seg)
    torch.cuda.synchronize()
    assert E.flash_attention.launches_fwd == 1
    ref, ref_lse = E.flash_forward_reference(q, k, v, seg)
    assert out.shape == ref.shape and out.dtype == dtype
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    err = float((out.float() - ref.float()).abs().max())
    if one_step and dtype == torch.bfloat16:
        step = _bf16_step(float(ref.float().abs().max()))
        assert err < tol or err <= step, (err, step)
    else:
        assert err < tol, err
    assert float((lse - ref_lse).abs().max()) < 1e-3


@pytest.mark.parametrize("shape", [(1, 512, 16, 4, 128), (1, 256, 4, 4, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_gives_the_same_bits(cuda, shape):
    """Two forward runs give equal outputs and log-sum-exps."""
    q, k, v, _, seg = _flash_inputs(cuda, torch.bfloat16, *shape)
    first = E.flash_forward(q, k, v, seg)
    second = E.flash_forward(q, k, v, seg)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape", [(1, 256, 8, 2, 128), (1, 512, 16, 4, 128),
                                   (1, 512, 8, 8, 256), (1, 512, 8, 4, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_backward_gives_the_same_bits(cuda, shape):
    """No float atomics: two backward runs give equal dq, dk, dv (the
    second shape: G = 4 through the dkv workspace, four 128-key tiles;
    the last two: head_dim 256 at G = 1 and G = 2)."""
    q, k, v, dout, seg = _flash_inputs(cuda, torch.bfloat16, *shape)
    first = _flash_grads(E.flash_attention, q, k, v, dout, seg)[1]
    second = _flash_grads(E.flash_attention, q, k, v, dout, seg)[1]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q, k, v, _, seg = _flash_inputs(cuda, torch.float32, 1, 256, 4, 2, 128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        E.flash_attention(q.half(), k.half(), v.half(), seg)
    with pytest.raises(ValueError, match="head_dim"):
        E.flash_attention(q[..., :64], k[..., :64], v[..., :64], seg)
    with pytest.raises(ValueError, match="multiple of"):
        E.flash_attention(q[:, :192], k[:, :192], v[:, :192], seg[:, :192])
    with pytest.raises(ValueError, match="KV heads"):
        E.flash_attention(q[:, :, :3], k, v, seg)
    with pytest.raises(ValueError, match="segment_ids"):
        E.flash_attention(q, k, v, seg.bool())
