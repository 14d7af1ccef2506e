"""The port's CUDA kernels on the card (marked `gpu`; they skip without one,
since a CUDA kernel has no CPU mode).

This file imports only torch and the port, so the machine with the card,
which has no JAX, runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from llamole_tpu_torch.ops.fused_attention import (
    fused_attention_reference, fused_block_attention)
from llamole_tpu_torch.ops.gin_aggregate import (gin_aggregate,
                                                 gin_aggregate_reference)

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
    before = fused_block_attention.launches
    out = fused_block_attention(qkv, mask, *norms, heads)
    torch.cuda.synchronize()
    assert fused_block_attention.launches == before + 1
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


# kernel B (GIN aggregation): the path shapes (GraphCLIP splice of a width-8
# frontier, one predictor product) and two odd ones
GIN_SHAPES = [(8, 56, 300), (1, 24, 300), (3, 11, 40), (2, 17, 64)]


def gin_inputs(dev, dtype, b, n, h, seed=0, symmetric=True):
    """Random graphs: edge classes 0-4 (symmetric like molecules unless
    asked), the last nodes of each graph padded away, adj = edge > 0 on
    valid pairs, a [5, H] bond table."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, n, h, device=dev, generator=gen).to(dtype)
    edge = torch.randint(0, 5, (b, n, n), device=dev, generator=gen)
    if symmetric:
        edge = edge.triu(1)
        edge = edge + edge.transpose(1, 2)
    valid = torch.arange(n, device=dev)[None] < torch.randint(
        1, n + 1, (b, 1), device=dev, generator=gen)
    pair = valid[:, :, None] & valid[:, None, :]
    adj = ((edge > 0) & pair).to(dtype)
    table = torch.randn(5, h, device=dev, generator=gen).to(dtype)
    return x, edge.to(torch.int32).contiguous(), adj, table


@pytest.mark.parametrize("shape", GIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gin_kernel_matches_plain(cuda, shape, dtype, symmetric):
    x, edge, adj, table = gin_inputs(cuda, dtype, *shape,
                                     symmetric=symmetric)
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


def test_gin_kernel_empty_graph_is_zero(cuda):
    x = torch.zeros(1, 4, 8, device=cuda)
    edge = torch.zeros(1, 4, 4, dtype=torch.int32, device=cuda)
    adj = torch.zeros(1, 4, 4, device=cuda)
    table = torch.ones(5, 8, device=cuda)
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
    with pytest.raises(RuntimeError, match="no backward"):
        gin_aggregate(x.requires_grad_(), edge, adj, table)
