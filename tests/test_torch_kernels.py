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
