"""Small NN building blocks (counterpart of llamole_tpu/ops/nn.py).

Conventions:
  - nn.Linear weights are [out, in]; the weight bridge (weights.py)
    transposes the JAX package's [in, out] kernels
  - modules are built on the meta device and materialised with
    `Module.to_empty`, then filled by a seeded `init_*` (explicit
    torch.Generator) or by `load_state_dict` from the bridge
  - initializers mirror the JAX ones (xavier_uniform Linear, zero bias)
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In-place xavier-uniform of an [out, in] weight."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-a, a, generator=generator)


def init_dense_(linear: nn.Linear, generator: torch.Generator) -> None:
    """JAX dense_init: xavier-uniform weight, zero bias."""
    xavier_uniform_(linear.weight, generator)
    if linear.bias is not None:
        with torch.no_grad():
            linear.bias.zero_()


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, cast back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, jax.nn.gelu(approximate=False)."""
    return F.gelu(x, approximate="none")


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x.abs())


class LayerNorm(nn.Module):
    """Affine LayerNorm parameters applied through `layer_norm`."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MLP(nn.Module):
    """fc1 -> exact GELU -> fc2 (JAX mlp_init / mlp_apply)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
