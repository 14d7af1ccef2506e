"""Small NN building blocks (counterpart of llamole_tpu/ops/nn.py).

Conventions:
  - nn.Linear weights are [out, in]; the weight bridge (weights.py)
    transposes the JAX package's [in, out] kernels
  - modules are built on the meta device and materialised with
    `Module.to_empty`, then filled by a seeded `init_*` (explicit
    torch.Generator) or by `load_state_dict` from the bridge
  - initializers mirror the JAX ones (xavier_uniform Linear, zero bias)
  - `quantize_dense` turns an nn.Linear into its int8 serving form
    (`Int8Dense`: JAX quantize_dense / _dense_int8), not differentiable
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


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 through
    torch._int_mm. Its CUDA path takes more than 16 rows and K, N
    multiples of 8: rows, K and N are zero-padded to that (zeros add
    nothing to an integer product) and the padding is cut off again.
    Counts its calls in `int8_matmul.launches`."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_up8(m), 24), _up8(k), _up8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    int8_matmul.launches += 1
    return torch._int_mm(a, b)[:m, :n]


int8_matmul.launches = 0


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def dense_int8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX _dense_int8: rows of x quantized by their amax / 127 (floored
    at 1e-8), an s8 x s8 -> s32 product with w_q [out, in], rescaled by
    row scale x column scale in f32, cast to x's dtype, then the bias."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    rows = (x2.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    x8 = torch.clamp(torch.round(x2 / rows), -127, 127).to(torch.int8)
    acc = int8_matmul(x8, w_q.t())
    y = (acc.float() * rows * scale[None, :]).reshape(*lead, -1).to(x.dtype)
    return y if bias is None else y + bias


class Int8Dense(nn.Module):
    """An nn.Linear's int8 serving form: w_q [out, in] int8 and scale [out]
    f32 per output channel, the bias kept as it was (all buffers).
    Serving only: a forward whose input requires grad raises, as the JAX
    quantizer is not differentiable."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("an int8-quantized dense layer is serving "
                               "only: it has no gradient (run it under "
                               "torch.no_grad)")
        return dense_int8(x, self.w_q, self.scale, self.bias)


@torch.no_grad()
def quantize_dense(linear: nn.Linear) -> Int8Dense:
    """JAX quantize_dense: per-output-channel scales amax / 127 (floored at
    1e-8), values rounded half-to-even and clipped to +-127."""
    w = linear.weight.float()
    scale = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    bias = None if linear.bias is None else linear.bias.detach().clone()
    return Int8Dense(w_q.to(torch.int8), scale, bias)


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
