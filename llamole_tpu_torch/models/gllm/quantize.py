"""Int8 / int4 / W8A8 quantization of the LLM's projections for serving
(counterpart of llamole_tpu/models/gllm/quantize.py).

int8: per-output-channel scales (amax / 127, floored at 1e-8). int4:
group-wise scales along the contraction (`int4_groups`: group_size input
columns share one scale per output channel, the gptq / awq layout), values
in [-7, 7] packed two a byte. W8A8: the int8 weights, run with activations
quantized per token (gllm/lora.py). The attention and MLP projections and
the lm_head are quantized; the embedding and the norms stay in the compute
dtype, and so do an MoE LLM's router and experts (with the JAX
package's warning: for Mixtral they are most of the weights).

Everything works in place on an LLM's modules, one projection at a time
on the parameters' device, so a dense tree and its quantized copy never
coexist whole:

  quantize_llm_params(llm, bits, group_size, act_int8)  from the weights
  init_quantized_(llm, generator, bits, group_size, act_int8)
      random values drawn straight into the quantized layout (the JAX
      init_params_quantized: int8 uniform in [-127, 127] with the
      constant scale in_dim**-0.5 / 73.3, int4 in [-7, 7] with
      in_dim**-0.5 / 4.32, so the dequantized weights have std
      in_dim**-0.5; embeddings N(0, 0.02)); an LLM built with
      LLM(..., quant=...) never holds the dense weights at all
  quantized_bytes(llm)  the bytes of its base weights (on a mesh, the
      rank's own: its tensor-parallel shards and ZeRO-3 chunks)
"""

from typing import Iterator, Tuple

import torch
from torch import nn

from ...utils.logging import get_logger
from .lora import LoRALinear, pack_int4

logger = get_logger(__name__)


def quant_scheme(bits: int, act_int8: bool = False) -> str:
    """'int8', 'w8a8' or 'int4' for (bits, act_int8); ValueError for
    what the JAX package refuses."""
    if bits not in (4, 8):
        raise ValueError(f"quantization bits must be 4 or 8, got {bits}")
    if act_int8 and bits != 8:
        raise ValueError("act_int8 (W8A8) requires bits=8")
    if bits == 4:
        return "int4"
    return "w8a8" if act_int8 else "int8"


def llm_quant(scheme: str, group_size: int) -> Tuple[str, int]:
    """An LLM's `quant`: (scheme, group_size), the group size 0 unless
    the scheme is int4 (int8 scales are per channel whatever it is)."""
    return scheme, group_size if scheme == "int4" else 0


def int4_groups(in_dim: int, group_size: int) -> int:
    """Number of scale groups along the contraction (1 = per channel)."""
    if group_size and in_dim % group_size == 0 and in_dim > group_size:
        return in_dim // group_size
    return 1


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] -> (int8 [out, in], f32 scale [out]): JAX _quantize_leaf
    on the transposed layout, bit for bit."""
    w = w.float()
    scale = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_int4(w: torch.Tensor, group_size: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] -> (int8 values in [-7, 7] [out, in], f32 scale [G, out]):
    JAX _quantize_leaf4 on the transposed layout, bit for bit (pack the
    values with lora.pack_int4)."""
    w = w.float()
    out, in_dim = w.shape
    g = int4_groups(in_dim, group_size)
    wg = w.view(out, g, in_dim // g)
    scale = (wg.abs().amax(dim=2) / 7.0).clamp_min(1e-8)        # [out, G]
    q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7)
    return q.view(out, in_dim).to(torch.int8), scale.t().contiguous()


def projections(llm: nn.Module) -> Iterator[LoRALinear]:
    """The projections JAX quantize_llm_params quantizes: every layer's
    attention and dense-MLP projections, then the lm_head (when untied).
    An MoE layer's router and experts are not among them: they stay in
    the compute dtype, as in the JAX package."""
    for layer in llm.layers:
        yield from layer.attn.values()
        if not layer.moe:
            yield from layer.mlp.values()
    if llm.lm_head is not None:
        yield llm.lm_head


def _warn_moe(llm: nn.Module) -> None:
    if llm.cfg.num_experts > 0:
        logger.warning(
            "MoE experts/router are NOT quantized (only the dense "
            "attention projections are) -- expect little memory savings")


@torch.no_grad()
def quantize_projection_(proj: LoRALinear, scheme: str,
                         group_size: int = 128) -> None:
    """Quantize one dense projection in place from its weight."""
    if scheme == "int4":
        q, scale = quantize_int4(proj.weight, group_size)
        q = pack_int4(q)
    else:
        q, scale = quantize_int8(proj.weight)
    proj.set_quantized_(scheme, q, scale)


def quantize_llm_params(llm: nn.Module, bits: int = 8, group_size: int = 128,
                        act_int8: bool = False) -> nn.Module:
    """Quantize the LLM's projections in place (JAX quantize_llm_params:
    int8 per output channel, int4 group-wise, act_int8 for W8A8), one
    projection at a time: each dense weight is released as its quantized
    copy is made. Returns the LLM."""
    scheme = quant_scheme(bits, act_int8)
    _warn_moe(llm)
    for proj in projections(llm):
        if proj.quant is not None:
            raise ValueError(f"the LLM is quantized already ({proj.quant})")
        quantize_projection_(proj, scheme, group_size)
    llm.quant = llm_quant(scheme, group_size)
    return llm


def empty_quantized_(proj: LoRALinear, scheme: str,
                     group_size: int = 128) -> None:
    """Give a projection uninitialised quantized storage of `scheme`."""
    out, in_dim = proj.out_features, proj.in_features
    dev = proj._device
    if scheme == "int4":
        q = torch.empty(out, in_dim // 2, dtype=torch.uint8, device=dev)
        scale = torch.empty(int4_groups(in_dim, group_size), out,
                            dtype=torch.float32, device=dev)
    else:
        q = torch.empty(out, in_dim, dtype=torch.int8, device=dev)
        scale = torch.empty(out, dtype=torch.float32, device=dev)
    proj.set_quantized_(scheme, q, scale)


@torch.no_grad()
def init_quantized_(llm: nn.Module, generator: torch.Generator,
                    bits: int = 8, group_size: int = 128,
                    act_int8: bool = False) -> nn.Module:
    """Random weights drawn on the LLM's device straight into the
    quantized layout (JAX init_params_quantized's scheme; module
    docstring). A dense LLM's projections are switched to quantized
    storage one at a time; one built with LLM(..., quant=llm_quant(
    scheme, group_size)) is filled where it is. Norms are set to unit
    scale (0 under the unit offset; the q/k norms to 1, as JAX draws
    them), biases to 0, an MoE router and experts drawn dense as
    reset_parameters draws them. Returns the LLM."""
    scheme = quant_scheme(bits, act_int8)
    _warn_moe(llm)
    want = llm_quant(scheme, group_size)
    if llm.quant not in (None, want):
        raise ValueError(f"the LLM is quantized as {llm.quant}, not {want}")
    for proj in projections(llm):
        if proj.quant is None:
            empty_quantized_(proj, scheme, group_size)
        in_dim = proj.in_features
        if scheme == "int4":
            q = torch.randint(-7, 8, (proj.out_features, in_dim),
                              generator=generator, dtype=torch.int8,
                              device=proj.w_q.device)
            proj.w_q.copy_(pack_int4(q))
            proj.scale.fill_(in_dim ** -0.5 / 4.32)
        else:
            proj.w_q.copy_(torch.randint(
                -127, 128, proj.w_q.shape, generator=generator,
                dtype=torch.int8, device=proj.w_q.device))
            proj.scale.fill_(in_dim ** -0.5 / 73.3)
        if proj.bias is not None:
            proj.bias.zero_()
    llm.quant = llm_quant(scheme, group_size)
    emb = llm.embed.weight
    emb.copy_(torch.empty(emb.shape, dtype=torch.float32, device=emb.device)
              .normal_(0.0, 0.02, generator=generator))
    unit = 0.0 if llm.cfg.rms_norm_unit_offset else 1.0
    for name, p in llm.named_parameters():
        if name.endswith(("q_norm.weight", "k_norm.weight")):
            p.fill_(1.0)       # JAX draws the q/k norms as ones here
        elif name.endswith("norm.weight"):
            p.fill_(unit)
        elif ".mlp.router." in name or ".mlp.experts." in name:
            # unquantized; JAX's quantized init has no MoE leaves
            p.copy_(torch.empty(p.shape, dtype=torch.float32,
                                device=p.device)
                    .normal_(0.0, p.shape[1] ** -0.5, generator=generator))
    return llm


def quantized_bytes(llm: nn.Module) -> int:
    """Bytes of the LLM's base weights, quantized or not (its parameters
    and buffers, LoRA adapters left out): JAX quantized_bytes of the
    params tree. A placed LLM counts this rank's bytes: the local parts
    of its DTensors."""
    from torch.distributed.tensor import DTensor
    tensors = list(llm.named_parameters()) + list(llm.named_buffers())
    return sum(t.numel() * t.element_size() for t in (
        p.to_local() if isinstance(p, DTensor) else p
        for n, p in tensors if "lora_" not in n))
