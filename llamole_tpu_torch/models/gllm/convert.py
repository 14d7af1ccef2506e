"""HF safetensors checkpoints <-> the port's LLM (counterpart of
llamole_tpu/models/gllm/convert.py), for every family the port runs:
llama3, qwen2 (q/k/v biases), mistral, qwen3 (q_norm / k_norm), gemma-1/2/3
(gemma-2/3's four block norms: post_attention_layernorm is the norm on the
attention output there, pre_feedforward_layernorm the pre-MLP norm,
post_feedforward_layernorm the norm on the MLP output) and Mixtral
(block_sparse_moe.gate and experts.N.w1 / w3 / w2 = gate / up / down).

The port's projections keep torch's [out, in] layout, so HF tensors copy
straight into the parameters, on their device, one tensor at a time
(utils/safetensors.py reads through mmap); an expert's [out, in] tensor
is transposed into its row of the [E, in, out] leaf. When the tokenizer
has grown the vocabulary, the extra embedding and head rows are the JAX
package's noisy mean: the f32 mean of the checkpoint's rows plus
N(0, 0.02) noise from np.random.default_rng(0) (embedding) and
default_rng(1) (head), so both packages pad with the same rows.

`export_hf_weights` is the inverse: safetensors shards split as the JAX
package splits them, the index JSON, and config.json (`to_hf_config`,
the JAX package's: architectures and model_type by family).

A missing tensor, or one the LLM has no place for, raises.
"""

import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...utils.safetensors import INDEX_FILE, SINGLE_FILE, iter_safetensors
from ...utils.safetensors import save_file
from .config import LLMConfig
from .model import LLM

# HF name inside a layer -> the port's parameter name inside the layer,
# in the order the JAX package's hf_state_dict writes them
_PROJ = (("self_attn.q_proj", "attn.q"), ("self_attn.k_proj", "attn.k"),
         ("self_attn.v_proj", "attn.v"), ("self_attn.o_proj", "attn.o"),
         ("mlp.gate_proj", "mlp.gate"), ("mlp.up_proj", "mlp.up"),
         ("mlp.down_proj", "mlp.down"))
# Mixtral's expert tensors: w1 = gate, w3 = up, w2 = down (JAX's order)
_EXPERTS = (("w1", "gate"), ("w3", "up"), ("w2", "down"))
EMBED, HEAD = "model.embed_tokens.weight", "lm_head.weight"
# a parameter name, or (an experts leaf, the expert's row of it)
Target = Union[str, Tuple[str, int]]


def hf_names(llm: LLM) -> Dict[str, Target]:
    """HF tensor name -> the LLM's parameter name (an expert's tensor ->
    (the [E, in, out] leaf, its expert)), in hf_state_dict's order
    (embedding, final norm, head, then each layer: its norms, q/k norms,
    router and experts, projections). A quantized LLM raises
    (ValueError): HF checkpoints hold dense weights, which load into a
    dense LLM that quantize.quantize_llm_params then quantizes."""
    if llm.quant is not None:
        raise ValueError(f"the LLM is quantized ({llm.quant}): HF "
                         "checkpoints are read into and written from a "
                         "dense LLM only")
    cfg = llm.cfg
    names: Dict[str, Target] = {EMBED: "embed.weight",
                                "model.norm.weight": "final_norm.weight"}
    if llm.lm_head is not None:
        names[HEAD] = "lm_head.weight"
    for i, layer in enumerate(llm.layers):
        pre, ours = f"model.layers.{i}.", f"layers.{i}."
        names[pre + "input_layernorm.weight"] = ours + "input_norm.weight"
        if cfg.sandwich_norms:
            names[pre + "post_attention_layernorm.weight"] = (
                ours + "post_attn_norm.weight")
            names[pre + "pre_feedforward_layernorm.weight"] = (
                ours + "post_norm.weight")
            names[pre + "post_feedforward_layernorm.weight"] = (
                ours + "post_mlp_norm.weight")
        else:
            names[pre + "post_attention_layernorm.weight"] = (
                ours + "post_norm.weight")
        if cfg.qk_norm:
            names[pre + "self_attn.q_norm.weight"] = ours + "q_norm.weight"
            names[pre + "self_attn.k_norm.weight"] = ours + "k_norm.weight"
        if layer.moe:
            moe = pre + "block_sparse_moe."
            names[moe + "gate.weight"] = ours + "mlp.router.weight"
            for w, leaf in _EXPERTS:
                for e in range(cfg.num_experts):
                    names[f"{moe}experts.{e}.{w}.weight"] = (
                        f"{ours}mlp.experts.{leaf}", e)
        for hf, port in _PROJ:
            group, proj = port.split(".")
            if group == "mlp" and layer.moe:
                continue
            names[f"{pre}{hf}.weight"] = f"{ours}{port}.weight"
            if getattr(layer, group)[proj].bias is not None:
                names[f"{pre}{hf}.bias"] = f"{ours}{port}.bias"
    return names


def _target(params, target: Target) -> torch.Tensor:
    """The tensor an HF name fills: a parameter, or an expert's [in, out]
    row viewed as HF's [out, in]."""
    if isinstance(target, tuple):
        return params[target[0]][target[1]].T
    return params[target]


def _noisy_rows(mean: torch.Tensor, seed: int, shape) -> torch.Tensor:
    """The JAX package's vocabulary padding: f32 mean + N(0, 0.02) noise
    drawn by np.random.default_rng(seed) in `shape`."""
    noise = np.random.default_rng(seed).normal(0, 0.02, shape)
    return mean + torch.from_numpy(noise.astype(np.float32)).to(mean.device)


@torch.no_grad()
def load_hf_weights(path: str, llm: LLM) -> LLM:
    """Fill the LLM's base weights from an HF checkpoint directory (one
    model.safetensors or index-named shards), in place. An untied LLM
    whose checkpoint has no lm_head takes the embedding as its head;
    rows the tokenizer added past the checkpoint's vocabulary are padded
    as the JAX package pads them."""
    names = hf_names(llm)
    params = dict(llm.named_parameters())
    rows = None
    seen = set()
    for key, t in iter_safetensors(path):
        if key.endswith("rotary_emb.inv_freq"):
            continue   # a buffer older checkpoints carry; rope is computed
        if key not in names:
            raise ValueError(f"{path}: tensor {key} has no place in the LLM "
                             f"(tie_word_embeddings="
                             f"{llm.cfg.tie_word_embeddings})")
        p = _target(params, names[key])
        if key in (EMBED, HEAD):
            if t.shape[0] > p.shape[0] or t.shape[1:] != p.shape[1:]:
                raise ValueError(f"{path}: {key} {tuple(t.shape)} does not "
                                 f"fit {tuple(p.shape)}")
            rows = t.shape[0] if rows is None else rows
            if t.shape[0] != rows:
                raise ValueError(f"{path}: embedding and head rows differ")
            p[:rows].copy_(t)
        else:
            if t.shape != p.shape:
                raise ValueError(f"{path}: {key} {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
        seen.add(key)
    head = llm.lm_head.weight if llm.lm_head is not None else None
    if head is not None and HEAD not in seen and EMBED in seen:
        head[:rows].copy_(llm.embed.weight[:rows])   # implicitly tied
        seen.add(HEAD)
    missing = [k for k in names if k not in seen]
    if missing:
        raise ValueError(f"{path}: the checkpoint lacks {len(missing)} "
                         f"tensors, e.g. {missing[:3]}")
    extra = llm.embed.weight.shape[0] - rows
    if extra:
        emb = llm.embed.weight
        mean = emb[:rows].float().mean(dim=0, keepdim=True)
        emb[rows:].copy_(_noisy_rows(mean, 0, (extra, emb.shape[1])))
        if head is not None:
            mean_h = head[:rows].float().mean(dim=0, keepdim=True)
            head[rows:].copy_(
                _noisy_rows(mean_h.T, 1, (head.shape[1], extra)).T)
    return llm


def hf_state_dict(llm: LLM) -> Dict[str, torch.Tensor]:
    """The LLM's base weights under HF names, in the JAX package's order;
    the tensors are the parameters themselves (on their device)."""
    params = dict(llm.named_parameters())
    return {hf: _target(params, ours).detach()
            for hf, ours in hf_names(llm).items()}


def to_hf_config(cfg: LLMConfig, llm: Optional[LLM] = None) -> dict:
    """config.json of an exported checkpoint, as the JAX package writes it
    (the inverse of LLMConfig.from_hf_config): architectures and
    model_type by family (Mixtral, gemma-3, gemma-2, qwen3, else llama;
    gemma-1 has no sandwich norms and goes out as llama, as in JAX), the
    MoE and gemma fields; vocab_size, tie_word_embeddings and torch_dtype
    follow the LLM's embedding when it is given."""
    moe = cfg.num_experts > 0
    vocab, tied, torch_dtype = (cfg.vocab_size, cfg.tie_word_embeddings,
                                "bfloat16")
    if llm is not None:
        emb = llm.embed.weight
        vocab = int(emb.shape[0])
        tied = llm.lm_head is None
        torch_dtype = {torch.float32: "float32",
                       torch.float16: "float16"}.get(emb.dtype, "bfloat16")
    gemma = cfg.sandwich_norms
    gemma3 = gemma and cfg.qk_norm     # sandwich norms + q/k norms
    qwen3 = cfg.qk_norm and not gemma
    arch = ("MixtralForCausalLM" if moe
            else "Gemma3ForCausalLM" if gemma3
            else "Gemma2ForCausalLM" if gemma
            else "Qwen3ForCausalLM" if qwen3
            else "LlamaForCausalLM")
    raw = {
        "architectures": [arch],
        "model_type": ("mixtral" if moe
                       else "gemma3_text" if gemma3
                       else "gemma2" if gemma
                       else "qwen3" if qwen3 else "llama"),
        "vocab_size": vocab,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim_,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": tied,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": "silu",
        "torch_dtype": torch_dtype,
    }
    if cfg.rope_scaling:
        raw["rope_scaling"] = {
            "rope_type": cfg.rope_scaling,
            "factor": cfg.rope_scaling_factor,
            "low_freq_factor": cfg.rope_low_freq_factor,
            "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings":
                cfg.rope_original_max_position,
        }
    if moe:
        raw["num_local_experts"] = cfg.num_experts
        raw["num_experts_per_tok"] = cfg.num_experts_per_tok
        raw["router_aux_loss_coef"] = cfg.moe_aux_loss_coef
    if gemma:
        raw["hidden_activation"] = "gelu_pytorch_tanh"
        raw["query_pre_attn_scalar"] = (cfg.query_scale
                                        or float(cfg.head_dim_))
        raw["sliding_window"] = cfg.sliding_window
        if gemma3:
            raw["sliding_window_pattern"] = cfg.sliding_window_pattern
            raw["rope_local_base_freq"] = cfg.rope_local_base_freq
        else:
            raw["attn_logit_softcapping"] = cfg.attn_logit_softcap
            raw["final_logit_softcapping"] = cfg.final_logit_softcap
    return raw


def shard_plan(state: Dict[str, torch.Tensor], shard_gb: float):
    """(the keys of each shard, the bytes of each shard): in state's
    order, a tensor starts a new shard when it would take a non-empty one
    past shard_gb GiB (the JAX package's rule)."""
    shard_bytes = int(shard_gb * 1024 ** 3)
    shards, sizes = [[]], [0]
    for key, t in state.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] and sizes[-1] + nbytes > shard_bytes:
            shards.append([])
            sizes.append(0)
        shards[-1].append(key)
        sizes[-1] += nbytes
    return shards, sizes


def export_hf_weights(llm: LLM, out_dir: str, shard_gb: float = 5.0) -> int:
    """Write an HF checkpoint directory: model.safetensors, or shards of at
    most shard_gb GiB (a tensor starts a new shard when it would overflow
    a non-empty one) with model.safetensors.index.json, and config.json.
    Returns the bytes of tensor data written."""
    state = hf_state_dict(llm)      # a quantized LLM raises here
    os.makedirs(out_dir, exist_ok=True)
    shards, sizes = shard_plan(state, shard_gb)
    if len(shards) == 1:
        save_file(state, os.path.join(out_dir, SINGLE_FILE))
    else:
        weight_map: Dict[str, str] = {}
        for i, keys in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file({k: state[k] for k in keys},
                      os.path.join(out_dir, fname))
            weight_map.update({k: fname for k in keys})
        with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
            json.dump({"metadata": {"total_size": int(sum(sizes))},
                       "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(to_hf_config(llm.cfg, llm), f, indent=2)
    return int(sum(sizes))
