"""Bridge from llamole_tpu parameter trees to llamole_tpu_torch state dicts.

Input: the JAX package's parameter trees as nested dicts/lists of numpy
arrays (e.g. `jax.tree.map(np.asarray, params)`). Output: flat state
dicts of CPU tensors for `Module.load_state_dict` (strict). The port's
module names follow the JAX tree keys, so the mapping is structural:

  {"w": [in, out], "b"?}    dense      -> weight [out, in] (transposed), bias
  {"scale", "bias"?}        norm       -> weight, bias
  {"a": [in, r], "b": [r, out]}  LoRA  -> lora_a [r, in], lora_b [out, r]
  other leaves (embedding tables, null embeddings) copy as they are

Stacked LLM layers ("layers_stacked", leading [L] axis) are unstacked.
Quantized, MoE and DoRA leaves are not ported yet and raise. Reading
checkpoint files (msgpack / safetensors) is a later step of the port.
"""

from typing import Any, Dict, List

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def _walk(tree: Any, prefix: str, out: StateDict) -> None:
    if isinstance(tree, dict):
        unported = {"w_q", "w_qa", "w_q4", "m", "router", "experts"} & set(tree)
        if unported:
            raise NotImplementedError(
                f"{prefix or 'tree'}: {sorted(unported)} leaves (quantized "
                "/ DoRA / MoE) are not ported yet (ROADMAP.md)")
        if "w" in tree:
            out[prefix + "weight"] = _tensor(tree["w"]).T.contiguous()
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
        elif "a" in tree:
            out[prefix + "lora_a"] = _tensor(tree["a"]).T.contiguous()
            out[prefix + "lora_b"] = _tensor(tree["b"]).T.contiguous()
        elif "scale" in tree:
            out[prefix + "weight"] = _tensor(tree["scale"])
            if "bias" in tree:
                out[prefix + "bias"] = _tensor(tree["bias"])
        else:
            for k, v in tree.items():
                _walk(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def _unstack(stacked: Any, n: int) -> List[Any]:
    """A tree with a leading [L] axis on every leaf -> L trees."""
    if isinstance(stacked, dict):
        per = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    a = np.asarray(stacked)
    return [a[i] for i in range(n)]


def _layers(tree: Dict) -> List[Any]:
    if "layers_stacked" in tree:
        first = tree["layers_stacked"]
        while isinstance(first, dict):
            first = next(iter(first.values()))
        return _unstack(tree["layers_stacked"], np.asarray(first).shape[0])
    return tree["layers"]


def state_dict_of(tree: Any, prefix: str = "") -> StateDict:
    """State of the module whose names follow `tree` (e.g. the GraphDiT
    denoiser from init_denoiser's params), keys prefixed by `prefix`."""
    out: StateDict = {}
    _walk(tree, prefix, out)
    return out


def llm_state_dict(params: Dict, lora: Dict = None) -> StateDict:
    """State of models.gllm.LLM (with LoRA leaves when `lora` is given)."""
    rest = {k: v for k, v in params.items()
            if k not in ("layers", "layers_stacked")}
    out = state_dict_of(rest)
    out.update(state_dict_of(_layers(params), "layers."))
    if lora:
        out.update(state_dict_of(_layers(lora), "layers."))
    return out


def graph_lm_state_dict(frozen: Dict, trainable: Dict,
                        cost_mlp: Dict = None) -> StateDict:
    """State of models.composite.GraphLM from the JAX (frozen, trainable)
    bundles: frozen["llm"] (or trainable["llm"] for full finetuning),
    frozen["graph_decoder"], frozen["graph_encoder"],
    frozen["graph_predictor"], trainable["connectors"] and, for LoRA,
    trainable["lora"]; plus the CostMLP params when the model holds one."""
    llm = trainable.get("llm", frozen.get("llm"))
    out = {f"llm.{k}": v
           for k, v in llm_state_dict(llm, trainable.get("lora")).items()}
    out.update(state_dict_of(frozen["graph_decoder"],
                             "graph_decoder.denoiser."))
    out.update(state_dict_of(frozen["graph_encoder"], "graph_encoder."))
    out.update(state_dict_of(frozen["graph_predictor"], "graph_predictor."))
    out.update(state_dict_of(trainable["connectors"], "connectors."))
    if cost_mlp is not None:
        out.update(cost_mlp_state_dict(cost_mlp, "cost_mlp."))
    return out


def cost_mlp_state_dict(params: Dict, prefix: str = "") -> StateDict:
    """State of models.retro.CostMLP from the JAX {"layers": [dense...]}."""
    return state_dict_of(params, prefix)
