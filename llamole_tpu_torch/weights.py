"""Bridge from llamole_tpu parameter trees to llamole_tpu_torch state dicts.

Input: the JAX package's parameter trees as nested dicts/lists of numpy
arrays (e.g. `jax.tree.map(np.asarray, params)`). Output: flat state
dicts of CPU tensors for `Module.load_state_dict` (strict). The port's
module names follow the JAX tree keys, so the mapping is structural:

  {"w": [in, out], "b"?}    dense      -> weight [out, in] (transposed), bias
  {"w_q" | "w_qa": [in, out] int8, "scale": [out], "b"?}
                            int8 / W8A8 -> w_q [out, in], scale, bias
  {"w_q4": [in, out] int4, "scale": [G, out], "b"?}
                            int4       -> w_q [out, in / 2] uint8 (packed
                                          as gllm/lora.py pack_int4), scale
  {"scale", "bias"?}        norm       -> weight, bias
  {"a": [in, r], "b": [r, out], "m"?: [out]}
                            LoRA (DoRA) -> lora_a [r, in], lora_b [out, r],
                                          lora_m [out]
  {"router": {"w": [H, E]}, "experts": {"gate", "up", "down"}}
                            MoE        -> router.weight [E, H], experts.*
                                          [E, in, out] as they are
  other leaves (embedding tables, null embeddings) copy as they are

Stacked LLM layers ("layers_stacked", leading [L] axis, as
init_params_quantized returns them) are unstacked. A quantized tree loads
into a module built quantized the same way (`llm_quant_of` gives an LLM's
quant=(scheme, group_size)). A DoRA adapter's magnitude m [out] maps to
lora_m [out] as it is.

`jax_tree_of` is the inverse: a port module -> the JAX-layout tree
(dense weights back to w [in, out], norms to scale / bias, ModuleLists to
lists, the LLM to {"embed", "layers", "final_norm", "lm_head"?}; a
quantized module raises, as the JAX package never saves one), so
`save_module` / `load_module` read and write the JAX package's
model.msgpack files (utils/serialization.py). `trainable_tree` gives a
GraphLM's trainable bundle (or any {name: tensor} keyed like it, e.g. the
optimizer's moments) as the tree JAX's GraphLM.init_trainable builds:
{"connectors", "lora"} or {"connectors", "llm"}.
"""

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn

from .models.gllm.lora import LoRALinear, pack_int4
from .models.gllm.model import LLM, RMSNorm
from .ops.nn import Int8Dense, LayerNorm
from .utils.serialization import load_pytree, save_pytree

StateDict = Dict[str, torch.Tensor]
_QUANTIZED = ("w_q", "w_qa", "w_q4")


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def _walk(tree: Any, prefix: str, out: StateDict) -> None:
    if isinstance(tree, dict):
        quant = [k for k in _QUANTIZED if k in tree]
        if "w" in tree:
            if "m" in tree:
                raise ValueError(
                    f"{prefix or 'tree'}: a DoRA magnitude 'm' beside a dense "
                    "weight; DoRA's m belongs to an adapter leaf {a, b, m}")
            out[prefix + "weight"] = _tensor(tree["w"]).T.contiguous()
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
        elif quant:
            out[prefix + "w_q"] = _quantized_values(quant[0], tree[quant[0]])
            out[prefix + "scale"] = _tensor(tree["scale"])
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
        elif "a" in tree:
            out[prefix + "lora_a"] = _tensor(tree["a"]).T.contiguous()
            out[prefix + "lora_b"] = _tensor(tree["b"]).T.contiguous()
            if "m" in tree:
                out[prefix + "lora_m"] = _tensor(tree["m"])
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


def _quantized_values(key: str, a) -> torch.Tensor:
    """A JAX quantized leaf's [in, out] values -> the port's [out, in]
    int8, or [out, in / 2] packed uint8 for int4 (an ml_dtypes int4
    array, converted through int8)."""
    a = np.asarray(a)
    if key == "w_q4":
        return pack_int4(torch.from_numpy(a.astype(np.int8)).T)
    return torch.from_numpy(np.array(a)).T.contiguous()


def _projection_leaves(tree: Dict):
    """The projection leaves of a JAX LLM tree (layers and the head; an
    MoE layer's router and experts are never quantized)."""
    layers = tree.get("layers_stacked", tree.get("layers"))
    for layer in (layers if isinstance(layers, list) else [layers]):
        yield from layer["attn"].values()
        if "experts" not in layer["mlp"]:
            yield from layer["mlp"].values()
    if "lm_head" in tree:
        yield tree["lm_head"]


def llm_quant_of(params: Dict):
    """The LLM(quant=...) a JAX LLM tree loads into: None for a dense
    tree, else (scheme, group_size) from its leaves ('int8' for w_q,
    'w8a8' for w_qa, 'int4' for w_q4 with its group size read from the
    scale groups; 0 for the int8 schemes and when every int4 leaf has one
    group)."""
    leaves = list(_projection_leaves(params))
    keys = {k for leaf in leaves for k in _QUANTIZED if k in leaf}
    if not keys:
        return None
    if len(keys) > 1:
        raise ValueError(f"a tree with mixed quantized leaves {sorted(keys)}")
    key = keys.pop()
    scheme = {"w_q": "int8", "w_qa": "w8a8", "w_q4": "int4"}[key]
    if scheme == "int4":
        for leaf in leaves:
            groups = np.shape(leaf["scale"])[-2]    # [(L,) G, out]
            if groups > 1:
                return scheme, np.shape(leaf[key])[-2] // groups
    return scheme, 0


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


def trainable_state_dict(trainable: Dict) -> StateDict:
    """The JAX trainable bundle (or a tree shaped like it, e.g. its
    gradients) under GraphLM.trainable_parameters() names: connectors.*,
    plus llm.*lora_a / lora_b for LoRA or every llm.* weight for full
    finetuning."""
    out = state_dict_of(trainable["connectors"], "connectors.")
    if "lora" in trainable:
        out.update({f"llm.{k}": v for k, v in state_dict_of(
            _layers(trainable["lora"]), "layers.").items()})
    if "llm" in trainable:
        out.update({f"llm.{k}": v
                    for k, v in llm_state_dict(trainable["llm"]).items()})
    return out


def cost_mlp_state_dict(params: Dict, prefix: str = "") -> StateDict:
    """State of models.retro.CostMLP from the JAX {"layers": [dense...]}."""
    return state_dict_of(params, prefix)


def _llm_path(name: str) -> Tuple[List[str], bool]:
    """An LLM (or connector) parameter name -> (its key path in the JAX
    tree, whether the JAX leaf is the transpose): projections, the MoE
    router and the head -> w [in, out], biases -> b, RMSNorm weights ->
    scale, the embedding -> weight, LoRA factors -> a [in, r] / b
    [r, out], DoRA's magnitude -> m [out], MoE experts -> their [E, in,
    out] leaves."""
    *owner, leaf = name.split(".")
    if owner and owner[-1] == "experts":     # [E, in, out] on both sides
        return owner + [leaf], False
    if leaf in ("lora_a", "lora_b"):
        return owner + [leaf[-1]], True
    if leaf == "lora_m":
        return owner + ["m"], False
    if leaf == "bias":
        return owner + ["b"], False
    if leaf == "w_q":          # a quantized base: w_q / w_qa / w_q4 in JAX
        return owner + ["w_q"], True
    if leaf == "scale":        # its scales, [out] or [groups, out] on both
        return owner + ["scale"], False
    if owner[-1] == "embed":
        return owner + ["weight"], False
    if owner[-1].endswith("norm"):
        return owner + ["scale"], False
    return owner + ["w"], True


def nest(items: Iterable[Tuple[List[str], Any]]) -> Dict:
    """(key path, leaf) pairs -> nested dicts, a dict whose keys are
    0..n-1 becoming a list."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _listify(root)


def _listify(node):
    """Dict keys sorted (as a JAX tree map leaves them); 0..n-1 keys -> a
    list."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in sorted(node.items())}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _leaf(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    t = t.detach()
    return t.T if transposed and t.dim() == 2 else t


def llm_tree(llm: LLM) -> Dict:
    """The JAX params tree of the LLM's base weights (no adapter). A
    quantized LLM raises (ValueError)."""
    _refuse_quantized(llm)
    return nest((_llm_path(n)[0], _leaf(p, _llm_path(n)[1]))
                 for n, p in llm.named_parameters() if "lora_" not in n)


def bundle_path(name: str) -> Tuple[List[str], bool]:
    """A GraphLM trainable-bundle name -> (path in the JAX bundle,
    transposed)."""
    head, rest = name.split(".", 1)
    path, transposed = _llm_path(rest)
    if head == "connectors":
        return ["connectors"] + path, transposed
    return ["lora" if "lora_" in rest else "llm"] + path, transposed


def bundle_tree(values: Dict[str, torch.Tensor]) -> Dict:
    """Tensors keyed by GraphLM trainable-bundle names (the parameters,
    or the optimizer's moments) laid out as the JAX bundle tree."""
    return nest((bundle_path(n)[0], _leaf(t, bundle_path(n)[1]))
                 for n, t in values.items())


def trainable_tree(model) -> Dict:
    """The JAX trainable bundle of a GraphLM: {"connectors": {name: {"w",
    "b"}}, plus "lora" (the adapter tree) or "llm" (the full LLM tree)
    by finetuning type."""
    return bundle_tree(model.trainable_parameters())


def trainable_values(tree: Dict, names: Iterable[str]) -> StateDict:
    """The inverse of trainable_tree: a JAX bundle-shaped tree -> tensors
    keyed by `names` (the model's trainable names). Unknown or missing
    leaves raise."""
    unknown = set(tree) - {"connectors", "lora", "llm"}
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)} of a trainable "
                         "bundle")
    got = trainable_state_dict(tree)
    names = set(names)
    if set(got) != names:
        raise ValueError(
            "the trainable bundle does not match the model's: unknown "
            f"{sorted(set(got) - names)[:3]}, missing "
            f"{sorted(names - set(got))[:3]}")
    return got


def _refuse_quantized(module: nn.Module) -> None:
    quantized = getattr(module, "quant", None) is not None or isinstance(
        module, Int8Dense)
    if quantized:
        raise ValueError(
            f"{type(module).__name__} is quantized: it has no JAX-layout "
            "tree (the JAX package quantizes after it loads and saves "
            "dense trees only)")


def jax_tree_of(module: nn.Module) -> Any:
    """The JAX-layout tree of a port module whose names follow the JAX
    tree keys (the inverse of state_dict_of): nn.Linear and LoRALinear
    -> {"w": [in, out], "b"} (the base weight; trainable_tree has the
    adapter), LayerNorm -> {"scale", "bias"}, RMSNorm -> {"scale"}, the
    LLM -> llm_tree, ModuleList -> list, other modules -> dicts of their
    own parameters and children. Leaves are detached tensors on the
    module's device."""
    if isinstance(module, LLM):
        return llm_tree(module)
    _refuse_quantized(module)
    if isinstance(module, RMSNorm):
        return {"scale": module.weight.detach()}
    if isinstance(module, (nn.Linear, LoRALinear)):
        out = {"w": module.weight.detach().T}
        if module.bias is not None:
            out["b"] = module.bias.detach()
        return out
    if isinstance(module, LayerNorm):
        return {"scale": module.weight.detach(),
                "bias": module.bias.detach()}
    if isinstance(module, nn.ModuleList):
        return [jax_tree_of(m) for m in module]
    out = {name: p.detach()
           for name, p in module.named_parameters(recurse=False)}
    out.update({name: jax_tree_of(m)
                for name, m in module.named_children()})
    return out


def save_module(module: nn.Module, path: str) -> None:
    """module -> a msgpack file the JAX package's load_pytree reads."""
    save_pytree(jax_tree_of(module), path)


@torch.no_grad()
def load_module(module: nn.Module, path: str) -> nn.Module:
    """Fill `module` (strictly) from a JAX-layout msgpack file."""
    module.load_state_dict(state_dict_of(load_pytree(path)))
    return module
