"""Model assembly (counterpart of llamole_tpu/models/loader.py).

`build_graph_lm_from_configs` builds the GraphLM from config objects
alone (no YAML, no files): random weights drawn ON the target device from
one seeded torch.Generator. The retro predictor carries the JAX loader's
built-in template table and purchasable inventory (the trained template
library is a checkpoint file). `build_graph_lm` mirrors the JAX loader's
argument-driven path: tokenizer, resolve_llm_config, vocab = max(config,
tokenizer), and the documented random-init fallbacks (GraphDiT 64 x 2,
GraphCLIP 2 x 64, predictor 2 x 64 with 16 labels). Reading trained
weights from checkpoint files is not ported yet (ROADMAP.md); paths that
hold them raise.
"""

import os
from typing import Optional, Sequence

import torch

from ..data.tokenizer import ByteTokenizer, load_tokenizer
from ..utils.constants import SPECIAL_TOKENS
from ..utils.logging import get_logger

from .composite import GraphLM
from .gllm import LLM, LLMConfig
from .graphclip import GraphCLIP, GraphCLIPConfig
from .graphdit import GraphDiT, GraphDiTConfig
from .graphdit.config import DataInfo, build_data_info_from_smiles
from .retro import GraphPredictor, GraphPredictorConfig

logger = get_logger(__name__)

_FALLBACK_SMILES = [
    "CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
    "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "CC(=O)Oc1ccccc1C(=O)O",
    "c1cc[nH]c1", "CCCl", "CBr", "CF", "CCCCCC", "C1CCCCC1",
]

_FALLBACK_TEMPLATES = {
    # generic disconnections so random-init runs can propose reactions
    # (real deployments load the trained template library)
    0: "[C:1](=[O:2])-[O:3]-[C:4]>>[C:1](=[O:2])-[OH].[OH]-[C:4]",
    1: "[C:1](=[O:2])-[NH:3]>>[C:1](=[O:2])-[OH].[NH2:3]",
    2: "[c:1]-[O:2]-[CH3;D1:3]>>[c:1]-[OH:2].[CH3:3]-I",
    3: "[C:1]-[OH;D1:2]>>[C:1]=[O:2]",
    4: "[c:1]-[Br;D1:2]>>[c:1].[Br:2]",
    5: "[C:1]-[C:2]-[OH;D1:3]>>[C:1]=[C:2].[OH2:3]",
}

_NOT_PORTED = ("loading {} from {} is not ported to llamole_tpu_torch yet "
               "(ROADMAP.md: checkpoint files)")
_NOT_PORTED_FAMILY = ("the {} LLM family ({!r}) is not ported to "
                      "llamole_tpu_torch yet (ROADMAP.md: other model "
                      "families)")


def offline_tokenizer():
    """The byte-level tokenizer with the 9 control tokens, left-padding:
    what load_tokenizer gives when no HF tokenizer files exist."""
    tok = ByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    return tok


def resolve_llm_config(model_args) -> LLMConfig:
    """Family preset by model name, tested in the JAX loader's order;
    tiny (random init) when unnamed. The qwen3 and gemma families are
    not ported yet: their names raise rather than build another
    family's preset."""
    path = model_args.model_name_or_path or ""
    if path and os.path.exists(os.path.join(path, "config.json")):
        raise NotImplementedError(_NOT_PORTED.format("an LLM config", path))
    name = path.lower()
    if "llama" in name:
        return LLMConfig.llama3_8b()
    if "qwen3" in name:
        raise NotImplementedError(_NOT_PORTED_FAMILY.format("qwen3", path))
    if "qwen" in name:
        return LLMConfig.qwen2_7b()
    if "mistral" in name:
        return LLMConfig.mistral_7b()
    if "gemma" in name:     # gemma-3 and gemma-1/2 alike
        raise NotImplementedError(_NOT_PORTED_FAMILY.format("gemma", path))
    logger.warning("No local weights/config for %r -- using tiny config "
                   "(random init)", path)
    return LLMConfig.tiny()


def make_fallback_predictor(num_layer: int = 2, hidden_size: int = 64,
                            out_dim: int = 16, text_input_size: int = 768,
                            *, device=None) -> GraphPredictor:
    """Uninitialised f32 predictor wired with the built-in template table
    and purchasable set: the stand-in for the trained GNNPredictor."""
    cfg = GraphPredictorConfig(num_layer=num_layer, hidden_size=hidden_size,
                               out_dim=out_dim,
                               text_input_size=text_input_size)
    return GraphPredictor(cfg, label_to_template=dict(_FALLBACK_TEMPLATES),
                          available=list(_FALLBACK_SMILES), device=device)


def build_graph_lm_from_configs(
    llm_cfg: LLMConfig, dit_cfg: GraphDiTConfig, data_info: DataInfo,
    tokenizer, *, device, llm_dtype=torch.bfloat16,
    graph_dtype=torch.float32, seed: int = 0, finetuning_type: str = "lora",
    lora_rank: int = 8, lora_alpha: Optional[int] = None,
    use_rslora: bool = False, num_body_tokens: int = 8,
    clip_cfg: Optional[GraphCLIPConfig] = None,
    predictor_cfg: Optional[GraphPredictorConfig] = None,
    loss_weights=(1.0, 1.0, 1.0),
    special_tokens: Sequence[str] = SPECIAL_TOKENS,
) -> GraphLM:
    """Random-init GraphLM on `device` (weights drawn there, seeded).
    GraphCLIP and the predictor run in f32; their configs default to the
    JAX loader's random-init stand-ins (2 layers x 64). loss_weights:
    the (lm, design, retro) weights of the training loss; special_tokens:
    the control tokens whose ids the model looks up."""
    device = torch.device(device)
    llm_cfg.vocab_size = max(llm_cfg.vocab_size, tokenizer.vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    llm = LLM(llm_cfg, dtype=llm_dtype, device=device)
    llm.reset_parameters(gen)
    graph_decoder = GraphDiT(dit_cfg, data_info, dtype=graph_dtype,
                             device=device)
    graph_decoder.denoiser.reset_parameters(gen)
    graph_encoder = GraphCLIP(
        clip_cfg or GraphCLIPConfig(num_layer=2, hidden_size=64),
        device=device)
    graph_encoder.reset_parameters(gen)
    p = predictor_cfg or GraphPredictorConfig(num_layer=2, hidden_size=64,
                                              out_dim=16)
    graph_predictor = make_fallback_predictor(
        p.num_layer, p.hidden_size, p.out_dim, p.text_input_size,
        device=device)
    graph_predictor.reset_parameters(gen)
    model = GraphLM(
        llm, graph_decoder, graph_predictor, graph_encoder, tokenizer,
        {t: tokenizer.token_to_id(t) for t in special_tokens},
        num_body_tokens=num_body_tokens, lora_rank=lora_rank,
        lora_alpha=lora_alpha, finetuning_type=finetuning_type,
        use_rslora=use_rslora, loss_weight_lm=loss_weights[0],
        loss_weight_design=loss_weights[1], loss_weight_retro=loss_weights[2])
    model.init_trainable(gen)
    return model.eval()


def build_graph_lm(model_args, data_args, finetuning_args, *, device,
                   seed: int = 0, generate_mode: bool = False,
                   load_adapter: bool = False):
    """Argument-driven build (config/ dataclasses).
    Returns (model, tokenizer)."""
    if getattr(model_args, "quantization_bit", None) is not None:
        raise NotImplementedError("quantized LLM weights are not ported yet "
                                  "(ROADMAP.md)")
    if getattr(finetuning_args, "use_dora", False) or getattr(
            finetuning_args, "pissa_init", False):
        raise NotImplementedError("DoRA / PiSSA adapters are not ported yet "
                                  "(ROADMAP.md)")
    tokenizer = load_tokenizer(model_args, generate_mode=generate_mode)
    llm_cfg = resolve_llm_config(model_args)
    llm_cfg.shift_attn = bool(getattr(model_args, "shift_attn", False))
    llm_cfg.kv_cache_dtype = getattr(model_args, "kv_cache_dtype",
                                     "compute") or "compute"
    if getattr(model_args, "num_experts", 0):
        llm_cfg.num_experts = int(model_args.num_experts)

    gd_path = model_args.graph_decoder_path
    if gd_path and os.path.exists(os.path.join(gd_path, "model.msgpack")):
        raise NotImplementedError(_NOT_PORTED.format("GraphDiT", gd_path))
    logger.warning("graph_decoder_path missing (%s); tiny random init",
                   gd_path)
    info = build_data_info_from_smiles(_FALLBACK_SMILES, max_n_nodes=16)
    dit_cfg = GraphDiTConfig(
        hidden_size=64, depth=2, num_heads=4, diffusion_steps=20,
        text_dim=768,
        sampling_steps=getattr(model_args, "diffusion_sampling_steps", None))
    for what, path, weight_file in (
            ("GraphCLIP", model_args.graph_encoder_path, "model.msgpack"),
            ("the retro predictor", model_args.graph_predictor_path,
             "model.msgpack"),
            ("the CostMLP value model", model_args.graph_predictor_path,
             "cost_model.msgpack")):
        if path and os.path.exists(os.path.join(path, weight_file)):
            raise NotImplementedError(_NOT_PORTED.format(what, path))
    if load_adapter and model_args.adapter_name_or_path:
        raise NotImplementedError(_NOT_PORTED.format(
            "a trained adapter", model_args.adapter_name_or_path))

    model = build_graph_lm_from_configs(
        llm_cfg, dit_cfg, info, tokenizer, device=device,
        llm_dtype=(torch.bfloat16 if model_args.compute_dtype == "bfloat16"
                   else torch.float32),
        seed=seed, finetuning_type=finetuning_args.finetuning_type,
        lora_rank=finetuning_args.lora_rank,
        lora_alpha=finetuning_args.lora_alpha,
        use_rslora=getattr(finetuning_args, "use_rslora", False),
        num_body_tokens=data_args.learned_query_size,
        loss_weights=tuple(getattr(finetuning_args, f"loss_weight_{k}", 1.0)
                           for k in ("lm", "design", "retro")),
        special_tokens=model_args.special_token_list() or SPECIAL_TOKENS)
    return model, tokenizer
