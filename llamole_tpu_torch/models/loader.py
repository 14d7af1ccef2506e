"""Model assembly (counterpart of llamole_tpu/models/loader.py).

`build_graph_lm_from_configs` builds the GraphLM from config objects
alone: random weights drawn ON the target device from one seeded
torch.Generator, except for graph modules passed in already built and an
LLM whose HF checkpoint directory is given (loaded straight into its
parameters, never drawn first). The random-init retro predictor carries
the JAX loader's built-in template table and purchasable inventory.
`build_graph_lm` mirrors the JAX loader's argument-driven path:
tokenizer, resolve_llm_config (a config.json through
LLMConfig.from_hf_config), vocab = max(config, tokenizer); the LLM loads
from the directory's safetensors (gllm/convert.py; random init when it
holds none); the graph decoder, predictor (with its CostMLP) and encoder
load from their directories in the JAX package's layout, or fall back to
the documented random inits (GraphDiT 64 x 2, GraphCLIP 2 x 64, predictor
2 x 64 with 16 labels); a trained adapter directory (either package's
save_pretrained files, or its newest committed checkpoint-N) loads into
the trainable bundle. quantization_bit (4 or 8; quantization_scheme
'weight_only' or 'w8a8', which needs 8) quantizes the LLM's projections
in place once its weights are loaded or drawn (before the adapter is
made, so DoRA / PiSSA over it raise, as in the JAX loader), and
kv_cache_dtype
('compute' or 'int8') picks the KV cache, with the JAX loader's errors
for other values; num_experts / num_experts_per_tok (a from-scratch MoE
config) and moe_aux_loss_coef override the resolved config as in the JAX
loader. use_dora / pissa_init make the adapter DoRA / PiSSA
(GraphLM.init_trainable) unless a trained adapter is loaded (its file
says what it is), and shift_attn turns on S²-attn for training.
"""

import json
import os
from typing import Optional, Sequence, Tuple

import torch

from ..data.tokenizer import ByteTokenizer, load_tokenizer
from ..utils.constants import SPECIAL_TOKENS
from ..utils.logging import get_logger
from ..utils.safetensors import checkpoint_files

from .composite import GraphLM
from .gllm import LLM, LLMConfig
from .gllm.convert import load_hf_weights
from .gllm.model import check_supported
from .gllm.quantize import quantize_llm_params
from .graphclip import GraphCLIP, GraphCLIPConfig
from .graphdit import GraphDiT, GraphDiTConfig
from .graphdit.config import DataInfo, build_data_info_from_smiles
from .retro import CostMLP, GraphPredictor, GraphPredictorConfig

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

def offline_tokenizer():
    """The byte-level tokenizer with the 9 control tokens, left-padding:
    what load_tokenizer gives when no HF tokenizer files exist."""
    tok = ByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    return tok


def resolve_llm_config(model_args) -> LLMConfig:
    """The directory's config.json (LLMConfig.from_hf_config), else the
    family preset by model name, tested in the JAX loader's order; tiny
    (random init) when unnamed."""
    path = model_args.model_name_or_path or ""
    cfg_file = os.path.join(path, "config.json") if path else ""
    if cfg_file and os.path.exists(cfg_file):
        with open(cfg_file) as f:
            return LLMConfig.from_hf_config(json.load(f))
    name = path.lower()
    if "llama" in name:
        return LLMConfig.llama3_8b()
    if "qwen3" in name:
        return LLMConfig.qwen3_8b()
    if "qwen" in name:
        return LLMConfig.qwen2_7b()
    if "mistral" in name:
        return LLMConfig.mistral_7b()
    if "gemma-3" in name or "gemma3" in name:
        return LLMConfig.gemma3_12b()
    if "gemma" in name:
        return LLMConfig.gemma2_9b()
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
    graph_decoder: Optional[GraphDiT] = None,
    graph_encoder: Optional[GraphCLIP] = None,
    graph_predictor: Optional[GraphPredictor] = None,
    cost_mlp: Optional[CostMLP] = None,
    llm_weights: Optional[str] = None,
    llm: Optional[LLM] = None,
    quantize: Optional[Tuple[int, bool]] = None,
    use_dora: bool = False, pissa: bool = False,
) -> GraphLM:
    """Random-init GraphLM on `device` (weights drawn there, seeded).
    GraphCLIP and the predictor run in f32; their configs default to the
    JAX loader's random-init stand-ins (2 layers x 64). loss_weights:
    the (lm, design, retro) weights of the training loss; special_tokens:
    the control tokens whose ids the model looks up. graph_decoder /
    graph_encoder / graph_predictor: modules already built (trained
    weights, on `device`), used as they are in place of dit_cfg /
    data_info / clip_cfg / predictor_cfg and their random draws;
    cost_mlp: the planner's optional value model; llm_weights: an HF
    checkpoint directory the LLM's base weights load from (in place of
    their random draw); llm: an LLM built and filled already (e.g. drawn
    straight into a quantized layout by quantize.init_quantized_), used
    in place of llm_cfg's build, its vocabulary covering the
    tokenizer's; quantize: (bits, act_int8) quantizes the LLM's
    projections in place before the adapter is made; use_dora / pissa:
    the adapter's kind (GraphLM.init_trainable)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if llm is not None:
        if llm.cfg.vocab_size < tokenizer.vocab_size:
            raise ValueError(f"the LLM's vocabulary ({llm.cfg.vocab_size}) "
                             f"is smaller than the tokenizer's "
                             f"({tokenizer.vocab_size})")
    else:
        llm_cfg.vocab_size = max(llm_cfg.vocab_size, tokenizer.vocab_size)
        llm = LLM(llm_cfg, dtype=llm_dtype, device=device)
        if llm_weights is None:
            llm.reset_parameters(gen)
        else:
            load_hf_weights(llm_weights, llm)
            logger.info("Loaded LLM weights from %s", llm_weights)
    if quantize is not None:
        quantize_llm_params(llm, bits=quantize[0], act_int8=quantize[1])
        logger.info("LLM projections quantized to int%d (%s)", quantize[0],
                    "w8a8" if quantize[1] else "weight_only")
    if graph_decoder is None:
        graph_decoder = GraphDiT(dit_cfg, data_info, dtype=graph_dtype,
                                 device=device)
        graph_decoder.denoiser.reset_parameters(gen)
    if graph_encoder is None:
        graph_encoder = GraphCLIP(
            clip_cfg or GraphCLIPConfig(num_layer=2, hidden_size=64),
            device=device)
        graph_encoder.reset_parameters(gen)
    if graph_predictor is None:
        p = predictor_cfg or GraphPredictorConfig(num_layer=2,
                                                  hidden_size=64, out_dim=16)
        graph_predictor = make_fallback_predictor(
            p.num_layer, p.hidden_size, p.out_dim, p.text_input_size,
            device=device)
        graph_predictor.reset_parameters(gen)
    model = GraphLM(
        llm, graph_decoder, graph_predictor, graph_encoder, tokenizer,
        {t: tokenizer.token_to_id(t) for t in special_tokens},
        num_body_tokens=num_body_tokens, lora_rank=lora_rank,
        lora_alpha=lora_alpha, finetuning_type=finetuning_type,
        use_rslora=use_rslora, cost_mlp=cost_mlp,
        loss_weight_lm=loss_weights[0],
        loss_weight_design=loss_weights[1], loss_weight_retro=loss_weights[2],
        use_dora=use_dora, pissa=pissa)
    model.init_trainable(gen)
    return model.eval()


def _has_weights(path: Optional[str], weight_file: str) -> bool:
    return bool(path) and os.path.exists(os.path.join(path, weight_file))


def _llm_weights_dir(path: str) -> Optional[str]:
    """`path` when it is a directory holding safetensors, else None (the
    LLM is random-initialised, as the JAX loader does)."""
    if not path or not os.path.isdir(path):
        return None
    try:
        checkpoint_files(path)
    except FileNotFoundError:
        logger.warning("No safetensors under %s; random init", path)
        return None
    return path


def resolve_adapter_dir(adapter_dir: str) -> str:
    """A trained-adapter directory, or, when the run died before its
    final save, the newest committed checkpoint-N inside it (the same
    save_pretrained layout)."""
    if os.path.isdir(os.path.join(adapter_dir, "connector")):
        return adapter_dir
    from ..train.trainer import find_last_checkpoint
    ckpt = find_last_checkpoint(adapter_dir)
    if ckpt is None or not os.path.isdir(os.path.join(ckpt, "connector")):
        raise FileNotFoundError(
            f"no trained weights under {adapter_dir}: neither a final "
            "save (connector/) nor a committed checkpoint-N")
    logger.info("adapter dir has no final save; using %s", ckpt)
    return ckpt


def load_graph_modules(model_args, device):
    """(graph_decoder, graph_encoder, graph_predictor, cost_mlp) from the
    paths that hold trained weights; None for each path that does not
    (the caller random-initialises those)."""
    decoder = encoder = predictor = cost_mlp = None
    gd_path = model_args.graph_decoder_path
    if _has_weights(gd_path, "model.msgpack"):
        decoder = GraphDiT.from_pretrained(gd_path, device=device)
        stride = getattr(model_args, "diffusion_sampling_steps", None)
        if stride:
            decoder.cfg.sampling_steps = stride
        logger.info("Loaded GraphDiT from %s", gd_path)
    else:
        logger.warning("graph_decoder_path missing (%s); tiny random init",
                       gd_path)
    ge_path = model_args.graph_encoder_path
    if _has_weights(ge_path, "model.msgpack"):
        encoder = GraphCLIP.from_pretrained(ge_path, device=device)
        logger.info("Loaded GraphCLIP from %s", ge_path)
    gp_path = model_args.graph_predictor_path
    if _has_weights(gp_path, "model.msgpack"):
        predictor = GraphPredictor.from_pretrained(gp_path, device=device)
        logger.info("Loaded the retro predictor from %s", gp_path)
    if _has_weights(gp_path, "cost_model.msgpack"):
        try:
            cost_mlp = CostMLP.from_pretrained(gp_path, device=device)
            logger.info("Loaded CostMLP value model from %s", gp_path)
        except ValueError as e:
            # a foreign-feature sidecar must not take the build down: the
            # planner runs without the molecule cost term
            logger.warning("Ignoring cost model at %s: %s", gp_path, e)
    return decoder, encoder, predictor, cost_mlp


def llm_quantization(model_args):
    """(bits, act_int8) from quantization_bit / quantization_scheme, or
    None; the JAX load_llm's argument checks and errors, kv_cache_dtype's
    first."""
    kv_dtype = getattr(model_args, "kv_cache_dtype", "compute") or "compute"
    if kv_dtype not in ("compute", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'compute' or 'int8', "
                         f"got {kv_dtype!r}")
    qbit = getattr(model_args, "quantization_bit", None)
    scheme = getattr(model_args, "quantization_scheme", "weight_only")
    if scheme not in ("weight_only", "w8a8"):
        raise ValueError(f"quantization_scheme={scheme!r} unsupported "
                         "(weight_only or w8a8)")
    if qbit in (4, 8):
        if qbit == 4 and scheme == "w8a8":
            raise ValueError("act_int8 (W8A8) requires bits=8")
        return qbit, scheme == "w8a8"
    if scheme == "w8a8":
        raise ValueError("quantization_scheme=w8a8 requires "
                         "quantization_bit=8")
    if qbit is not None:
        raise ValueError(
            f"quantization_bit={qbit} unsupported (4 or 8; the reference's "
            "bnb 2/3-bit and gptq/awq loaders are GPU-library paths, "
            "model_utils/quantization.py:102-205)")
    return None


def build_graph_lm(model_args, data_args, finetuning_args, *, device,
                   seed: int = 0, generate_mode: bool = False,
                   load_adapter: bool = False):
    """Argument-driven build (config/ dataclasses).
    Returns (model, tokenizer)."""
    device = torch.device(device)
    quant = llm_quantization(model_args)
    tokenizer = load_tokenizer(model_args, generate_mode=generate_mode)
    llm_cfg = resolve_llm_config(model_args)
    llm_cfg.shift_attn = bool(getattr(model_args, "shift_attn", False))
    llm_cfg.kv_cache_dtype = getattr(model_args, "kv_cache_dtype",
                                     "compute") or "compute"
    if getattr(model_args, "num_experts", 0) and llm_cfg.num_experts == 0:
        # a from-scratch MoE config (checkpoints carry their own value)
        llm_cfg.num_experts = int(model_args.num_experts)
        llm_cfg.num_experts_per_tok = int(model_args.num_experts_per_tok)
    if getattr(model_args, "moe_aux_loss_coef", None) is not None:
        llm_cfg.moe_aux_loss_coef = float(model_args.moe_aux_loss_coef)
    check_supported(llm_cfg)

    weights = _llm_weights_dir(model_args.model_name_or_path or "")
    adapter_dir = None
    if load_adapter and model_args.adapter_name_or_path:
        adapter_dir = model_args.adapter_name_or_path
        if isinstance(adapter_dir, (list, tuple)):
            adapter_dir = adapter_dir[0]
        adapter_dir = resolve_adapter_dir(adapter_dir)
    decoder, encoder, predictor, cost_mlp = load_graph_modules(model_args,
                                                               device)
    info = build_data_info_from_smiles(_FALLBACK_SMILES, max_n_nodes=16)
    dit_cfg = GraphDiTConfig(
        hidden_size=64, depth=2, num_heads=4, diffusion_steps=20,
        text_dim=768,
        sampling_steps=getattr(model_args, "diffusion_sampling_steps", None))

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
        special_tokens=model_args.special_token_list() or SPECIAL_TOKENS,
        graph_decoder=decoder, graph_encoder=encoder,
        graph_predictor=predictor, cost_mlp=cost_mlp, llm_weights=weights,
        quantize=quant,
        # a trained adapter's file says whether it is DoRA (JAX skips
        # init_trainable when it loads one)
        use_dora=adapter_dir is None and bool(getattr(
            finetuning_args, "use_dora", False)),
        pissa=adapter_dir is None and bool(getattr(
            finetuning_args, "pissa_init", False)))
    if adapter_dir is not None:
        model.load_trainable(adapter_dir)
        logger.info("Loaded adapter + connectors from %s", adapter_dir)
    return model, tokenizer
