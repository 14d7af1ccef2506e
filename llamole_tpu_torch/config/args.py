"""Argument dataclasses + YAML/dict/CLI parsing.

Mirrors the reference's five hparams groups and YAML key surface
(reference: src/hparams/{model,data,finetuning,generating}_args.py and
parser.py:137/322) so that the shipped config files
(config/train/*.yaml, config/generate/*.yaml) parse unchanged.

Unlike the reference (HfArgumentParser), this is a small first-party
parser: YAML file or dict in, validated dataclasses out. Unknown keys
are ignored with a warning — the reference carries dozens of
LLaMA-Factory knobs (PPO/DPO/badam/galore/...) that have no meaning on
TPU; accepted-but-unused keys keep old configs loadable.
"""

import dataclasses
import json
import sys
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class ModelArguments:
    """Which LLM + graph modules to load and how (reference model_args.py:29)."""

    model_name_or_path: str = ""
    new_special_tokens: Optional[str] = None  # comma-separated
    adapter_name_or_path: Optional[str] = None
    graph_decoder_path: Optional[str] = None
    graph_encoder_path: Optional[str] = None
    graph_predictor_path: Optional[str] = None
    graph_lm_connector_path: Optional[str] = None
    # trained first-party property oracle (models/oracle.py) — when set,
    # the eval summary scores generated molecules' property fidelity
    property_oracle_path: Optional[str] = None
    disable_graph_model_gradient: bool = True
    compute_dtype: str = "bfloat16"  # resolved from bf16/fp16 flags
    model_max_length: Optional[int] = None
    resize_vocab: bool = True
    flash_attn: str = "auto"  # accepted for config parity; kernels are ours
    rope_scaling: Optional[str] = None
    # LongLoRA S²-attn during training (model_args.py:136-139)
    shift_attn: bool = False
    # stacked-layer storage + lax.scan forward (compile-time at 8B scale)
    scan_layers: bool = False
    # int8/int4 weight-only projections for serving (quantization_bit
    # parity; 4 = group-128 scales, 8 = per-output-channel scales)
    quantization_bit: Optional[int] = None
    # "weight_only" (default) or "w8a8" (bit=8 only): also quantize
    # activations per-token so both matmul operands run native int8 on
    # the MXU — weights stream at raw HBM bandwidth (faster decode,
    # slightly lossier than weight-only)
    quantization_scheme: str = "weight_only"
    # decode KV cache storage: "compute" (model dtype) or "int8"
    # (quantize-on-write; halves cache HBM reads — serving knob)
    kv_cache_dtype: str = "compute"
    # from-scratch sparse-MoE LLM (gllm _moe_mlp): >0 replaces the dense
    # SwiGLU; checkpoints with num_local_experts in config.json set this
    # automatically via from_hf_config
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # router load-balancing loss weight override; None = the checkpoint's
    # router_aux_loss_coef (reference model_utils/moe.py:69-71 honors the
    # HF config and exposes the same ModelArguments override)
    moe_aux_loss_coef: Optional[float] = None
    # override GraphDiT reverse steps at sampling time (strided fast
    # sampling; None = the pretrained config's full schedule)
    diffusion_sampling_steps: Optional[int] = None
    # tokenizer fallback used when model_name_or_path has no tokenizer files
    tokenizer_path: Optional[str] = None
    # export (main.py export / merge_adapter; reference model_args.py
    # export_dir/export_size): destination dir and safetensors shard
    # size in GB for the merged HF-format checkpoint
    export_dir: Optional[str] = None
    export_size: int = 5

    def special_token_list(self) -> List[str]:
        if not self.new_special_tokens:
            return []
        if isinstance(self.new_special_tokens, (list, tuple)):
            return list(self.new_special_tokens)
        return [t.strip() for t in str(self.new_special_tokens).split(",") if t.strip()]


@dataclass
class DataArguments:
    """Dataset selection + preprocessing knobs (reference data_args.py:23)."""

    dataset: Optional[str] = None
    dataset_dir: str = "data"
    template: Optional[str] = None
    cutoff_len: int = 1024
    learned_query_size: int = 8
    overwrite_cache: bool = False
    preprocessing_num_workers: Optional[int] = None
    max_samples: Optional[int] = None
    val_size: float = 0.0
    train_on_prompt: bool = False
    tokenized_path: Optional[str] = None


@dataclass
class TrainingArguments:
    """Trainer loop knobs (subset of HF Seq2SeqTrainingArguments the
    reference configs actually exercise)."""

    output_dir: Optional[str] = None
    do_train: bool = False
    do_eval: bool = False
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    learning_rate: float = 5e-5
    num_train_epochs: float = 3.0
    max_steps: int = -1
    lr_scheduler_type: str = "cosine"
    warmup_ratio: float = 0.0
    warmup_steps: int = 0
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    logging_steps: int = 10
    save_steps: int = 500
    eval_steps: Optional[int] = None
    eval_strategy: str = "no"
    seed: int = 42
    bf16: bool = False
    fp16: bool = False
    pure_bf16: bool = False
    plot_loss: bool = False
    overwrite_output_dir: bool = False
    resume_from_checkpoint: Optional[str] = None
    report_to: str = "none"
    ddp_timeout: int = 1800  # accepted for parity; no torch DDP here
    # TPU-specific: logical mesh shape, e.g. "dp:2,tp:4" or "pp:2,dp:4".
    # Empty = single chip. A pp axis pipelines the LLM layer stack
    # (parallel/pipeline.py; requires scan_layers stacked storage).
    mesh: str = ""
    # GPipe microbatches per step when the mesh has a pp axis (bubble
    # fraction (S-1)/(M+S-1); batch must divide M)
    pipeline_microbatches: int = 1
    # ZeRO analog (reference: DeepSpeed plumbing, hparams/parser.py:188-221):
    # stage 1 shards optimizer moments + grad-accumulation buffers along dp.
    zero_stage: int = 0


@dataclass
class FinetuningArguments:
    """LoRA / freeze / full tuning options (reference finetuning_args.py:308)."""

    stage: str = "mmsft"
    finetuning_type: str = "lora"
    lora_target: str = "all"
    lora_rank: int = 8
    lora_alpha: Optional[int] = None  # default 2*rank
    lora_dropout: float = 0.0
    # adapter variants (reference adapter.py:235-261 peft kwargs)
    use_rslora: bool = False
    use_dora: bool = False
    pissa_init: bool = False
    pissa_iter: int = -1  # accepted for parity; SVD here is exact
    loss_weight_lm: float = 1.0
    loss_weight_design: float = 1.0
    loss_weight_retro: float = 1.0
    pure_bf16: bool = False
    # custom optimizer factory (reference trainer_utils.py:184-366)
    use_galore: bool = False
    galore_target: str = "all"          # accepted for parity; 2D leaves used
    galore_rank: int = 16
    galore_update_interval: int = 200
    galore_scale: float = 0.25
    galore_proj_type: str = "std"
    loraplus_lr_ratio: Optional[float] = None
    loraplus_lr_embedding: float = 1e-6  # accepted for parity
    use_badam: bool = False
    badam_mode: str = "layer"
    badam_switch_interval: int = 50
    badam_start_block: int = 0
    badam_n_blocks: int = 4

    def __post_init__(self):
        if self.lora_alpha is None:
            self.lora_alpha = 2 * self.lora_rank


@dataclass
class GeneratingArguments:
    """Decode-time knobs (reference generating_args.py:20)."""

    do_sample: bool = True
    temperature: float = 0.95
    top_p: float = 0.7
    top_k: int = 50
    max_length: int = 512
    max_new_tokens: int = 128
    repetition_penalty: float = 1.0
    # prompt-lookup speculative decoding: verify this many n-gram-drafted
    # tokens per decode step; distribution-exact (gllm/model.py
    # _speculative_loop). None = auto (on at K=2 for greedy decode,
    # guarded by an acceptance monitor; off for sampled), 0 = force off.
    # Requires repetition_penalty == 1.0.
    speculative_tokens: Optional[int] = None
    speculative_ngram: int = 2
    default_system: Optional[str] = None
    # serving: stream requests through the fixed-slot continuous decode
    # pool (serve.ContinuousDesignServer) instead of full-batch cycles
    continuous_batching: bool = False
    # continuous-server knobs (SERVING.md); serve_batch_size doubles as
    # the full-batch DesignServer batch size
    serve_batch_size: int = 8            # slots / design group / batch
    serve_chunk_steps: int = 8
    serve_cache_len: int = 1024
    serve_max_wait_s: float = 0.05
    # fixed instruction header whose KV rows prefill once (prefix cache)
    shared_prefix_text: Optional[str] = None
    # retrosynthesis search: expand the W best open nodes per iteration
    # through one batched LLM call (1 = reference-equivalent ordering)
    frontier_width: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


ALL_GROUPS = (
    ModelArguments,
    DataArguments,
    TrainingArguments,
    FinetuningArguments,
    GeneratingArguments,
)


def _read_args(args: Any) -> Dict[str, Any]:
    """Accept a dict, a path to YAML/JSON, or sys.argv[1] as YAML path."""
    if isinstance(args, dict):
        return dict(args)
    if isinstance(args, str):
        path = args
    elif args is None and len(sys.argv) > 1 and sys.argv[1].endswith((".yaml", ".yml", ".json")):
        path = sys.argv[1]
    else:
        raise ValueError("Pass a dict of args or a path to a YAML/JSON config file.")
    from ..utils.flat_yaml import load_flat_yaml

    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        raw = json.loads(text)
    else:
        try:
            raw = load_flat_yaml(text) or None
        except ValueError as e:
            raise ValueError(f"config file {path!r} is not valid YAML: "
                             f"{e}") from e
    if not isinstance(raw, dict):
        raise ValueError(f"config file {path!r} must contain a mapping, "
                         f"got {type(raw).__name__}")
    return raw


def _coerce(value: Any, ftype: Any) -> Any:
    """Light type coercion for YAML scalars (e.g. '1.0e-4' strings)."""
    if value is None:
        return None
    try:
        if ftype in (float, Optional[float]):
            return float(value)
        if ftype in (int, Optional[int]):
            return int(value)
        if ftype in (bool, Optional[bool]) and isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
    except (TypeError, ValueError):
        pass
    return value


def parse_args(args: Any = None) -> Tuple[
    ModelArguments, DataArguments, TrainingArguments, FinetuningArguments, GeneratingArguments
]:
    raw = _read_args(args)
    known = set()
    parsed = []
    for group in ALL_GROUPS:
        names = {f.name: f for f in fields(group)}
        known.update(names)
        kwargs = {
            k: _coerce(v, names[k].type) for k, v in raw.items() if k in names
        }
        parsed.append(group(**kwargs))
    unknown = sorted(set(raw) - known)
    if unknown:
        logger.warning("Ignoring unknown config keys: %s", ", ".join(unknown))
    return tuple(parsed)


def _resolve_dtype(model_args: ModelArguments, training_args: TrainingArguments) -> None:
    # parity: parser.py:297-300 — bf16 flag drives compute dtype
    if training_args.bf16 or training_args.pure_bf16:
        model_args.compute_dtype = "bfloat16"
    elif training_args.fp16:
        model_args.compute_dtype = "float16"


def get_train_args(args: Any = None):
    model_args, data_args, training_args, finetuning_args, generating_args = parse_args(args)
    if training_args.do_train and not training_args.output_dir:
        raise ValueError("`output_dir` is required when do_train is true.")
    if training_args.do_train and data_args.dataset is None:
        raise ValueError("`dataset` is required when do_train is true.")
    if finetuning_args.finetuning_type not in ("lora", "freeze", "full"):
        raise ValueError(f"Unknown finetuning_type: {finetuning_args.finetuning_type}")
    _resolve_dtype(model_args, training_args)
    finetuning_args.pure_bf16 = finetuning_args.pure_bf16 or training_args.pure_bf16
    return model_args, data_args, training_args, finetuning_args, generating_args


def get_infer_args(args: Any = None):
    model_args, data_args, training_args, finetuning_args, generating_args = parse_args(args)
    _resolve_dtype(model_args, training_args)
    return model_args, data_args, training_args, finetuning_args, generating_args
