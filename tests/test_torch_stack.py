"""The port's learned-weights stack end to end on the CPU
(`python -m llamole_tpu_torch.train.stack --tiny --device cpu`), its LLM
config path (LLMConfig.from_hf_config against the JAX package's), and the
loader reading what the stack wrote: the trained graph modules and the
mmsft bundle, and what the JAX package writes for the same stack (its
full-LLM adapter directory, its HF safetensors export)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm.config import LLMConfig as JaxLLMConfig
from llamole_tpu.utils.serialization import load_pytree as jax_load
from llamole_tpu_torch.config import get_infer_args
from llamole_tpu_torch.models.gllm.config import LLMConfig
from llamole_tpu_torch.models.gllm.model import check_supported
from llamole_tpu_torch.models.loader import (build_graph_lm,
                                             resolve_adapter_dir,
                                             resolve_llm_config)
from llamole_tpu_torch.train import stack
from llamole_tpu_torch.weights import jax_tree_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACK_BUDGET_S = 120

_BASE = {"vocab_size": 320, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2}
SUPPORTED = {
    "llama": {**_BASE, "model_type": "llama", "tie_word_embeddings": True,
              "rope_theta": 500000.0, "max_position_embeddings": 131072,
              "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                               "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192}},
    "qwen2": {**_BASE, "model_type": "qwen2", "rope_theta": 1e6,
              "rms_norm_eps": 1e-6},
    "mistral": {**_BASE, "model_type": "mistral", "rope_theta": 1e6,
                "max_position_embeddings": 32768},
}
# the families the port runs since the qwen3 / gemma / Mixtral slice
NEW_FAMILIES = {
    "gemma": {**_BASE, "model_type": "gemma", "hidden_act": "gelu",
              "head_dim": 16},
    "gemma2": {**_BASE, "model_type": "gemma2", "sliding_window": 4096,
               "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 16},
    "qwen3": {**_BASE, "model_type": "qwen3", "head_dim": 16},
    "mixtral": {**_BASE, "model_type": "mixtral", "num_local_experts": 8,
                "num_experts_per_tok": 2},
}


@pytest.mark.parametrize("family", list(SUPPORTED))
def test_from_hf_config_equals_jax(family, tmp_path):
    raw = SUPPORTED[family]
    want = dataclasses.asdict(JaxLLMConfig.from_hf_config(raw))
    assert dataclasses.asdict(LLMConfig.from_hf_config(raw)) == want
    check_supported(LLMConfig.from_hf_config(raw))
    (tmp_path / "config.json").write_text(json.dumps(raw))
    got = resolve_llm_config(SimpleNamespace(model_name_or_path=str(
        tmp_path)))
    assert dataclasses.asdict(got) == want


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_from_hf_config_of_unported_families_raises(family, tmp_path):
    """gemma-1/2, qwen3 and Mixtral configs resolve as in the JAX package
    and build, with S²-attn too (named when it raised)."""
    raw = NEW_FAMILIES[family]
    want = dataclasses.asdict(JaxLLMConfig.from_hf_config(raw))
    assert dataclasses.asdict(LLMConfig.from_hf_config(raw)) == want
    check_supported(LLMConfig.from_hf_config(raw))
    (tmp_path / "config.json").write_text(json.dumps(raw))
    got = resolve_llm_config(SimpleNamespace(model_name_or_path=str(
        tmp_path)))
    assert dataclasses.asdict(got) == want
    got.shift_attn = True
    check_supported(got)


@pytest.fixture(scope="module")
def tiny_stack(tmp_path_factory):
    """One run of the whole tiny stack, through its command line."""
    d = tmp_path_factory.mktemp("stack") / "stack"
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "llamole_tpu_torch.train.stack", "--tiny",
         "--device", "cpu", "--stack-dir", str(d)],
        capture_output=True, text=True, timeout=2 * STACK_BUDGET_S,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    wall = time.time() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return d, wall


def test_tiny_stack_end_to_end(tiny_stack):
    d, wall = tiny_stack
    assert wall < STACK_BUDGET_S
    with open(d / "OPERATING_POINT.json") as f:
        report = json.load(f)
    stages = report["stages"]
    assert list(stages) == stack.STAGES
    for name in ("graphdit", "predictor", "cost_mlp", "graphclip",
                 "oracle"):
        m = stages[name]
        assert np.isfinite(m["first_loss"]) and np.isfinite(m["final_loss"])
        assert "losses" not in m
    # every trained artifact in place, where the loaders look for it
    for rel in ("graphdit/model.msgpack", "graphdit/model_config.yaml",
                "graphdit/data.meta.json", "predictor/model.msgpack",
                "predictor/available.csv.gz",
                "predictor/label_to_template.csv.gz",
                "predictor/cost_model.msgpack", "graphclip/model.msgpack",
                "graphclip/text_tower.msgpack", "oracle/model.msgpack",
                "llm/config.json", "mmsft/llm.msgpack",
                "mmsft/connector/graph_to_lm.msgpack",
                "eval/molqa_results.json"):
        assert (d / rel).exists(), rel
    ev = stages["eval"]
    assert ev["planning_wall"] == "per_molecule"
    assert 0.0 <= ev["validity"] <= 1.0
    assert "retro_success" in ev and "molecules_per_min" in ev
    assert "property_accuracy" in ev and "property_mae" in ev
    assert stages["mmsft"]["train_loss"] == stages["mmsft"]["train_loss"]
    assert stages["llm_config"]["tie_word_embeddings"] is True


def _assert_equal(port, jax_leaf):
    """A port tensor equals a JAX leaf bit for bit (bf16 compared in f32,
    which holds it exactly)."""
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(jax_leaf, np.float32))
    assert str(port.dtype).split(".")[-1] == np.asarray(jax_leaf).dtype.name


def _stack_args(d, **extra):
    paths = stack.stack_paths(str(d))
    return get_infer_args(stack.eval_args(paths, stack.sizes(True)["eval"],
                                          0) | extra)


def test_the_loader_reads_the_stack(tiny_stack):
    """build_graph_lm on the stack's directories: every graph module and
    the mmsft bundle hold the saved weights; the JAX package reads the
    same graph-module files."""
    d, _ = tiny_stack
    model_args, data_args, _, ft_args, _ = _stack_args(d)
    model, tok = build_graph_lm(model_args, data_args, ft_args,
                                device="cpu", generate_mode=True,
                                load_adapter=True)
    assert model.llm.cfg.tie_word_embeddings
    assert model.llm.cfg.hidden_size == 64
    assert model.cost_mlp is not None
    for module, path in ((model.graph_decoder.denoiser,
                          "graphdit/model.msgpack"),
                         (model.graph_encoder, "graphclip/model.msgpack"),
                         (model.graph_predictor, "predictor/model.msgpack"),
                         (model.cost_mlp, "predictor/cost_model.msgpack")):
        flat_g = jax.tree_util.tree_leaves(jax_tree_of(module))
        flat_w = jax.tree_util.tree_leaves(jax_load(str(d / path)))
        assert len(flat_g) == len(flat_w), path
        for g, w in zip(flat_g, flat_w):
            _assert_equal(g, w)
    for module, path in ((model.llm, "mmsft/llm.msgpack"),
                         (model.connectors["graph_to_lm"],
                          "mmsft/connector/graph_to_lm.msgpack")):
        flat_g = jax.tree_util.tree_leaves(jax_tree_of(module))
        flat_w = jax.tree_util.tree_leaves(jax_load(str(d / path)))
        assert len(flat_g) == len(flat_w), path
        for g, w in zip(flat_g, flat_w):
            _assert_equal(g, w)
    assert model.graph_predictor.label_to_template
    assert model.graph_predictor.available


def test_a_config_only_model_directory_gets_the_byte_tokenizer(
        tmp_path, monkeypatch):
    """The stack's LLM directory holds only config.json: the tokenizer is
    the byte-level one, and no HF tokenizer is built from the directory
    (a transformers that builds one there, with another
    add_special_tokens signature, failed the card's run)."""
    import transformers

    from llamole_tpu_torch.config import ModelArguments
    from llamole_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer

    class NotATokenizer:
        """What such a transformers hands back: a tokenizer whose
        add_special_tokens takes no replace_additional_special_tokens."""
        pad_token_id, padding_side = 0, "right"

        def add_special_tokens(self, special_tokens_dict):
            raise AssertionError("an HF tokenizer was built from a "
                                 "directory with no tokenizer files")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: NotATokenizer())
    (tmp_path / "config.json").write_text(json.dumps(SUPPORTED["llama"]))
    tok = load_tokenizer(ModelArguments(model_name_or_path=str(tmp_path)),
                         generate_mode=True)
    assert isinstance(tok, ByteTokenizer) and tok.padding_side == "left"


def test_resolve_adapter_dir_checkpoint_fallback(tmp_path):
    """Eval rides the newest committed checkpoint-N when the run died
    before its final save."""
    final = tmp_path / "final"
    (final / "connector").mkdir(parents=True)
    assert resolve_adapter_dir(str(final)) == str(final)
    died = tmp_path / "died"
    for step, committed in ((250, True), (500, True), (750, False)):
        ck = died / f"checkpoint-{step}"
        (ck / "connector").mkdir(parents=True)
        if committed:
            (ck / "trainer_state.json").write_text("{}")
            (ck / "trainable.msgpack").write_bytes(b"x")
    assert resolve_adapter_dir(str(died)).endswith("checkpoint-500")
    with pytest.raises(FileNotFoundError):
        resolve_adapter_dir(str(tmp_path / "empty"))


def test_jax_adapters_and_safetensors_still_raise(tiny_stack, tmp_path):
    """(Named when both raised.) A directory with the JAX package's
    full-LLM adapter files and an LLM directory with the JAX package's
    safetensors export now load: the port's model holds exactly the
    weights the JAX package wrote. A DoRA magnitude beside a dense
    weight raises: never silently dropped."""
    from llamole_tpu.models.gllm.convert import export_hf_weights
    from llamole_tpu.utils.serialization import save_pytree as jax_save

    d, _ = tiny_stack
    llm = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.01).astype(
            np.asarray(a).dtype), jax_load(str(d / "mmsft" / "llm.msgpack")))
    conn = {n: jax_load(str(d / "mmsft" / "connector" / f"{n}.msgpack"))
            for n in ("graph_to_lm", "lm_to_graph_decoder",
                      "lm_to_graph_predictor")}
    jax_adapter = tmp_path / "jax_adapter"
    jax_save(llm, str(jax_adapter / "llm.msgpack"))
    for n, tree in conn.items():
        jax_save(tree, str(jax_adapter / "connector" / f"{n}.msgpack"))
    model_args, data_args, _, ft_args, _ = _stack_args(
        d, adapter_name_or_path=str(jax_adapter))
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu",
                              load_adapter=True)
    flat_g = jax.tree_util.tree_leaves(jax_tree_of(model.llm))
    flat_w = jax.tree_util.tree_leaves(llm)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        _assert_equal(g, w)

    raw = json.loads((d / "llm" / "config.json").read_text())
    llm_dir = tmp_path / "llm"
    export_hf_weights(jax.tree.map(jnp.asarray, llm),
                      JaxLLMConfig.from_hf_config(raw), str(llm_dir))
    model_args, data_args, _, ft_args, _ = _stack_args(
        d, model_name_or_path=str(llm_dir), adapter_name_or_path=None)
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    for g, w in zip(jax.tree_util.tree_leaves(jax_tree_of(model.llm)),
                    flat_w):
        _assert_equal(g, w)

    dora = tmp_path / "dora"
    (dora / "connector").mkdir(parents=True)
    for n in conn:
        shutil.copy(jax_adapter / "connector" / f"{n}.msgpack",
                    dora / "connector" / f"{n}.msgpack")
    llm["layers"][0]["attn"]["q"]["m"] = np.ones(4, np.float32)
    jax_save(llm, str(dora / "llm.msgpack"))
    model_args, data_args, _, ft_args, _ = _stack_args(
        d, adapter_name_or_path=str(dora))
    with pytest.raises(ValueError, match="DoRA"):
        build_graph_lm(model_args, data_args, ft_args, device="cpu",
                       load_adapter=True)
