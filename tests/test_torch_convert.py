"""Weight interchange between llamole_tpu_torch and llamole_tpu (CPU, f32
unless stated): the port's first-party safetensors against the
`safetensors` package and the JAX export, HF import (logits 1e-5, the
padded vocabulary rows) and export (transformers loads it: logits 2e-4 /
2e-3 as tests/test_hf_export.py), merge_lora against JAX's,
refconvert's trees against the JAX converters', every family's HF
directory both ways (qwen3, gemma-1/2/3, Mixtral), an MoE tree through the
bridge, and the refusals (another family's tensor, a missing tensor, DoRA
leaves). The
adapter directories, training checkpoints and merge_adapter are in
tests/test_torch_checkpoint.py."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import merge_lora as jax_merge_lora
from llamole_tpu.models.gllm.convert import export_hf_weights as jax_export
from llamole_tpu.models.gllm.convert import load_hf_weights as jax_import
from llamole_tpu.models.gllm.convert import to_hf_config as jax_hf_config
from llamole_tpu.models.gllm.lora import init_lora
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.utils.serialization import load_pytree as jax_load
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.convert import (export_hf_weights,
                                                   hf_state_dict,
                                                   load_hf_weights,
                                                   to_hf_config)
from llamole_tpu_torch.models.gllm.lora import merge_lora
from llamole_tpu_torch.utils import safetensors as st
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import llm_state_dict, llm_tree, state_dict_of

ATOL = 1e-5
IDS = np.random.default_rng(7).integers(0, 96, (2, 9)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_llm(seed=0, vocab=96, dtype=jnp.float32, **overrides):
    cfg = replace(JaxLLMConfig.tiny(vocab), **overrides)
    return cfg, init_params(jax.random.PRNGKey(seed), cfg, dtype)


def _port_llm(vocab=96, dtype=torch.float32, **overrides):
    return LLM(replace(LLMConfig.tiny(vocab), **overrides), dtype=dtype)


def _logits(llm, ids=IDS):
    with torch.no_grad():
        return llm(torch.as_tensor(ids, dtype=torch.long))[0].numpy()


def _assert_trees_equal(a, b, atol=0.0):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
            x, np.float32)
        y = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(
            y, np.float32)
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


# -- safetensors ---------------------------------------------------------------

def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g).bfloat16(),
            "b": torch.randn(5, generator=g),
            "h": torch.randn(2, 3, generator=g).half(),
            "i": torch.arange(6).reshape(2, 3),
            "j": torch.arange(3, dtype=torch.int32),
            "u": torch.arange(4, dtype=torch.uint8),
            "m": torch.tensor([True, False]), "s": torch.tensor(3.0),
            "e": torch.zeros(0, 3)}


def test_port_safetensors_are_the_package_bytes(tmp_path):
    """The port's file equals safetensors.torch.save_file's byte for byte,
    and each reads the other's bit-identically, every dtype kept."""
    tensors = _mixed_tensors()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.st"
    st.save_file(tensors, str(ours))
    safetensors.torch.save_file(tensors, str(theirs),
                                metadata={"format": "pt"})
    assert ours.read_bytes() == theirs.read_bytes()
    for got in (safetensors.torch.load_file(str(ours)),
                dict(st.iter_file(str(theirs)))):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_port_reads_the_jax_sharded_export(tmp_path):
    """JAX export_hf_weights with a tiny shard budget (several files and
    an index): iter_safetensors yields every tensor bit-identically, in
    bf16 too."""
    cfg, params = _jax_llm(dtype=jnp.bfloat16, attention_bias=True)
    jax_export(params, cfg, str(tmp_path), shard_gb=1e-5)
    index = json.loads((tmp_path / st.INDEX_FILE).read_text())
    assert len(set(index["weight_map"].values())) > 1
    want = {}
    for name in set(index["weight_map"].values()):
        want.update(safetensors.torch.load_file(str(tmp_path / name)))
    got = dict(st.iter_safetensors(str(tmp_path)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k],
                                                              want[k]), k


# -- HF import -------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_hf_import_gives_the_jax_logits(tmp_path, family):
    """A checkpoint JAX exports loads into the port's LLM with the JAX
    LLM's logits (1e-5); qwen2 carries q/k/v biases."""
    cfg, params = _jax_llm(attention_bias=(family == "qwen2"))
    jax_export(params, cfg, str(tmp_path))
    llm = load_hf_weights(str(tmp_path), _port_llm(
        attention_bias=cfg.attention_bias))
    want = np.asarray(jax_forward(params, cfg, input_ids=jnp.asarray(IDS))[0])
    np.testing.assert_allclose(_logits(llm), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tied", [False, True])
def test_vocabulary_padding_equals_jax(tmp_path, tied):
    """The tokenizer grew the vocabulary past the checkpoint's 96 rows:
    the port pads embedding (and head) with the JAX package's noisy mean
    (default_rng(0) / (1)), within 1e-7 (the f32 means sum in another
    order); an untied checkpoint without lm_head takes the embedding as
    its head first."""
    cfg, params = _jax_llm(tie_word_embeddings=tied)
    if not tied:
        params = dict(params)
        params.pop("lm_head")      # the head is implicit: JAX copies embed
    jax_export(params, cfg, str(tmp_path))
    if not tied:   # the export wrote tie_word_embeddings from the tree
        raw = json.loads((tmp_path / "config.json").read_text())
        assert raw["tie_word_embeddings"] is True
    big = replace(cfg, vocab_size=131)
    want = jax_import(str(tmp_path), big, dtype=jnp.float32)
    llm = load_hf_weights(str(tmp_path), _port_llm(131,
                                                   tie_word_embeddings=tied))
    np.testing.assert_allclose(llm.embed.weight.detach().numpy(),
                               np.asarray(want["embed"]["weight"]),
                               rtol=0, atol=1e-7)
    if not tied:
        np.testing.assert_allclose(llm.lm_head.weight.detach().numpy(),
                                   np.asarray(want["lm_head"]["w"]).T,
                                   rtol=0, atol=1e-7)
    else:
        assert llm.lm_head is None and "lm_head" not in want


def test_hf_import_refusals(tmp_path):
    """Another family's tensors (MoE / qwen3 / gemma) in a llama
    checkpoint have no place in a llama LLM and raise; a missing tensor
    and a tensor with no place raise; nothing is left to a random init."""
    cfg, params = _jax_llm()
    jax_export(params, cfg, str(tmp_path / "ok"))
    state = safetensors.torch.load_file(str(tmp_path / "ok" /
                                             "model.safetensors"))
    for name, extra in (
            ("moe", "model.layers.0.block_sparse_moe.gate.weight"),
            ("qwen3", "model.layers.1.self_attn.q_norm.weight"),
            ("gemma", "model.layers.0.pre_feedforward_layernorm.weight")):
        d = tmp_path / name
        d.mkdir()
        st.save_file({**state, extra: torch.ones(4)},
                     str(d / "model.safetensors"))
        with pytest.raises(ValueError, match="no place"):
            load_hf_weights(str(d), _port_llm())
    d = tmp_path / "missing"
    d.mkdir()
    st.save_file({k: v for k, v in state.items() if "up_proj" not in k},
                 str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="lacks 2 tensors"):
        load_hf_weights(str(d), _port_llm())
    d = tmp_path / "stray"
    d.mkdir()
    st.save_file({**state, "model.layers.0.self_attn.o_proj.bias":
                  torch.ones(64)}, str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="no place"):
        load_hf_weights(str(d), _port_llm())
    with pytest.raises(FileNotFoundError):
        load_hf_weights(str(tmp_path), _port_llm())


# -- HF export -------------------------------------------------------------------

def _random_port_llm(seed, **overrides):
    cfg, params = _jax_llm(seed, **overrides)
    llm = _port_llm(**overrides)
    llm.load_state_dict(llm_state_dict(jax.tree.map(np.asarray, params)))
    return llm, cfg, params


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_hf_export_loads_in_transformers(tmp_path, family):
    """The port's export loads in transformers with the port's logits
    (tests/test_hf_export.py's tolerance); qwen2's q/k/v biases load into
    Qwen2ForCausalLM. JAX's load_hf_weights reads the same directory
    bit-identically and its config.json equals JAX's."""
    transformers = pytest.importorskip("transformers")
    llm, cfg, params = _random_port_llm(6, attention_bias=(family == "qwen2"))
    nbytes = export_hf_weights(llm, str(tmp_path))
    assert nbytes == sum(t.numel() * 4 for t in llm.parameters())
    raw = json.loads((tmp_path / "config.json").read_text())
    assert raw == jax_hf_config(cfg, params)
    cls = (transformers.Qwen2ForCausalLM if family == "qwen2"
           else transformers.LlamaForCausalLM)
    model = cls.from_pretrained(str(tmp_path), torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        hf = model(torch.as_tensor(IDS, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(_logits(llm), hf, atol=2e-4, rtol=2e-3)
    _assert_trees_equal(jax_import(str(tmp_path), cfg, dtype=jnp.float32),
                        llm_tree(llm))


def test_export_shards_as_jax_does(tmp_path):
    """The same tree exported by both packages at a tiny shard budget:
    the same shard files, the same index, the same tensors; the port's
    export reloads bit-identically; to_hf_config equals JAX's on the
    ported presets."""
    llm, cfg, params = _random_port_llm(3)
    export_hf_weights(llm, str(tmp_path / "port"), shard_gb=1e-5)
    jax_export(params, cfg, str(tmp_path / "jax"), shard_gb=1e-5)
    for side in ("port", "jax"):
        assert (tmp_path / side / st.INDEX_FILE).exists()
    idx = [json.loads((tmp_path / s / st.INDEX_FILE).read_text())
           for s in ("port", "jax")]
    assert idx[0] == idx[1]
    ours = dict(st.iter_safetensors(str(tmp_path / "port")))
    theirs = dict(st.iter_safetensors(str(tmp_path / "jax")))
    assert set(ours) == set(theirs) == set(hf_state_dict(llm))
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    back = load_hf_weights(str(tmp_path / "port"), _port_llm())
    for (n, a), b in zip(llm.named_parameters(), back.parameters()):
        assert torch.equal(a, b), n
    for preset in ("llama3_8b", "qwen2_7b", "mistral_7b", "qwen3_8b",
                   "gemma2_9b", "gemma3_12b", "mixtral_8x7b", "tiny_moe"):
        assert (to_hf_config(getattr(LLMConfig, preset)())
                == jax_hf_config(getattr(JaxLLMConfig, preset)()))


_GEMMA = dict(hidden_act="gelu_tanh", rms_norm_unit_offset=True,
              scale_embeddings=True, tie_word_embeddings=True)
FAMILIES = {
    "qwen3": dict(qk_norm=True),
    "gemma1": _GEMMA,
    "gemma2": dict(_GEMMA, sandwich_norms=True, attn_logit_softcap=5.0,
                   final_logit_softcap=3.0, query_scale=24.0,
                   sliding_window=4),
    "gemma3": dict(_GEMMA, sandwich_norms=True, qk_norm=True,
                   query_scale=24.0, sliding_window=4,
                   sliding_window_pattern=3, rope_local_base_freq=1e4,
                   rope_scaling="linear", num_layers=3),
    "mixtral": dict(num_experts=4, num_experts_per_tok=2),
}


def _perturbed_jax_llm(**overrides):
    """_jax_llm with every norm scale + N(0, 0.1) (the unit-offset and q/k
    norms are drawn as 0 or 1)."""
    cfg, params = _jax_llm(**overrides)
    noise = np.random.default_rng(8)
    return cfg, jax.tree_util.tree_map_with_path(
        lambda path, a: (a + noise.normal(size=a.shape).astype(np.float32)
                         * 0.1) if path[-1].key == "scale" else np.asarray(a),
        params)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_hf_round_trip(tmp_path, family):
    """JAX exports the family's HF directory (in shards): the port loads
    it with JAX's logits (1e-5), exports it again with the same shards,
    index and config.json dict and every tensor bit-identical (the files
    differ only by the {"format": "pt"} metadata of the port's writer),
    and JAX reads the port's export back into its own tree exactly."""
    overrides = FAMILIES[family]
    cfg, params = _perturbed_jax_llm(**overrides)
    jax_export(params, cfg, str(tmp_path / "jax"), shard_gb=1e-5)
    llm = load_hf_weights(str(tmp_path / "jax"), _port_llm(**overrides))
    want = np.asarray(jax_forward(params, cfg, input_ids=jnp.asarray(IDS))[0])
    np.testing.assert_allclose(_logits(llm), want, rtol=0, atol=ATOL)
    export_hf_weights(llm, str(tmp_path / "port"), shard_gb=1e-5)
    for name in ("config.json", st.INDEX_FILE):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text())), name
    shards = sorted(p.name for p in (tmp_path / "jax").glob("*.safetensors"))
    assert shards == sorted(p.name for p in
                            (tmp_path / "port").glob("*.safetensors"))
    for name in shards:
        ours = dict(st.iter_file(str(tmp_path / "port" / name)))
        theirs = safetensors.torch.load_file(str(tmp_path / "jax" / name))
        assert list(ours) == list(theirs)
        for k in theirs:
            assert torch.equal(ours[k], theirs[k]), k
    _assert_trees_equal(jax_import(str(tmp_path / "port"), cfg,
                                   dtype=jnp.float32), params)


# -- merge_lora ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_equals_jax(dtype):
    """merge_lora writes JAX merge_lora's weights into the base in place
    (bf16 bit for bit; f32 within 1e-7: the two matmuls may sum the rank
    in another order) and drops the adapters; the merged f32 logits equal
    the adapter-on ones within 1e-5."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    cfg, params = _jax_llm(4, dtype=jdt)
    lora = init_lora(jax.random.PRNGKey(5), cfg, rank=4)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * np.random.default_rng(
        1).normal(size=a.shape).astype(np.float32), lora)
    scale = 2.0
    want = jax_merge_lora(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, lora), scale)
    llm = _port_llm(dtype=tdt)
    llm.add_lora(4, scale)
    llm.load_state_dict(llm_state_dict(jax.tree.map(np.asarray, params),
                                       lora))
    before = _logits(llm) if dtype == "float32" else None
    base_ptr = llm.layers[0].attn["q"].weight.data_ptr()
    assert merge_lora(llm) == 7 * cfg.num_layers
    assert llm.layers[0].attn["q"].weight.data_ptr() == base_ptr
    assert not [n for n, _ in llm.named_parameters() if "lora_" in n]
    _assert_trees_equal(llm_tree(llm), want,
                        atol=1e-7 if dtype == "float32" else 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(_logits(llm), before, rtol=0, atol=1e-5)


# -- refconvert ------------------------------------------------------------------

def _reference_state_dicts():
    """Reference-layout state dicts (the keys the converters read), small
    widths, from a numpy seed."""
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def lin(prefix, o, i, bias=True):
        d = {f"{prefix}.weight": t(o, i)}
        if bias:
            d[f"{prefix}.bias"] = t(o)
        return d

    def ln(prefix, h):
        return {f"{prefix}.weight": t(h), f"{prefix}.bias": t(h)}

    h, dh = 32, 8
    dit = {"x_embedder.0.weight": t(h, 20), **ln("x_embedder.1", h),
           **lin("t_embedder.mlp.0", h, 256), **lin("t_embedder.mlp.2", h, h),
           "y_embedder.embedding_drop.weight": t(3, h),
           "txt_embedder.embedding_drop.weight": t(1, h),
           **lin("txt_embedder.linear", h, 16),
           **lin("output_layer.xedecoder.fc1", h, h),
           **lin("output_layer.xedecoder.fc2", 20, h),
           **lin("output_layer.adaLN_modulation.0", h, h),
           **lin("output_layer.adaLN_modulation.2", 2 * h, h)}
    for d in range(3):
        dit.update(lin(f"y_embedder.mlps.{d}.0", h, 1))
        dit.update(lin(f"y_embedder.mlps.{d}.2", h, h, bias=False))
    for i in range(2):
        dit.update({**lin(f"blocks.{i}.attn.qkv", 3 * h, h, bias=False),
                    **ln(f"blocks.{i}.attn.q_norm", dh),
                    **ln(f"blocks.{i}.attn.k_norm", dh),
                    **lin(f"blocks.{i}.attn.proj", h, h),
                    **lin(f"blocks.{i}.mlp.fc1", 4 * h, h),
                    **lin(f"blocks.{i}.mlp.fc2", h, 4 * h),
                    **lin(f"blocks.{i}.adaLN_modulation.0", h, h),
                    **lin(f"blocks.{i}.adaLN_modulation.2", 6 * h, h)})

    def trunk(layers, norms):
        sd = {"atom_encoder.weight": t(120, h),
              "virtualnode_embedding.weight": t(1, h)}
        for i in range(layers):
            sd.update({f"convs.{i}.bond_encoder.weight": t(5, h),
                       f"convs.{i}.eps": t(1),
                       **lin(f"convs.{i}.mlp.0", 2 * h, h),
                       **ln(f"convs.{i}.mlp.1", 2 * h),
                       **lin(f"convs.{i}.mlp.4", h, 2 * h)})
            if norms:
                sd.update(ln(f"norms.{i}", h))
            if i < layers - 1:
                sd.update({**lin(f"mlp_virtualnode_list.{i}.0", 2 * h, h),
                           **ln(f"mlp_virtualnode_list.{i}.1", 2 * h),
                           **lin(f"mlp_virtualnode_list.{i}.4", h, 2 * h)})
        return sd

    encoder = trunk(3, True)
    proj = {**lin("fc1", h, h), **ln("norm1", h), **lin("fc2", 16, h)}
    predictor = {**trunk(3, False), "text_dropping.weight": t(1, 16),
                 **lin("decoder.0", 2 * h, h), **ln("decoder.1", 2 * h),
                 **lin("decoder.4", 10, 2 * h)}
    for i in range(3):
        predictor.update(lin(f"adapters.{i}.1", 2 * h, 16))
    connectors = {name: lin("0", 64, 32) for name in (
        "graph_to_lm_connector.pt", "lm_to_graph_decoder.pt",
        "lm_to_graph_predictor.pt")}
    return dit, encoder, proj, predictor, connectors


def test_refconvert_writes_the_jax_converters_trees(tmp_path):
    """Each converter, run by both packages on the same reference-layout
    state dicts (built in memory), writes equal trees and the same side
    files; the port's are the JAX files byte for byte."""
    from llamole_tpu.models import refconvert as jconv
    from llamole_tpu_torch.models import refconvert as tconv

    dit, encoder, proj, predictor, connectors = _reference_state_dicts()
    src = tmp_path / "src"
    for name, sd in (("graphdit", {"model.pt": dit}),
                     ("encoder", {"model.pt": encoder,
                                  "model_proj.pt": proj}),
                     ("predictor", {"model.pt": predictor}),
                     ("connectors", connectors)):
        (src / name).mkdir(parents=True)
        for fname, d in sd.items():
            torch.save(d, src / name / fname)
    (src / "graphdit" / "config.yaml").write_text("hidden_size: 32\n")
    (src / "encoder" / "model_config.json").write_text("{}")
    (src / "predictor" / "label_to_template.csv.gz").write_bytes(b"x")
    for kind in ("graphdit", "encoder", "predictor", "connectors"):
        getattr(jconv, f"convert_{kind}")(str(src / kind),
                                          str(tmp_path / "jax" / kind))
        assert tconv.main([kind, str(src / kind),
                           str(tmp_path / "port" / kind)]) == 0
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*")
                        if p.is_file())
    assert jax_files == port_files and len(jax_files) == 9
    for rel in jax_files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix == ".msgpack":
            _assert_trees_equal(load_pytree(str(b)), jax_load(str(a)))
        assert a.read_bytes() == b.read_bytes(), rel


def test_refconvert_refuses_the_reference_cost_model(tmp_path):
    """cost_model.pt beside the predictor stops the conversion before any
    write: the destination stays as it was."""
    from llamole_tpu_torch.models.refconvert import convert_predictor

    src = tmp_path / "src"
    src.mkdir()
    torch.save(_reference_state_dicts()[3], src / "model.pt")
    torch.save({}, src / "cost_model.pt")
    dst = tmp_path / "dst"
    with pytest.raises(SystemExit, match="REFUSING"):
        convert_predictor(str(src), str(dst))
    assert not dst.exists()
    dst.mkdir()
    (dst / "keep.txt").write_text("x")
    with pytest.raises(SystemExit, match="REFUSING"):
        convert_predictor(str(src), str(dst))
    assert [p.name for p in dst.iterdir()] == ["keep.txt"]


def test_dora_and_moe_leaves_are_refused():
    """(Named when DoRA raised.) A DoRA magnitude in a JAX adapter tree
    maps to lora_m as it is, and one beside a dense weight raises: never
    dropped. An MoE tree (router [H, E], experts [E, in, out]) goes
    through the bridge both ways bit-identically, in f32 and bf16."""
    got = state_dict_of({"q": {"a": np.ones((2, 1)), "b": np.ones((1, 2)),
                               "m": np.arange(2.0)}})
    assert sorted(got) == ["q.lora_a", "q.lora_b", "q.lora_m"]
    assert got["q.lora_m"].tolist() == [0.0, 1.0]
    with pytest.raises(ValueError, match="DoRA"):
        state_dict_of({"q": {"w": np.ones((2, 2)), "m": np.ones(2)}})
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        cfg, params = _jax_llm(dtype=jdt, num_experts=4,
                               num_experts_per_tok=2)
        params = jax.tree.map(np.asarray, params)
        llm = _port_llm(dtype=tdt, num_experts=4, num_experts_per_tok=2)
        llm.load_state_dict(llm_state_dict(params))
        mlp = llm.layers[1].mlp
        assert torch.equal(mlp.router.weight.T.float(), torch.from_numpy(
            np.asarray(params["layers"][1]["mlp"]["router"]["w"],
                       np.float32)))
        assert tuple(mlp.experts.down.shape) == (4, 128, 64)
        back = llm_tree(llm)
        assert (jax.tree.structure(back)
                == jax.tree.structure(jax.tree.map(lambda a: 0, params)))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            assert a.dtype == tdt and torch.equal(
                a, torch.from_numpy(np.asarray(b, np.float32)).to(tdt))
