"""The design slice as a whole: llamole_tpu_torch's GraphLM.design_molecule
against llamole_tpu's on one tiny f32 stack (JAX params bridged into the
port), plus the port's serving surface (design and retro requests, the
explicit device). The retro half's parity is tests/test_torch_retro.py.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.data.tokenizer import ByteTokenizer
from llamole_tpu.models.composite import GenerationSettings as JaxGen
from llamole_tpu.models.composite import GraphLM as JaxGraphLM
from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.graphclip.model import GraphCLIP, GraphCLIPConfig
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.loader import make_fallback_predictor
from llamole_tpu.ops.nn import dense as jax_dense
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.models.composite import GenerationSettings, GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
from llamole_tpu_torch.models.graphclip import (
    GraphCLIPConfig as TorchCLIPConfig)
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                             make_fallback_predictor as
                                             torch_predictor,
                                             offline_tokenizer)
from llamole_tpu_torch.serve import (DesignServer, main as serve_main,
                                     serve_jsonl, serve_stream)
from llamole_tpu_torch.data.tokenizer import \
    ByteTokenizer as TorchByteTokenizer
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.weights import graph_lm_state_dict

CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
PROMPTS = ["Design a soluble molecule.", "Hi.",
           "Please design an aromatic ring with nitrogen."]


@pytest.fixture(scope="module")
def stacks():
    tok = ByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    jm = JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**DIT),
                                  jax_data_info(CORPUS, 10)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=4,
        finetuning_type="lora")
    frozen = jm.init_frozen(jax.random.PRNGKey(0))
    trainable = jm.init_trainable(jax.random.PRNGKey(1), frozen)
    rng = np.random.default_rng(2)
    trainable["lora"] = jax.tree.map(   # open the adapter (B starts at 0)
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        trainable["lora"])
    frozen = jax.tree.map(np.asarray, frozen)
    trainable = jax.tree.map(np.asarray, trainable)

    # the port's model holds the port's own tokenizer (same ids)
    ttok = TorchByteTokenizer(TORCH_SPECIAL_TOKENS)
    ttok.padding_side = "left"
    assert {t: ttok.token_to_id(t) for t in TORCH_SPECIAL_TOKENS} == ids
    tm = GraphLM(LLM(LLMConfig.tiny(), dtype=torch.float32),
                 GraphDiT(GraphDiTConfig(**DIT),
                          build_data_info_from_smiles(CORPUS, 10)),
                 torch_predictor(),
                 TorchCLIP(TorchCLIPConfig(num_layer=2, hidden_size=64)),
                 ttok, ids, lora_rank=4)
    tm.load_state_dict(graph_lm_state_dict(frozen, trainable))
    return tok, jm, frozen, trainable, tm


def _capture(model):
    """Record the design_hidden design_molecule hands downstream."""
    seen = {}
    inner = model.design_from_analysis

    def wrapper(*args, **kwargs):
        seen["hidden"] = kwargs["design_hidden"]
        return inner(*args, **kwargs)

    model.design_from_analysis = wrapper
    return seen


def test_design_molecule_matches_jax(stacks):
    tok, jm, frozen, trainable, tm = stacks
    ids, mask = tm._left_pad([tok.encode(p) for p in PROMPTS])
    props = np.full((3, 10), np.nan, np.float32)
    props[0, 9] = 2.5
    props[2, 1] = 1.0

    j_seen, t_seen = _capture(jm), _capture(tm)
    j_analysis, j_smiles = jm.design_molecule(
        frozen, trainable, jax.random.PRNGKey(3), ids, mask, props,
        gen=JaxGen(max_new_tokens=12, do_sample=False, speculative_tokens=0))
    t_analysis, t_smiles = tm.design_molecule(
        ids, mask, props, gen=GenerationSettings(max_new_tokens=12,
                                                 do_sample=False,
                                                 speculative_tokens=0),
        generator=torch.Generator().manual_seed(3))

    np.testing.assert_array_equal(t_analysis, np.asarray(j_analysis))
    j_hidden = np.asarray(j_seen["hidden"])
    np.testing.assert_allclose(t_seen["hidden"].numpy(), j_hidden, atol=1e-4)
    conn = trainable["connectors"]["lm_to_graph_decoder"]
    j_cond = np.asarray(jax.nn.silu(jax_dense(conn, jnp.asarray(j_hidden))))
    with torch.no_grad():
        t_cond = torch.nn.functional.silu(
            tm.connectors["lm_to_graph_decoder"](t_seen["hidden"]))
    np.testing.assert_allclose(t_cond.numpy(), j_cond, atol=1e-4)
    assert len(t_smiles) == len(j_smiles) == 3
    assert all(s is None or isinstance(s, str) for s in t_smiles)

    # the full re-forward (reuse_decode_cache=False) gives the same hidden
    body_hidden = tm._body_hidden
    reforward = []
    tm._body_hidden = lambda *a: reforward.append(body_hidden(*a)) or \
        reforward[-1]
    tm.design_molecule(ids, mask, props,
                       gen=GenerationSettings(max_new_tokens=12,
                                              do_sample=False,
                                              speculative_tokens=0,
                                              reuse_decode_cache=False))
    assert t_seen["hidden"] is None
    np.testing.assert_allclose(reforward[0].numpy(), j_hidden, atol=1e-4)


def test_design_molecule_on_an_int8_cache_matches_jax(stacks):
    """kv_cache_dtype='int8' on both packages (the JAX molqa default):
    the decode and the design-query extension run on the int8 cache, its
    reserved slots written quantized in place. Same analysis and design
    hidden as JAX's int8 path (atol 1e-4, f32), and within quantization
    error of the dense re-forward (median relative error < 0.05, as
    tests/test_design_extension.py::test_extension_int8_kv)."""
    tok, jm, frozen, trainable, tm = stacks
    from dataclasses import replace
    jm8 = JaxGraphLM(
        llm=JaxLLM(replace(JaxLLMConfig.tiny(), kv_cache_dtype="int8"),
                   dtype=jnp.float32),
        graph_decoder=jm.graph_decoder, graph_predictor=jm.graph_predictor,
        graph_encoder=jm.graph_encoder, tokenizer=tok,
        token_id_dict=jm.token_id_dict, lora_rank=4, finetuning_type="lora")
    tm8 = GraphLM(LLM(replace(LLMConfig.tiny(), kv_cache_dtype="int8"),
                      dtype=torch.float32),
                  tm.graph_decoder, tm.graph_predictor, tm.graph_encoder,
                  tm.tokenizer, tm.token_id_dict, lora_rank=4)
    tm8.load_state_dict(tm.state_dict())
    ids, mask = tm8._left_pad([tok.encode(p) for p in PROMPTS])
    props = np.full((3, 10), np.nan, np.float32)
    caches = []
    extend = tm8._body_hidden_extend
    tm8._body_hidden_extend = lambda cache, kv_valid, ext: (
        caches.append((cache, kv_valid.clone())) or
        extend(cache, kv_valid, ext))
    j_seen, t_seen = _capture(jm8), _capture(tm8)
    j_analysis, _ = jm8.design_molecule(
        frozen, trainable, jax.random.PRNGKey(3), ids, mask, props,
        gen=JaxGen(max_new_tokens=12, do_sample=False, speculative_tokens=0))
    t_analysis, _ = tm8.design_molecule(
        ids, mask, props, gen=GenerationSettings(max_new_tokens=12,
                                                 do_sample=False,
                                                 speculative_tokens=0),
        generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(t_analysis, np.asarray(j_analysis))
    np.testing.assert_allclose(t_seen["hidden"].numpy(),
                               np.asarray(j_seen["hidden"]), atol=1e-4)
    (cache, kv_before), = caches
    entry = cache[0]
    assert entry["k"].dtype == torch.int8
    # the 1 + K extension slots after each row's last valid one: written
    n_ext = 1 + tm8.num_body_tokens
    idx = torch.arange(kv_before.shape[1])
    write = torch.where(kv_before, idx + 1, 0).amax(dim=1)
    for row, w in enumerate(write.tolist()):
        assert bool((entry["k_scale"][row, w:w + n_ext] > 0).all())
    dense = tm._body_hidden(*map(torch.from_numpy, _full_rows(
        tm8, ids, mask, t_analysis)))
    rel = (t_seen["hidden"] - dense).abs() / dense.abs().clamp_min(1e-3)
    assert float(rel.median()) < 0.05


def _full_rows(model, ids, mask, analysis):
    """prompt + analysis (pads dropped) + <design_start> + K bodies per
    row, left-padded: the re-forward the extension stands for."""
    tid = model.token_id_dict
    pad = model.tokenizer.pad_token_id
    rows = []
    for p_ids, p_mask, a in zip(ids, mask, analysis):
        body = [t for t in a.tolist() if t != pad]
        rows.append([int(t) for t, m in zip(p_ids, p_mask) if m] + body
                    + [tid["<design_start>"]]
                    + [tid["<design_body>"]] * model.num_body_tokens)
    width = max(map(len, rows))
    out_ids = np.full((len(rows), width), pad, np.int64)
    out_mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out_ids[i, width - len(r):] = r
        out_mask[i, width - len(r):] = 1
    return out_ids, out_mask


def test_design_with_spliced_molecules_matches_jax(stacks):
    """design_molecule(molecule_batch=...): the prompt's <molecule> slots
    carry GraphCLIP embeddings through the analysis decode and the design
    query extension."""
    from llamole_tpu.chem.featurize import pad_graph_batch, smiles_to_graph
    tok, jm, frozen, trainable, tm = stacks
    mol = tm.token_id_dict["<molecule>"]
    ids, mask = tm._left_pad([tok.encode("Like ") + [mol] + tok.encode("."),
                              tok.encode("Improve ") + [mol]])
    bank = pad_graph_batch([smiles_to_graph(s) for s in
                            ("CC(=O)OCC", "c1ccncc1")], 8)
    batch = {"mol_atoms": bank["atom_types"],
             "mol_edges": bank["edge_classes"],
             "mol_node_mask": bank["node_mask"],
             "mol_valid": np.asarray([True, True]),
             "mol_rows": np.asarray([0, 1], np.int32),
             "mol_cols": np.asarray([int(np.flatnonzero(r == mol)[-1])
                                     for r in ids], np.int32)}
    props = np.full((2, 10), np.nan, np.float32)
    j_seen, t_seen = _capture(jm), _capture(tm)
    # the JAX splice runs eager ops on the params: device arrays
    want, _ = jm.design_molecule(
        jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray,
                                                        trainable),
        jax.random.PRNGKey(0), ids, mask, props,
        gen=JaxGen(max_new_tokens=8, do_sample=False, speculative_tokens=0),
        molecule_batch=batch)
    gen = GenerationSettings(max_new_tokens=8, do_sample=False,
                             speculative_tokens=0)
    got, _ = tm.design_molecule(ids, mask, props, gen=gen,
                                molecule_batch=batch)
    np.testing.assert_array_equal(got, np.asarray(want))
    spliced = t_seen["hidden"]
    np.testing.assert_allclose(spliced.numpy(), np.asarray(j_seen["hidden"]),
                               atol=1e-4)
    # without the splice the <molecule> slots are plain tokens
    tm.design_molecule(ids, mask, props, gen=gen)
    assert not torch.allclose(spliced, t_seen["hidden"], atol=1e-4)

def test_rollback_and_phase2_surface(stacks):
    tok, _, _, _, tm = stacks
    ds, body = tm.token_id_dict["<design_start>"], tm.token_id_dict[
        "<design_body>"]
    seq = tok.encode("Design.") + [ds] + [body] * 8
    out = tm.design_rollback(torch.Generator().manual_seed(0), [seq, seq],
                             ["CCO", None],
                             GenerationSettings(max_new_tokens=4))
    assert out[0] == "CCO" and (out[1] is None or isinstance(out[1], str))
    # Phase 2 is served now: the graph modules are the model's, and an
    # invalid target fails cleanly with rollback text
    assert isinstance(tm.graph_encoder, TorchCLIP)
    assert tm.graph_predictor.available
    plans = tm.retrosynthesize_batch(
        ["C1=C=C=1", None], generator=torch.Generator().manual_seed(0),
        iterations=1, gen=GenerationSettings(max_new_tokens=4,
                                             do_sample=False))
    assert plans[None]["success"] is False
    bad = plans["C1=C=C=1"]
    assert bad["success"] is False and isinstance(bad["analysis_tokens"],
                                                  list)
    # the dp leg takes a DeviceMesh or MeshGroups; anything else raises
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        tm.retrosynthesize_batch(["CCO"], mesh=object())


@pytest.fixture(scope="module")
def port_model():
    tok = offline_tokenizer()
    model = build_graph_lm_from_configs(
        LLMConfig.tiny(), GraphDiTConfig(**DIT),
        build_data_info_from_smiles(CORPUS, 10), tok, device="cpu",
        llm_dtype=torch.float32, finetuning_type="lora", lora_rank=4)
    return model, tok


def test_server_answers_jsonl_and_rejects_retro(port_model):
    """Design and retro requests are answered; malformed ones are
    rejected; {"stats": true} reports the counters inline."""
    model, tok = port_model
    server = DesignServer(model, tok, batch_size=2, max_wait_s=0.2,
                          gen=GenerationSettings(max_new_tokens=6),
                          retro_iterations=1, retro_max_time=60.0).start()
    lines = [json.dumps({"prompt": "Design a molecule.",
                         "property": {"SA": 2.0}}),
             json.dumps({"prompt": "Another one.", "property": {"HIV": 1}}),
             json.dumps({"prompt": "A third."}),
             json.dumps({"prompt": "Plan it.", "retro": True}),
             json.dumps({"prompt": "x", "retro": "yes"}),
             "not json"]
    out = io.StringIO()
    try:
        serve_stream(server, io.StringIO("\n".join(lines) + "\n"), out,
                     join_timeout=300)
    finally:
        server.stop()
    results = {r["id"]: r for r in map(json.loads,
                                       out.getvalue().splitlines())}
    assert sorted(results) == list(range(6))
    for i in range(3):
        assert "error" not in results[i], results[i]
        assert isinstance(results[i]["text"], str)
        assert results[i]["smiles"] is None or isinstance(
            results[i]["smiles"], str)
    assert "error" not in results[3], results[3]
    retro = results[3]["retro"]
    assert set(retro) == {"success", "reactions", "templates", "cost"}
    assert isinstance(retro["success"], bool)
    assert len(retro["reactions"]) == len(retro["cost"])
    assert "bad request" in results[4]["error"]
    assert "bad request" in results[5]["error"]
    assert server.requests_served == 4 and server.batches_run == 2
    stats = io.StringIO()
    serve_stream(server, io.StringIO('{"stats": true}\n'), stats)
    (st,) = map(json.loads, stats.getvalue().splitlines())
    assert st["requests_served"] == 4 and st["latency_p50_s"] > 0


def test_serve_jsonl_from_config():
    cfg = {"model_name_or_path": "", "max_new_tokens": 4,
           "learned_query_size": 8, "finetuning_type": "lora",
           "lora_rank": 4, "serve_batch_size": 2}
    out = io.StringIO()
    serve_jsonl(cfg, io.StringIO('{"prompt": "Design.", "property": '
                                 '{"BBBP": 1.0}}\n\n'), out, device="cpu")
    (result,) = map(json.loads, out.getvalue().splitlines())
    assert result["id"] == 0 and "error" not in result


def test_serving_without_a_card_needs_an_explicit_cpu(monkeypatch):
    """The default device is the card: with no CUDA, serve_jsonl and the
    CLI raise instead of silently serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_jsonl({"model_name_or_path": ""}, io.StringIO(""),
                    io.StringIO())
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_main(["config.yaml"])
