"""The retrosynthesis slice as a whole: llamole_tpu_torch's GraphLM Phase 2
against llamole_tpu's on one tiny f32 stack, the JAX params bridged into
the port (weights.graph_lm_state_dict). Greedy decoding on both sides, so
analyses, predictor inputs, values and routes must agree: the molecule
splice, the retro query hidden and predictor condition of
batched_one_step_reaction, the likert value scores (base LLM, adapter
off), and retrosynthesize_batch over two targets that the built-in
templates can disconnect into the built-in inventory.
"""

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
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.models.composite import GenerationSettings, GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
from llamole_tpu_torch.models.graphclip import (
    GraphCLIPConfig as TorchCLIPConfig)
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (
    make_fallback_predictor as torch_predictor)
from llamole_tpu_torch.data.tokenizer import \
    ByteTokenizer as TorchByteTokenizer
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.weights import graph_lm_state_dict

ATOL = 1e-4
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
# an ester and an amide: the built-in templates 0 and 1 split them into
# acetic acid + ethanol / ethylamine, all three in the built-in inventory
TARGETS = ["CC(=O)OCC", "CC(=O)NCC"]
GREEDY = dict(max_new_tokens=8, do_sample=False)


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
    # open the LoRA adapter (B starts at 0) and the predictor's AdaLN
    # gates (zero-initialised), so both change what they touch
    trainable["lora"] = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        trainable["lora"])
    for ada in frozen["graph_predictor"]["adapters"]:
        ada["w"] = rng.normal(size=np.shape(ada["w"])).astype(np.float32) * .1
        ada["b"] = rng.normal(size=np.shape(ada["b"])).astype(np.float32) * .1
    frozen_np = jax.tree.map(np.asarray, frozen)
    trainable_np = jax.tree.map(np.asarray, trainable)
    # the JAX side runs eager ops on its params: give it device arrays
    frozen = jax.tree.map(jnp.asarray, frozen_np)
    trainable = jax.tree.map(jnp.asarray, trainable_np)

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
    tm.load_state_dict(graph_lm_state_dict(frozen_np, trainable_np))
    return tok, jm, frozen, trainable, tm


def _record(obj, name, pick):
    """Wrap obj.name; append pick(args, result) of every call to the
    returned list."""
    seen = []
    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(pick(args, out))
        return out

    setattr(obj, name, wrapper)
    return seen


def test_splice_molecule_embeds_matches_jax(stacks):
    tok, jm, frozen, trainable, tm = stacks
    mol = tm.token_id_dict["<molecule>"]
    ids, _ = tm._left_pad([tok.encode("Make ") + [mol] + tok.encode(" now."),
                           tok.encode("Two ") + [mol, mol]])
    cols = [int(np.flatnonzero(r == mol)[-1]) for r in ids] + [
        int(np.flatnonzero(ids[1] == mol)[0])]
    from llamole_tpu.chem.featurize import pad_graph_batch, smiles_to_graph
    bank = pad_graph_batch([smiles_to_graph(s) for s in
                            ("CC(=O)OCC", "c1ccncc1", "CCO")], 16)
    rows = np.asarray([0, 1, 1], np.int32)
    valid = np.asarray([True, True, False])
    args = (ids, bank["atom_types"], bank["edge_classes"], bank["node_mask"],
            valid, rows, np.asarray(cols, np.int32))
    want = np.asarray(jm._splice_molecule_embeds(
        frozen, trainable, *map(jnp.asarray, args)))
    spliced = tm._splice_molecule_embeds(*[torch.from_numpy(np.asarray(a))
                                           for a in args])
    got = spliced.detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the splice is out of place, so graph_to_lm gets a gradient (training)
    spliced.sum().backward()
    assert tm.connectors["graph_to_lm"].weight.grad.abs().max() > 0
    tm.connectors["graph_to_lm"].weight.grad = None
    tm.connectors["graph_to_lm"].bias.grad = None
    # the invalid entry keeps its token embedding
    np.testing.assert_array_equal(got[1, cols[2]], np.asarray(
        frozen["llm"]["embed"]["weight"])[mol])


def test_batched_one_step_reaction_matches_jax(stacks):
    tok, jm, frozen, trainable, tm = stacks
    products = ["CC(=O)OCC", "CC(=O)NCC", "not a smiles"]
    kw = dict(design_text=["Design A.", None, "C"], prefix_ids=[
        tok.encode("x"), [], tok.encode("yz")], topk=16, analysis_tokens=24,
        pad_rows_to=4)
    j_hidden = _record(jm, "_body_hidden_jit", lambda a, out: out)
    j_cond = _record(jm.graph_predictor, "sample_templates",
                     lambda a, out: a[2])
    t_hidden = _record(tm, "_body_hidden", lambda a, out: out)
    t_cond = _record(tm.graph_predictor, "sample_templates",
                     lambda a, out: a[1])
    want = jm.batched_one_step_reaction(
        frozen, trainable, jax.random.PRNGKey(0), products,
        gen=JaxGen(speculative_tokens=0, **GREEDY), **kw)
    got = tm.batched_one_step_reaction(
        products, gen=GenerationSettings(**GREEDY),
        generator=torch.Generator().manual_seed(0), **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["analysis"] == w["analysis"]
        assert g["reactants"] == w["reactants"]
        assert g["templates"] == w["templates"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=ATOL)
    assert got[0]["reactants"], "the ester must be disconnected"
    # the retro query hidden (all 4 rows, the pad row included) and the
    # predictor condition of each valid product
    np.testing.assert_allclose(t_hidden[0].numpy(),
                               np.asarray(j_hidden[0]), atol=ATOL)
    assert len(j_cond) == len(t_cond) == 2
    for j, t in zip(j_cond, t_cond):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_value_scores_match_jax_with_the_adapter_off(stacks):
    tok, jm, frozen, trainable, tm = stacks
    smiles = ["CCO", "CC(=O)OCC", "c1ccncc1"]
    want = jm.batched_estimate_complexity(frozen, smiles, 1.0,
                                          trainable=trainable)
    got = tm.batched_estimate_complexity(smiles)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(
        tm.estimate_synthesis_complexity("CCO"),
        jm.estimate_synthesis_complexity(frozen, "CCO", trainable=trainable),
        atol=ATOL)
    # the adapter is back on afterwards, and it did change the scores
    assert all(m.lora_enabled for m in tm.llm.modules()
               if hasattr(m, "lora_enabled"))
    ids, mask = tm._left_pad([tok.encode("CCO")])
    with torch.no_grad():
        on = tm.llm(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask))[0][:, -1]
    assert not torch.allclose(on, tm._last_logits(
        torch.from_numpy(ids).long(), torch.from_numpy(mask)))


def test_retrosynthesize_batch_matches_jax(stacks):
    tok, jm, frozen, trainable, tm = stacks
    kw = dict(iterations=2, max_planning_time=1e4, share_planning_wall=False,
              total_width=4, rollback=False, expansion_topk=16)
    want = jm.retrosynthesize_batch(
        frozen, trainable, jax.random.PRNGKey(0), TARGETS,
        gen=JaxGen(speculative_tokens=0, **GREEDY), **kw)
    got = tm.retrosynthesize_batch(
        TARGETS, generator=torch.Generator().manual_seed(0),
        gen=GenerationSettings(**GREEDY), **kw)
    assert set(got) == set(want) == set(TARGETS)
    for smi in TARGETS:
        g, w = got[smi], want[smi]
        assert g["success"] and w["success"], (g, w)
        for key in ("target", "reaction_list", "templates",
                    "analysis_tokens", "route_length", "expansions"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["cost"], w["cost"], atol=ATOL)

