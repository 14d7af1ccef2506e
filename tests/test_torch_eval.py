"""The MolQA evaluation of llamole_tpu_torch against llamole_tpu's: the
dataset, the generation-quality scores (uniqueness, novelty, BLEU/ROUGE,
FGD through the port's GraphCLIP) and run_molqa end to end, on one tiny
f32 stack with the JAX params bridged into the port and greedy decoding.
The diffusion sampler draws from different generators in the two
packages (its statistics are pinned in test_torch_graphdit.py), so here
both samplers return the same fixed designs: an ester and an amide that
the built-in templates disconnect, so Phase 2 finds routes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu import config as jax_config
from llamole_tpu.data.template import get_template as jax_get_template
from llamole_tpu.data.tokenizer import ByteTokenizer
from llamole_tpu.eval.dataset import MolQADataset as JaxDataset
from llamole_tpu.eval.scoring import (
    frechet_graphclip_distance as jax_fgd,
    generation_set_metrics as jax_set_metrics,
    oracle_property_metrics as jax_oracle_metrics)
from llamole_tpu.eval.workflow import run_molqa as jax_run_molqa
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
from llamole_tpu_torch import config as torch_config
from llamole_tpu_torch.data.template import get_template
from llamole_tpu_torch.data.tokenizer import \
    ByteTokenizer as TorchByteTokenizer
from llamole_tpu_torch.eval.dataset import MolQADataset
from llamole_tpu_torch.eval.scoring import (frechet_graphclip_distance,
                                            generation_set_metrics,
                                            oracle_property_metrics)
from llamole_tpu_torch.eval.workflow import run_molqa
from llamole_tpu_torch.models.composite import GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
from llamole_tpu_torch.models.graphclip import (
    GraphCLIPConfig as TorchCLIPConfig)
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (
    make_fallback_predictor as torch_predictor)
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.weights import graph_lm_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
DESIGNS = ["CCOC(C)=O", "CCNC(C)=O"]


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
    frozen_np = jax.tree.map(np.asarray,
                             jm.init_frozen(jax.random.PRNGKey(0)))
    trainable_np = jax.tree.map(np.asarray, jm.init_trainable(
        jax.random.PRNGKey(1), frozen_np))
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
    # the same designs from both samplers (see the module docstring)
    jm.graph_decoder.generate = lambda *a, **k: list(DESIGNS)
    tm.graph_decoder.generate = lambda *a, **k: list(DESIGNS)
    return tok, jm, frozen, trainable, tm


def _records(n=2):
    with open(os.path.join(ROOT, "data", "molqa_drug_examples.json")) as f:
        return json.load(f)[:n]


def test_molqa_dataset_matches_jax(stacks):
    tok, ttok = stacks[0], stacks[4].tokenizer
    ours = list(MolQADataset(_records(3), ttok, get_template("default", ttok),
                             96).batches(2))
    theirs = list(JaxDataset(_records(3), tok,
                             jax_get_template("default", tok),
                             96).batches(2))
    assert len(ours) == len(theirs) == 2
    for (a, sa), (b, sb) in zip(ours, theirs):
        assert sa == sb and a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_generation_scores_match_jax(stacks, tmp_path):
    tok, jm, frozen, _, tm = stacks
    records = _records(4)
    results = [{"llm_smiles": s, "llm_response": r} for s, r in [
        ("CC(=O)Oc1ccccc1C(=O)O", "the designed molecule is aspirin"),
        ("CCO", "ethanol, readily available"),
        ("CCO", ""), (None, "nothing")]]
    assert generation_set_metrics(results, records) == \
        jax_set_metrics(results, records)
    generated = ["CCO", "c1ccccc1", "CC(=O)OCC", "CC(N)C(=O)O", "bad"]
    gold = ["CC(=O)Oc1ccccc1C(=O)O", "c1ccncc1", "CCN", "COC"]
    want = jax_fgd(jm.graph_encoder, frozen["graph_encoder"], generated,
                   gold)
    got = frechet_graphclip_distance(tm.graph_encoder, generated, gold)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert frechet_graphclip_distance(tm.graph_encoder, ["CCO"], gold) \
        is None
    # a JAX-saved oracle scores these results in the port as in JAX
    from llamole_tpu.models.oracle import PropertyOracle as JaxOracle
    from llamole_tpu.models.oracle import PropertyOracleConfig as JaxOracleCfg
    oracle = JaxOracle(JaxOracleCfg(num_layer=2, hidden_size=16))
    oracle.save_pretrained(oracle.init(jax.random.PRNGKey(3)),
                           str(tmp_path / "oracle"))
    scored = [dict(r, property=p) for r, p in zip(results, [
        {"HIV": 1.0, "SA": 2.5}, {"BBBP": 0.0}, {"SA": 3.0}, {"HIV": 0.0}])]
    want = jax_oracle_metrics(str(tmp_path / "oracle"), scored)
    got = oracle_property_metrics(str(tmp_path / "oracle"), scored)
    assert got["property_scored_counts"] == want["property_scored_counts"]
    assert got["property_accuracy"] == want["property_accuracy"]
    assert got["property_mae"].keys() == want["property_mae"].keys()
    for k, v in want["property_mae"].items():
        np.testing.assert_allclose(got["property_mae"][k], v, rtol=1e-5)


def test_run_molqa_matches_jax(stacks, tmp_path):
    tok, jm, frozen, trainable, tm = stacks
    kw = dict(max_records=2, iterations=2, expansion_topk=16,
              max_planning_time=1e4, score=True)
    summaries = []
    # each side gets its own package's argument objects and tokenizer
    for name, run, prebuilt, cfg in (
            ("jax", jax_run_molqa, (jm, frozen, trainable, tok), jax_config),
            ("torch", run_molqa, (tm, tm.tokenizer), torch_config)):
        out = tmp_path / name
        data_args = cfg.DataArguments(
            dataset="molqa_drug_examples",
            dataset_dir=os.path.join(ROOT, "data"), template="default",
            cutoff_len=96, learned_query_size=8)
        gen_args = cfg.GeneratingArguments(max_new_tokens=8, do_sample=False,
                                           speculative_tokens=0)
        results = run(cfg.ModelArguments(model_name_or_path=""), data_args,
                      cfg.TrainingArguments(per_device_eval_batch_size=2,
                                            output_dir=str(out), seed=0),
                      cfg.FinetuningArguments(lora_rank=4), gen_args,
                      prebuilt=prebuilt, **kw)
        with open(out / "molqa_results.json") as f:
            summaries.append((results, json.load(f)["summary"]))
    (j_res, j_sum), (t_res, t_sum) = summaries
    assert t_sum.keys() == j_sum.keys()
    assert t_sum["validity"] == j_sum["validity"] == 1.0
    assert t_sum["retro_success"] == j_sum["retro_success"] == 1.0
    for key in ("num_records", "retro_expansions_per_mol", "planning_wall",
                "uniqueness", "novelty", "text_metrics"):
        assert t_sum[key] == j_sum[key], key
    np.testing.assert_allclose(t_sum["fgd"], j_sum["fgd"], rtol=1e-3)
    for t, j in zip(t_res, j_res):
        for key in ("qa_idx", "llm_smiles", "property", "llm_response",
                    "response_retro"):
            assert t[key] == j[key], key
        assert [r["reaction"] for r in t["llm_reactions"]] == \
            [r["reaction"] for r in j["llm_reactions"]]
