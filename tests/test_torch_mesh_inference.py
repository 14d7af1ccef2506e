"""Mesh inference in llamole_tpu_torch (GraphLM's dp legs, the tp-sharded
LLM's decode, run_molqa on a mesh) against the mesh-less port and
llamole_tpu.

Gloo ranks on the CPU (parallel/dryrun.py launch, each a process of
tests/torch_mesh_worker.py importing no JAX, 120 s a launch) run the tiny
GraphLM (2 layers, hidden 64, 4 heads, 2 kv heads, f32) bridged from a
JAX draw, greedy, with drafts off unless a case turns them on:

  design_molecule on dp:2 (batch 3, padded to 4; resampling and
  rollback on) and on dp:2,tp:2: analysis tokens and SMILES equal the
  mesh-less port's, the analysis tokens JAX's design_molecule(mesh=) on
  the same mesh string; one dp:2 case with drafts on; sampled design
  (seeded, the default temperature and top-p) on dp:2, with drafts off
  and on, and on dp:2,tp:2, equal to the mesh-less port;
  batched_one_step_reaction on dp:2 with 5 products: reactants and
  scores (rtol 1e-5) equal the mesh-less port's and JAX's;
  the Retro* search in lockstep: rank 1's clock runs a thousand times
  fast and each rank has its own PYTHONHASHSEED, and both ranks stop at
  rank 0's decision, as the mesh-less search on rank 0's clock does;
  `eval` under torchrun on dp:2 (the tiny eval YAML, greedy, a budget of
  2 iterations and a wall only they reach): molqa_results.json equals
  the mesh-less run's, and only rank 0 writes it.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
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
from llamole_tpu.parallel import mesh_from_string as jax_mesh_from_string
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.weights import graph_lm_state_dict

import torch_mesh_worker as worker
import torch_parallel_worker as base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 120       # seconds a launch of ranks may take
REL = 1e-5        # template scores
PROMPTS = ["Design a soluble molecule.", "Hi.",
           "Please design an aromatic ring with nitrogen."]
PRODUCTS = ["CC(=O)OCC", "CC(=O)NCC", "CC(=O)Oc1ccccc1C(=O)O",
            "CCOC(=O)C", "CC(=O)Nc1ccc(O)cc1"]
TARGETS = ["CC(=O)OCC", "CC(=O)NCC"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _open(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX draw (the adapter opened) bridged into a state dict, and
    the cases every mesh runs."""
    work = tmp_path_factory.mktemp("mesh_inference")
    tok = JaxByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    jm = JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**base.DIT),
                                  jax_data_info(base.CORPUS, base.MAX_N)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=4,
        finetuning_type="lora")
    frozen = jax.tree.map(np.asarray, jm.init_frozen(jax.random.PRNGKey(0)))
    trainable = jm.init_trainable(jax.random.PRNGKey(1), frozen)
    trainable = {"connectors": jax.tree.map(np.asarray,
                                            trainable["connectors"]),
                 "lora": _open(trainable["lora"], 3, 0.05)}
    state = graph_lm_state_dict(frozen, trainable)
    torch.save(state, work / "state.pt")
    model = base.tiny_model(state)
    pid, pmask = model._left_pad([tok.encode(p) for p in PROMPTS])
    props = np.full((3, 10), np.nan, np.float32)
    props[0, 9] = 2.5
    props[2, 1] = 1.0
    design = {"kind": "design", "ids": pid.tolist(), "mask": pmask.tolist(),
              "props": props.tolist(),
              "max_new_tokens": 12, "seed": 3}
    cases = {
        "design": {**design, "rollback": True, "design_resamples": 1},
        "drafts": {**design, "speculative_tokens": 2, "seed": 4},
        # sampled at the default temperature and top-p (drafts off, as
        # the auto rule has them when sampling; then on)
        "sampled": {**design, "do_sample": True, "seed": 5,
                    "rollback": True, "design_resamples": 1},
        "sampled_drafts": {**design, "do_sample": True, "seed": 6,
                           "speculative_tokens": 2},
        "retro": {"kind": "retro", "products": PRODUCTS, "topk": 16,
                  "analysis_tokens": 16, "max_new_tokens": 8},
        # the clock is read 5 times a round: rank 0's allows 2 rounds
        "lockstep": {"kind": "lockstep", "targets": TARGETS,
                     "iterations": 50, "wall": 8.5, "width": 4, "topk": 3,
                     "max_new_tokens": 4},
    }
    return types.SimpleNamespace(work=work, tok=tok, jm=jm, frozen=frozen,
                                 trainable=trainable, state=state,
                                 cases=cases, props=props, model=model)


@pytest.fixture(scope="module")
def launched(setup):
    """dp:2 (every case, a PYTHONHASHSEED of each rank's own), dp:2,tp:2
    (the design) and the eval pair (torchrun on dp:2 and the mesh-less
    run), side by side on threads."""
    from concurrent.futures import ThreadPoolExecutor

    def go(spec, names, rank_env=None):
        out = setup.work / spec.replace(":", "").replace(",", "_")
        return dryrun.launch("torch_mesh_worker:infer", 4 if "tp" in spec
                             else 2, {
                                 "state": str(setup.work / "state.pt"),
                                 "mesh": spec,
                                 "cases": {n: setup.cases[n] for n in names}},
                             timeout=LIMIT, workdir=str(out), path=[HERE],
                             rank_env=rank_env)

    pool = ThreadPoolExecutor(4)
    futures = {
        "dp:2": pool.submit(go, "dp:2", list(setup.cases), {
            0: {"PYTHONHASHSEED": "1"}, 1: {"PYTHONHASHSEED": "2"}}),
        "dp:2,tp:2": pool.submit(go, "dp:2,tp:2", ["design", "sampled"]),
        "eval": pool.submit(_eval_pair, setup.work / "eval")}
    yield futures
    pool.shutdown(wait=True)


def _plain(setup, name):
    return worker.run_case(base.tiny_model(setup.state), setup.cases[name])


def _jax_gen(case):
    return JaxGen(max_new_tokens=case["max_new_tokens"], do_sample=False,
                  speculative_tokens=0)


@pytest.mark.parametrize("spec", ["dp:2", "dp:2,tp:2"])
def test_design_on_a_mesh_matches_the_mesh_less_port_and_jax(
        setup, launched, spec):
    """The batch of 3 padded to 4 over dp: analysis tokens and SMILES
    (after a resampling round and the rollback) equal the mesh-less
    port's on every rank; the analysis tokens equal JAX's
    design_molecule(mesh=) on the same mesh string."""
    ranks = launched[spec].result()
    want = _plain(setup, "design")
    for r, got in enumerate(ranks):
        assert got["design"] == want, f"{spec} rank {r}"
    case = setup.cases["design"]
    j_analysis, _ = setup.jm.design_molecule(
        setup.frozen, setup.trainable, jax.random.PRNGKey(3),
        np.asarray(case["ids"]), np.asarray(case["mask"]), setup.props,
        gen=_jax_gen(case), mesh=jax_mesh_from_string(spec))
    np.testing.assert_array_equal(np.asarray(want["analysis"]),
                                  np.asarray(j_analysis))
    assert len(want["smiles"]) == 3


def test_drafted_design_on_dp_matches_the_mesh_less_port(setup, launched):
    """Prompt-lookup drafts (K=2) on each rank's rows: the same analysis
    tokens and SMILES as the drafted mesh-less run."""
    want = _plain(setup, "drafts")
    for got in launched["dp:2"].result():
        assert got["drafts"] == want


@pytest.mark.parametrize("spec,name", [("dp:2", "sampled"),
                                       ("dp:2", "sampled_drafts"),
                                       ("dp:2,tp:2", "sampled")])
def test_sampled_design_on_a_mesh_matches_the_mesh_less_port(
        setup, launched, spec, name):
    """Sampled decode (temperature 0.6, top-p 0.9, seeded), with drafts
    off and on: every dp rank draws each step's noise for the whole batch
    and keeps its rows, and the ranks stop in lockstep, so the analysis
    tokens and SMILES equal the mesh-less port's on every rank."""
    want = _plain(setup, name)
    assert len(set(map(tuple, want["analysis"]))) == 3
    for r, got in enumerate(launched[spec].result()):
        assert got[name] == want, f"{spec} rank {r}"


def test_retro_expansion_on_dp_matches_the_mesh_less_port_and_jax(
        setup, launched):
    """5 products over dp:2 (padded to 10 rows): reactants, templates and
    analyses equal, scores within 1e-5, on both ranks; the same against
    JAX's batched_one_step_reaction(mesh=) on dp:2."""
    want = _plain(setup, "retro")
    case = setup.cases["retro"]
    jax_out = setup.jm.batched_one_step_reaction(
        jax.tree.map(jnp.asarray, setup.frozen),
        jax.tree.map(jnp.asarray, setup.trainable), jax.random.PRNGKey(0),
        PRODUCTS,
        topk=case["topk"], gen=_jax_gen(case),
        analysis_tokens=case["analysis_tokens"],
        mesh=jax_mesh_from_string("dp:2"))
    assert len(want) == len(jax_out) == 5
    assert any(row["reactants"] for row in want)
    for ranks_row in [r["retro"] for r in launched["dp:2"].result()]:
        for got, w, j in zip(ranks_row, want, jax_out):
            for ref in (w, j):
                assert got["reactants"] == list(ref["reactants"])
                assert got["templates"] == list(ref["templates"])
                assert got["analysis"] == list(ref["analysis"])
                np.testing.assert_allclose(got["scores"], ref["scores"],
                                           rtol=REL)


def test_search_stops_in_lockstep_at_rank_0s_decision(setup, launched):
    """Rank 1's clock runs a thousand times fast (alone it would stop
    before the first expansion) and the ranks hash strings differently:
    both end, the same plans on both, at rank 0's decision, equal to the
    mesh-less search on rank 0's clock."""
    ranks = launched["dp:2"].result()
    seeds = [r["lockstep"]["hashseed"] for r in ranks]
    assert seeds == ["1", "2"]
    assert ranks[0]["lockstep"]["hash"] != ranks[1]["lockstep"]["hash"]
    want = _plain(setup, "lockstep")["plans"]
    # rank 1's own clock would have stopped before the first round
    assert all(1 <= plan[1] <= 2 for plan in want.values()), want
    for r in ranks:
        assert r["lockstep"]["plans"] == want


def _eval_yaml(work, mesh):
    with open(os.path.join(ROOT, "config", "smoke", "tiny_eval.yaml")) as f:
        text = f.read().replace("output_dir: saves/tiny-eval",
                                f"output_dir: {work / (mesh or 'plain')}")
    path = work / f"{mesh or 'plain'}.yaml"
    path.write_text(text + "do_sample: false\nfrontier_width: 2\n"
                    + (f"mesh: {mesh}\n" if mesh else ""))
    return path


def _eval_pair(work):
    """`eval` through the CLI: under torchrun on dp:2 (2 gloo ranks) and
    without a mesh, each with 2 iterations and a 600 s wall."""
    work.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, HERE])}
    script = os.path.join(HERE, "torch_mesh_worker.py")
    procs = {}
    for mesh in ("dp2", None):
        yaml = _eval_yaml(work, "dp:2" if mesh else None)
        cmd = ([sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", "2", "--master-port",
                str(_free_port())] if mesh else [sys.executable])
        procs[mesh] = subprocess.Popen(
            cmd + [script, "eval", str(yaml), "2", "600"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for mesh, p in procs.items():
        stdout, stderr = p.communicate(timeout=LIMIT)
        out[mesh] = (p.returncode, stderr)
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_eval_on_dp_matches_the_mesh_less_run(setup, launched):
    """torchrun --nproc-per-node 2 ... eval <tiny eval yaml, mesh dp:2>:
    both phases on the mesh; molqa_results.json's records equal the
    mesh-less run's. Rank 1 may not write it: its json.dump raises
    (torch_mesh_worker.py)."""
    done = launched["eval"].result()
    for mesh, (rc, stderr) in done.items():
        assert rc == 0, stderr[-3000:]
    work = setup.work / "eval"
    with open(work / "dp:2" / "molqa_results.json") as f:
        got = json.load(f)
    with open(work / "plain" / "molqa_results.json") as f:
        want = json.load(f)
    assert got["results"] == want["results"]
    assert got["summary"]["num_records"] == want["summary"]["num_records"]
    assert got["summary"]["validity"] == want["summary"]["validity"]
    assert sorted(os.listdir(work / "dp:2")) == ["molqa_results.json"]
    assert all(r.get("llm_reactions") is not None for r in got["results"])


def test_a_tp_sharded_llm_decodes_eagerly():
    """A deliberate difference: on the card generate's step replays a CUDA
    graph, but not for a tp-sharded LLM (its step's collectives are not
    recorded); its KV cache holds the rank's KV / tp heads."""
    from llamole_tpu_torch.models.gllm import LLM, LLMConfig
    from llamole_tpu_torch.models.gllm.model import make_kv_cache
    from llamole_tpu_torch.parallel.sharding import TP
    cfg = LLMConfig.tiny()
    llm = LLM(cfg, dtype=torch.float32)
    card = torch.device("cuda")
    assert llm._graphs_apply(card)
    llm.tp = TP("vocab", None, 2, 0)
    assert not llm._graphs_apply(card)
    cache = make_kv_cache(cfg, 3, 7, torch.float32, "cpu", tp=2)
    assert cache[0]["k"].shape == (3, 7, cfg.num_kv_heads // 2,
                                   cfg.head_dim_)
