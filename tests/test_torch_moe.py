"""The Mixtral sparse-MoE MLP of llamole_tpu_torch against llamole_tpu
(f32, CPU): the router's aux loss (1e-6), the capacity drops as sets of
(token, slot) units, pad tokens kept out of routing, num_experts=1 as the
dense MLP, router and expert gradients against jax.grad (1e-4), LoRA's
target filtering, quantization passing the experts through, merge_lora,
and GraphLM.loss with the router term (1e-4). JAX params reach the port
through llamole_tpu_torch.weights; inputs come from seeded numpy."""

import dataclasses
import logging
import os
import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm import merge_lora as jax_merge_lora
from llamole_tpu.models.gllm.model import _moe_mlp
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu.models.gllm.quantize import \
    quantize_llm_params as jax_quantize
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.lora import lora_targets, merge_lora
from llamole_tpu_torch.models.gllm.model import lm_loss, moe_dispatch, moe_mlp
from llamole_tpu_torch.models.gllm.quantize import quantize_llm_params
from llamole_tpu_torch.weights import llm_state_dict, state_dict_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
AUX_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(factor=1.25, experts=4, top_k=2):
    return (replace(JaxLLMConfig.tiny_moe(num_experts=experts, top_k=top_k),
                    moe_capacity_factor=factor),
            replace(LLMConfig.tiny_moe(num_experts=experts, top_k=top_k),
                    moe_capacity_factor=factor))


def _pair(factor=1.25, experts=4, top_k=2, seed=0):
    jcfg, cfg = _cfgs(factor, experts, top_k)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed),
                                                  jcfg, jnp.float32))
    model = LLM(cfg, dtype=torch.float32)
    model.load_state_dict(llm_state_dict(params))
    return jcfg, params, model


def _tokens(b=3, s=11, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :4] = 0       # left padding
    mask[2, :7] = 0
    return ids, mask


def _hidden(b=3, s=11, h=64, seed=1):
    x = np.random.default_rng(seed).normal(size=(b, s, h)).astype(np.float32)
    _, mask = _tokens(b, s)
    return x, mask


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_aux_loss_equals_jax(factor):
    """forward(return_moe_aux=True) on left-padded prompts: the aux loss
    (the per-layer sum over the depth) within 1e-6 of JAX's, the logits
    within 1e-4, at the default factor and at one where units drop."""
    jcfg, params, model = _pair(factor)
    ids, mask = _tokens()
    want = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask), return_moe_aux=True)
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask),
                    return_moe_aux=True)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=0,
                               atol=AUX_ATOL)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[0].numpy()[real],
                               np.asarray(want[0])[real], atol=ATOL)


def _probe_experts(params, cfg):
    """Experts whose output reveals routing: expert e writes ~10 x its
    combine weight into channel e alone (gate[e][0, 0] = 10, up[e][0, 0]
    = 1, down[e][0, e] = 1, the rest 0; the inputs carry x[..., 0] = 1),
    so y[t, e] > 0 exactly when the unit (t, slot -> e) was kept."""
    mlp = params["layers"][0]["mlp"]
    e, h, inter = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gate = np.zeros((e, h, inter), np.float32)
    up = np.zeros((e, h, inter), np.float32)
    down = np.zeros((e, inter, h), np.float32)
    gate[:, 0, 0], up[:, 0, 0] = 10.0, 1.0
    for i in range(e):
        down[i, 0, i] = 1.0
    return {"router": mlp["router"],
            "experts": {"gate": gate, "up": up, "down": down}}


def _kept_units(y, top_idx):
    """{(token, slot)} whose expert's channel of y is nonzero."""
    t, k = top_idx.shape
    y = y.reshape(t, -1)
    return {(i, j) for i in range(t) for j in range(k)
            if y[i, top_idx[i, j]] > 0}


@pytest.mark.parametrize("factor", [1.25, 0.5, 0.25])
def test_drop_sets_equal_jax(factor):
    """The kept (token, slot) units of JAX's _moe_mlp and the port's are
    the same set (read off the probe experts), the port's moe_dispatch
    names exactly that set, the outputs agree (1e-5), and the port counts
    the valid units it dropped."""
    jcfg, params, model = _pair(factor)
    p = _probe_experts(params, jcfg)
    mlp = model.layers[0].mlp
    mlp.load_state_dict(state_dict_of(p))
    x, mask = _hidden()
    x[..., 0] = 1.0
    valid = mask.reshape(-1) > 0
    want, _ = _moe_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                       token_valid=jnp.asarray(valid))
    want = np.asarray(want)
    with torch.no_grad():
        got, _, dropped = moe_mlp(mlp, torch.from_numpy(x), model.cfg,
                                  torch.from_numpy(valid))
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 64))
                          @ mlp.router.weight.detach().T, -1)
    top_idx = torch.topk(probs, 2, dim=-1).indices
    kept = _kept_units(want, top_idx.numpy())
    assert _kept_units(got, top_idx.numpy()) == kept
    order, _, keep, cap = moe_dispatch(top_idx, torch.from_numpy(valid)
                                       .float(), 4, factor)
    ours = {(int(u) // 2, int(u) % 2) for u in order[keep]}
    assert ours == kept
    assert cap == max(int(np.ceil(factor * 33 * 2 / 4)), 1)
    assert int(dropped) == 2 * int(valid.sum()) - len(kept)
    if factor < 1:
        assert int(dropped) > 0       # the tight factors do drop units


def test_padding_takes_no_capacity_and_no_aux():
    """Pad tokens' contents change neither the real tokens' outputs nor
    the aux loss (they route to no expert and count in no mean); both
    equal JAX's (1e-5 / 1e-6)."""
    jcfg, params, model = _pair(0.5)
    mlp = model.layers[0].mlp
    x, mask = _hidden()
    valid = mask.reshape(-1) > 0
    x2 = x.copy()
    x2[~mask.astype(bool)] = 50.0 * np.random.default_rng(4).normal(
        size=x2[~mask.astype(bool)].shape)
    outs = []
    for xs in (x, x2):
        with torch.no_grad():
            y, aux, dropped = moe_mlp(mlp, torch.from_numpy(xs), model.cfg,
                                      torch.from_numpy(valid))
        outs.append((y.numpy(), float(aux), int(dropped)))
        jy, jaux = _moe_mlp(jax.tree.map(jnp.asarray,
                                         params["layers"][0]["mlp"]),
                            jnp.asarray(xs), jcfg,
                            token_valid=jnp.asarray(valid))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_ATOL)
    real = mask.astype(bool)
    np.testing.assert_array_equal(outs[0][0][real], outs[1][0][real])
    assert outs[0][1] == outs[1][1] and outs[0][2] == outs[1][2]
    np.testing.assert_array_equal(outs[0][0][~real], 0.0)


def test_one_expert_equals_the_dense_mlp():
    """num_experts=1, top-1: every unit is kept with weight 1, so the MoE
    LLM gives the dense LLM's logits with the same weights (and JAX's)."""
    jcfg, params, moe = _pair(experts=1, top_k=1)
    dense = LLM(LLMConfig.tiny(), dtype=torch.float32)
    state = dict(moe.state_dict())
    for i in range(dense.cfg.num_layers):
        pre = f"layers.{i}.mlp."
        for name in ("gate", "up", "down"):
            state[f"{pre}{name}.weight"] = state.pop(
                f"{pre}experts.{name}")[0].T.contiguous()
        state.pop(pre + "router.weight")
    dense.load_state_dict(state)
    ids, mask = _tokens()
    with torch.no_grad():
        got = moe(torch.from_numpy(ids).long(), torch.from_numpy(mask))[0]
        want = dense(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask))[0]
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want.numpy()[real],
                               rtol=0, atol=1e-5)
    jwant = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask))[0]
    np.testing.assert_allclose(got.numpy()[real], np.asarray(jwant)[real],
                               atol=ATOL)


def _labels(ids, mask, seed=4):
    rng = np.random.default_rng(seed)
    keep = mask.astype(bool) & (rng.random(ids.shape) < 0.5)
    return np.where(keep, ids, -100).astype(np.int32)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_router_and_expert_gradients_match_jax(factor):
    """The gradient of lm_loss + moe_aux_loss_coef x aux with respect to
    every router, expert and attention weight equals jax.grad's (1e-4)."""
    jcfg, params, model = _pair(factor)
    ids, mask = _tokens()
    labels = _labels(ids, mask)

    def j_loss(p):
        logits, _, _, aux = jax_forward(p, jcfg, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask),
                                        train=True, return_moe_aux=True)
        return (jax_lm_loss(logits, jnp.asarray(labels))
                + jcfg.moe_aux_loss_coef * aux)

    want, want_g = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray,
                                                           params))
    logits, _, _, aux = model(input_ids=torch.from_numpy(ids).long(),
                              attention_mask=torch.from_numpy(mask),
                              return_moe_aux=True)
    loss = (lm_loss(logits, torch.from_numpy(labels))
            + model.cfg.moe_aux_loss_coef * aux)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = llm_state_dict(jax.tree.map(np.asarray, want_g))
    checked = 0
    for name, p in model.named_parameters():
        if ".mlp." in name or ".attn." in name:
            assert float(p.grad.abs().max()) > 0, name
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                       atol=ATOL, err_msg=name)
            checked += 1
    assert checked == 2 * (4 + 4)   # router + 3 experts + q, k, v, o


def test_lora_keeps_the_attention_targets_and_refuses_mlp_only():
    """Under MoE the adapter covers q/k/v/o (JAX init_lora's filter); a
    list of MLP targets alone raises, in both packages."""
    jcfg, cfg = _cfgs()
    assert lora_targets(cfg) == ("q", "k", "v", "o")
    jlora = init_lora(jax.random.PRNGKey(0), jcfg, rank=4)
    model = LLM(cfg, dtype=torch.float32)
    model.add_lora(4, 2.0)
    adapted = sorted(n.rsplit(".", 1)[0] for n, _ in model.named_parameters()
                     if n.endswith("lora_a"))
    want = sorted(f"layers.{i}.{g}.{t}" for i, layer in
                  enumerate(jlora["layers"]) for g in layer
                  for t in layer[g])
    assert adapted == want and len(want) == 8
    for targets in (("gate", "up", "down"), ("down",)):
        with pytest.raises(ValueError, match="all MLP projections"):
            lora_targets(cfg, targets)
        with pytest.raises(ValueError, match="all MLP projections"):
            init_lora(jax.random.PRNGKey(0), jcfg, rank=4, targets=targets)
    dense = LLMConfig.tiny()
    assert lora_targets(dense, ("down",)) == ("down",)


def test_quantize_passes_the_router_and_experts_through():
    """quantize_llm_params on an MoE LLM: the attention projections and
    the head as JAX quantizes them (bit for bit), the router and experts
    left as they were, with JAX's warning."""
    jcfg, params, model = _pair()
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if ".mlp." in n}
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("llamole_tpu_torch.models.gllm.quantize")
    logger.addHandler(handler)
    try:
        quantize_llm_params(model, bits=8)
    finally:
        logger.removeHandler(handler)
    assert any("NOT quantized" in r.getMessage() for r in records)
    state = model.state_dict()
    for name, t in before.items():
        assert torch.equal(state[name], t), name
    want = llm_state_dict(jax.tree.map(np.asarray,
                                       jax_quantize(params, bits=8)))
    assert set(want) == set(state)
    for name, t in want.items():
        assert torch.equal(state[name], t), name
    assert model.layers[0].attn["q"].quant == "int8"


def test_merge_lora_over_an_moe_llm_equals_jax():
    """merge_lora folds the attention adapters into their bases as JAX's
    merge_lora does (1e-6) and leaves the router and experts alone."""
    jcfg, params, model = _pair()
    rng = np.random.default_rng(5)
    lora = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), jcfg, rank=4))
    model.add_lora(4, 2.0)
    model.load_state_dict(llm_state_dict(params, lora))
    assert merge_lora(model) == 8
    want = llm_state_dict(jax.tree.map(np.asarray,
                                       jax_merge_lora(params, lora, 2.0)))
    state = model.state_dict()
    assert set(want) == set(state)
    for name, t in want.items():
        np.testing.assert_allclose(state[name].numpy(), t.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


# -- GraphLM.loss with the router term ----------------------------------------

def test_graph_lm_loss_with_a_moe_llm_matches_jax():
    """GraphLM.loss(train=False) over a tiny MoE LLM (lm_loss carries
    moe_aux_loss_coef x aux, as JAX's loss_fn): the total and the three
    terms within 1e-4, and the gradients of the attention adapters and
    the connectors within 1e-4."""
    from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from llamole_tpu.models.composite import GraphLM as JaxGraphLM
    from llamole_tpu.models.gllm import LLM as JaxLLM
    from llamole_tpu.models.graphclip.model import (GraphCLIP,
                                                    GraphCLIPConfig)
    from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
    from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
    from llamole_tpu.models.graphdit.config import (
        build_data_info_from_smiles as jax_data_info)
    from llamole_tpu.models.graphdit.diffusion import apply_noise
    from llamole_tpu.models.loader import make_fallback_predictor
    from llamole_tpu.utils.constants import SPECIAL_TOKENS
    from llamole_tpu_torch.data.collator import SeqGraphCollator
    from llamole_tpu_torch.data.loader import get_dataset
    from llamole_tpu_torch.data.tokenizer import ByteTokenizer
    from llamole_tpu_torch.models.composite import GraphLM
    from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
    from llamole_tpu_torch.models.graphclip import (
        GraphCLIPConfig as TorchCLIPConfig)
    from llamole_tpu_torch.models.graphdit import (
        GraphDiT, GraphDiTConfig, build_data_info_from_smiles)
    from llamole_tpu_torch.models.loader import (
        make_fallback_predictor as torch_predictor)
    from llamole_tpu_torch.utils.constants import \
        SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
    from llamole_tpu_torch.weights import (graph_lm_state_dict,
                                           trainable_state_dict)

    corpus = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
    dit = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
               text_dim=16)
    max_n = 16
    jcfg, cfg = _cfgs()
    jtok = JaxByteTokenizer(SPECIAL_TOKENS)
    jtok.padding_side = "left"
    jm = JaxGraphLM(
        llm=JaxLLM(jcfg, dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**dit),
                                  jax_data_info(corpus, max_n)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=jtok,
        token_id_dict={t: jtok.token_to_id(t) for t in SPECIAL_TOKENS},
        lora_rank=4, finetuning_type="lora")
    frozen = jax.tree.map(np.asarray, jm.init_frozen(jax.random.PRNGKey(0)))
    trainable = jax.tree.map(np.asarray,
                             jm.init_trainable(jax.random.PRNGKey(1), frozen))
    rng = np.random.default_rng(3)
    trainable["lora"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        trainable["lora"])

    tok = ByteTokenizer(TORCH_SPECIAL_TOKENS)
    tok.padding_side = "left"
    data_args = types.SimpleNamespace(
        dataset="molqa_train_examples", dataset_dir=os.path.join(ROOT, "data"),
        max_samples=None, template="default", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    bank, inputs = get_dataset(None, data_args, None, tok)
    batch = SeqGraphCollator(tokenizer=tok, mol_id_to_graph=bank,
                             max_len=768, max_nodes=max_n, max_graphs=16,
                             max_retro=16)(inputs[0:2])

    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_total, j_aux), j_grads = jax.value_and_grad(
        lambda tr: jm.loss_fn(tr, frozen, key, jb, train=False),
        has_aux=True)(jax.tree.map(jnp.asarray, trainable))

    # JAX's noised design graph for this key (composite.py loss_fn's and
    # GraphDiT.loss's splits), fed to the port through the noisy seam
    _, k_design = jax.random.split(key)
    k_noise, _ = jax.random.split(k_design)
    d_idx = np.clip(batch["design_graph_index"], 0, None)
    d_valid = (batch["design_start_pos"] >= 0) & (
        batch["design_graph_index"] >= 0)
    node_mask = jnp.asarray(batch["mol_node_mask"][d_idx] & d_valid[:, None])
    X, E = jm.graph_decoder.codes_to_onehot(
        jnp.asarray(batch["mol_atoms"][d_idx]),
        jnp.asarray(batch["mol_edges"][d_idx]), node_mask)
    noised = apply_noise(k_noise, X, E, node_mask, jm.graph_decoder.schedule,
                         jm.graph_decoder.parts, train=False)
    noisy = {k: torch.from_numpy(np.array(noised[k]))
             for k in ("t", "X_t", "E_t")}

    tm = GraphLM(LLM(cfg, dtype=torch.float32),
                 GraphDiT(GraphDiTConfig(**dit),
                          build_data_info_from_smiles(corpus, max_n)),
                 torch_predictor(),
                 TorchCLIP(TorchCLIPConfig(num_layer=2, hidden_size=64)),
                 tok, {t: tok.token_to_id(t) for t in TORCH_SPECIAL_TOKENS},
                 lora_rank=4)
    tm.load_state_dict(graph_lm_state_dict(frozen, trainable))
    total, aux = tm.loss(batch, train=False, noisy=noisy)
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_total), rtol=0,
                               atol=ATOL)
    for k in ("lm_loss", "design_loss", "retro_loss"):
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=0,
                                   atol=ATOL)
    # the router term is in: lm_loss differs from the plain LM loss
    tb = tm.batch_to_device(batch)
    with torch.no_grad():
        embeds = tm._splice_molecule_embeds(
            *(tb[k] for k in ("input_ids", "mol_atoms", "mol_edges",
                              "mol_node_mask", "mol_valid", "mol_rows",
                              "mol_cols")))
        logits, _, _, moe_aux = tm.llm(
            inputs_embeds=embeds, attention_mask=tb["attention_mask"],
            return_moe_aux=True)
        plain = lm_loss(logits, tb["labels"], -100)
    np.testing.assert_allclose(
        aux["lm_loss"].item(),
        (plain + cfg.moe_aux_loss_coef * moe_aux).item(), rtol=1e-6)
    assert float(moe_aux) > 0
    want = trainable_state_dict(jax.tree.map(np.asarray, j_grads))
    got = tm.trainable_parameters()
    assert set(got) == set(want)
    assert not any(".mlp." in n for n in got)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("args", [
    {"num_experts": 4, "num_experts_per_tok": 1},
    {"num_experts": 4, "num_experts_per_tok": 2, "moe_aux_loss_coef": 0.1},
    {"moe_aux_loss_coef": 0.05},
])
def test_loader_moe_overrides_equal_jax(args):
    """num_experts / num_experts_per_tok make a from-scratch MoE config
    and moe_aux_loss_coef overrides the router weight, as in the JAX
    loader: the port's built LLM config equals the one JAX's load_llm
    builds from the same arguments (the tiny, unnamed model)."""
    from llamole_tpu.config import ModelArguments as JaxModelArguments
    from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from llamole_tpu.models.loader import load_llm
    from llamole_tpu.utils.constants import SPECIAL_TOKENS
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm

    base = {"model_name_or_path": "", "dataset": "molqa_drug_examples",
            "dataset_dir": "data", "template": "default", "cutoff_len": 96,
            "learned_query_size": 8, "output_dir": "unused",
            "finetuning_type": "lora", "lora_rank": 4}
    model_args, data_args, _, ft_args, _ = get_infer_args({**base, **args})
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    jllm, _ = load_llm(JaxModelArguments(model_name_or_path="", **args),
                       JaxByteTokenizer(SPECIAL_TOKENS),
                       jax.random.PRNGKey(0))
    assert (dataclasses.asdict(model.llm.cfg)
            == dataclasses.asdict(jllm.cfg))
    assert model.llm.cfg.num_experts == args.get("num_experts", 0)
