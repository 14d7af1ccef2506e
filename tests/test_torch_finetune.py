"""DoRA and PiSSA adapters in llamole_tpu_torch against llamole_tpu (f32,
CPU).

The JAX package's params and adapters reach the port through
llamole_tpu_torch.weights; tokens come from seeded numpy. PiSSA's factors
come from an SVD whose singular-vector signs differ between torch and
jnp, so A and B are compared up to a sign per rank, and everything that
does not depend on those signs (A B, the residual, DoRA's magnitudes,
logits, losses) exactly as JAX gives it. The principal rank-4 part of a
random 64 x 64 matrix is ill-posed in f32 (sigma_4 / sigma_5 is about
1.02: JAX's own SVD lands 1.3e-5 from the f64 truth), so the weights
PiSSA factors carry a planted rank-4 part with separated singular values
(`_plant`), as trained weights have.
"""

import os
import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from llamole_tpu.models.composite import GraphLM as JaxGraphLM
from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.lora import dora_init as jax_dora_init
from llamole_tpu.models.gllm.lora import merge_lora as jax_merge_lora
from llamole_tpu.models.gllm.lora import pissa_init as jax_pissa_init
from llamole_tpu.models.gllm.lora import pissa_to_lora as jax_pissa_to_lora
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.models.graphclip.model import GraphCLIP, GraphCLIPConfig
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.loader import make_fallback_predictor
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu.utils.serialization import load_pytree as jax_load
from llamole_tpu_torch.config import get_train_args
from llamole_tpu_torch.data.collator import SeqGraphCollator
from llamole_tpu_torch.data.loader import get_dataset
from llamole_tpu_torch.data.tokenizer import ByteTokenizer
from llamole_tpu_torch.models.composite import GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.lora import (dora_init_, dora_product,
                                                dora_weight, merge_lora,
                                                pissa_init_)
from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
from llamole_tpu_torch.models.graphclip import (
    GraphCLIPConfig as TorchCLIPConfig)
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import build_graph_lm
from llamole_tpu_torch.models.loader import (
    make_fallback_predictor as torch_predictor)
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.weights import (graph_lm_state_dict, llm_state_dict,
                                       state_dict_of, trainable_state_dict)
from tests.test_torch_train import (CORPUS, DIT, MAX_N, ROOT, TINY,
                                    _design_draw, _open)

RANK = 4
SCALE = 2.0          # lora_scale(4): alpha 2r / r
TOL = 1e-5           # max |port - JAX| relative to max |JAX|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plant(llm_params, seed=11):
    """Each projection's w [in, out] plus U diag(8, 6, 4, 3) V^T (random
    orthonormal U, V): a spectrum whose top 4 stand apart (the random
    part's largest singular value is about 2)."""
    rng = np.random.default_rng(seed)
    for layer in llm_params["layers"]:
        for group in ("attn", "mlp"):
            for leaf in layer[group].values():
                i, o = leaf["w"].shape
                u = np.linalg.qr(rng.normal(size=(i, RANK)))[0]
                v = np.linalg.qr(rng.normal(size=(o, RANK)))[0]
                leaf["w"] = (leaf["w"] + (u * [8.0, 6.0, 4.0, 3.0]) @ v.T
                             ).astype(np.float32)
    return llm_params


def _llm_pair(lora_scale_b=0.05):
    """JAX params (planted), a random JAX adapter (B nonzero) and the
    port's LLM holding both."""
    jcfg = JaxLLMConfig.tiny()
    params = _plant(jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32)))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32)
        * lora_scale_b, init_lora(jax.random.PRNGKey(2), jcfg, rank=RANK))
    model = LLM(LLMConfig.tiny(), dtype=torch.float32)
    model.add_lora(RANK, SCALE)
    model.load_state_dict(llm_state_dict(params, lora))
    return jcfg, params, lora, model


def _adapted(llm):
    return {n: m for n, m in llm.named_modules()
            if getattr(m, "lora_a", None) is not None}


def _tokens(b=2, s=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0
    return ids, mask


def _port_leaf(tree, name):
    """The JAX adapter leaf of a port projection name ("layers.0.attn.q")."""
    _, i, group, proj = name.split(".")
    return tree["layers"][int(i)][group][proj]


@pytest.mark.parametrize("scale", [0.0, SCALE])
def test_dora_init_matches_jax(scale):
    """DoRA's m: the norm over the inputs of W (+ scale * A B), within
    1e-6 of JAX dora_init's."""
    _, params, lora, model = _llm_pair()
    want = jax_dora_init(params, lora, scale)
    dora_init_(_adapted(model).values(), scale)
    for name, m in _adapted(model).items():
        assert _rel(m.lora_m, _port_leaf(want, name)["m"]) < 1e-6, name


def test_pissa_init_matches_jax():
    """PiSSA: A B and the residual within 1e-5 of JAX pissa_init's; A and
    B equal JAX's up to one sign per rank."""
    _, params, lora, model = _llm_pair()
    residual, want = jax_pissa_init(params, lora, SCALE)
    pissa_init_(_adapted(model).values(), SCALE)
    for name, m in _adapted(model).items():
        leaf = _port_leaf(want, name)
        ab = (m.lora_b @ m.lora_a).t()                 # JAX a @ b
        assert _rel(ab, np.asarray(leaf["a"]) @ np.asarray(leaf["b"])) < TOL
        base = _port_leaf(residual, name)
        assert _rel(m.weight.t(), base["w"]) < TOL, name
        a, b = m.lora_a.detach().numpy().T, m.lora_b.detach().numpy().T
        signs = np.sign(np.sum(a * np.asarray(leaf["a"]), axis=0))
        assert set(np.abs(signs)) == {1.0}
        assert _rel(a * signs, leaf["a"]) < 1e-4, name
        assert _rel(b * signs[:, None], leaf["b"]) < 1e-4, name


def _dora_pair():
    """A JAX DoRA adapter moved off its init (so every term matters) and
    the port's LLM holding it."""
    jcfg, params, lora, _ = _llm_pair()
    rng = np.random.default_rng(4)
    lora = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.05,
        jax.tree.map(np.asarray, jax_dora_init(params, lora, 0.0)))
    model = LLM(LLMConfig.tiny(), dtype=torch.float32)
    model.add_lora(RANK, SCALE)
    for m in _adapted(model).values():
        m.add_magnitude()
    model.load_state_dict(llm_state_dict(params, lora))
    return jcfg, params, lora, model


def test_dora_forward_and_gradients_match_jax():
    """The DoRA forward's logits, and the gradients of a weighted sum of
    them w.r.t. every a, b and m, against JAX's forward and jax.grad."""
    jcfg, params, lora, model = _dora_pair()
    ids, mask = _tokens()
    w = np.random.default_rng(5).normal(size=(2, 12, 512)).astype(np.float32)

    def loss(lr):
        logits, _, _ = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask), lora=lr,
                                   lora_scale=SCALE, train=True)
        return jnp.sum(logits * w), logits

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, lora))
    got, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask), train=True)
    assert _rel(got, want) < TOL
    (got * torch.from_numpy(w)).sum().backward()
    want_g = state_dict_of(jax.tree.map(np.asarray, grads["layers"]),
                           "layers.")
    for name, p in model.named_parameters():
        if "lora_" in name:
            assert _rel(p.grad, want_g[name]) < 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dora_backward_equals_plain_autograd(dtype):
    """The recomputing backward against autograd through dora_weight and
    F.linear on the same inputs (x, W in `dtype`; factors f32)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 24, generator=g).to(dtype).requires_grad_()
    w = torch.randn(16, 24, generator=g).to(dtype)
    a, b = (torch.randn(*s, generator=g).requires_grad_()
            for s in ((4, 24), (16, 4)))
    m = (torch.rand(16, generator=g) + 0.5).requires_grad_()
    gy = torch.randn(3, 5, 16, generator=g).to(dtype)
    y = dora_product(x, w, a, b, m, 0.5)
    got = torch.autograd.grad(y, (x, a, b, m), gy)
    plain = torch.nn.functional.linear(
        x, dora_weight(w, a, b, m, 0.5).to(dtype))
    want = torch.autograd.grad(plain, (x, a, b, m), gy)
    assert torch.equal(y, plain)
    for t, u in zip(got, want):
        assert _rel(t, u) < 1e-5


def test_merge_lora_with_dora_matches_jax():
    """merge_lora folds a DoRA adapter as JAX's does (the magnitude-scaled
    direction), and the merged LLM's logits equal the adapter's."""
    jcfg, params, lora, model = _dora_pair()
    ids, mask = (torch.from_numpy(a) for a in _tokens())
    with torch.no_grad():
        before, _, _ = model(input_ids=ids.long(), attention_mask=mask)
    assert merge_lora(model) == 14
    merged = jax_merge_lora(params, lora, SCALE)
    for name, mod in _adapted_all(model).items():
        assert _rel(mod.weight.t(), _port_leaf(merged, name)["w"]) < 1e-6
        assert mod.lora_m is None
    with torch.no_grad():
        after, _, _ = model(input_ids=ids.long(), attention_mask=mask)
    assert _rel(after, before) < 1e-4


def _adapted_all(llm):
    return {n: m for n, m in llm.named_modules()
            if n.count(".") == 3 and hasattr(m, "lora_m")}


def test_pissa_to_lora_matches_jax():
    """The rank-2r export of a trained PiSSA + DoRA adapter equals JAX
    pissa_to_lora's, and over the original weights it gives the residual
    model's logits."""
    jcfg, params, lora, _ = _llm_pair()
    from llamole_tpu_torch.models.gllm.lora import pissa_to_lora
    residual, init = jax_pissa_init(params, lora, SCALE)
    init = jax.tree.map(np.asarray, jax_dora_init(residual, init, SCALE))
    rng = np.random.default_rng(6)
    trained = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.03,
        init)
    want = jax.tree.map(np.asarray, jax_pissa_to_lora(trained, init))
    got = {}
    for name in _adapted(_llm_pair()[3]):
        t, i = _port_leaf(trained, name), _port_leaf(init, name)
        a, b = pissa_to_lora(*(torch.from_numpy(np.asarray(x)).t()
                               for x in (t["a"], t["b"], i["a"], i["b"])))
        w = _port_leaf(want, name)
        assert _rel(a.t(), w["a"]) == 0 and _rel(b.t(), w["b"]) == 0
        got[name] = (a, b)
    ids, mask = _tokens()
    want_logits, _, _ = jax_forward(
        jax.tree.map(np.asarray, residual), jcfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), lora=trained, lora_scale=SCALE)
    model = LLM(LLMConfig.tiny(), dtype=torch.float32)
    model.add_lora(2 * RANK, SCALE)
    for m in _adapted(model).values():
        m.add_magnitude()
    model.load_state_dict(llm_state_dict(params, want))
    with torch.no_grad():
        logits, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                             attention_mask=torch.from_numpy(mask))
    assert _rel(logits, want_logits) < 1e-4


# -- the composite: PiSSA + DoRA through GraphLM -------------------------------

def _jax_graph_lm(tok):
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    return JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**DIT),
                                  jax_data_info(CORPUS, MAX_N)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=RANK,
        finetuning_type="lora", use_dora=True, pissa=True)


def _port_graph_lm(frozen, trainable):
    """The port's GraphLM (use_dora, pissa) holding JAX's ORIGINAL frozen
    modules and connectors (its adapter is overwritten by the PiSSA init
    that follows)."""
    tok = ByteTokenizer(TORCH_SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in TORCH_SPECIAL_TOKENS}
    tm = GraphLM(LLM(LLMConfig.tiny(), dtype=torch.float32),
                 GraphDiT(GraphDiTConfig(**DIT),
                          build_data_info_from_smiles(CORPUS, MAX_N)),
                 torch_predictor(),
                 TorchCLIP(TorchCLIPConfig(num_layer=2, hidden_size=64)),
                 tok, ids, lora_rank=RANK, use_dora=True, pissa=True)
    plain = jax.tree.map(lambda a: a, trainable["lora"])
    for layer in plain["layers"]:
        for group in layer.values():
            for leaf in group.values():
                leaf.pop("m", None)
    tm.load_state_dict(graph_lm_state_dict(
        frozen, {"connectors": trainable["connectors"], "lora": plain}))
    tm.init_pissa_dora()
    return tm


@pytest.fixture(scope="module")
def composite():
    tok = JaxByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    jm = _jax_graph_lm(tok)
    frozen = jm.init_frozen(jax.random.PRNGKey(0))
    frozen = {k: (_open(v, 2) if k != "llm"
                  else _plant(jax.tree.map(np.asarray, v)))
              for k, v in frozen.items()}
    original = jax.tree.map(np.asarray, frozen["llm"])
    trainable = jm.init_trainable(jax.random.PRNGKey(1), frozen)
    trainable = jax.tree.map(np.asarray, trainable)
    residual = frozen
    data_args = types.SimpleNamespace(
        dataset="molqa_train_examples",
        dataset_dir=os.path.join(ROOT, "data"),
        max_samples=None, template="default", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    ptok = ByteTokenizer(TORCH_SPECIAL_TOKENS)
    bank, inputs = get_dataset(None, data_args, None, ptok)
    batch = SeqGraphCollator(tokenizer=ptok, mol_id_to_graph=bank,
                             max_len=768, max_nodes=MAX_N, max_graphs=16,
                             max_retro=16)(inputs[:2])
    port_frozen = dict(residual, llm=original)
    return jm, residual, trainable, port_frozen, batch


def test_graph_lm_pissa_dora_matches_jax(composite):
    """GraphLM built with DoRA + PiSSA over JAX's original weights: the
    residual base, A B and m as JAX's init_trainable leaves them, and
    loss(train=False) with its three terms within 1e-5 of JAX's loss_fn,
    with the gradients of m and the connectors (sign-free) within 1e-4."""
    jm, frozen, trainable, port_frozen, batch = composite
    tm = _port_graph_lm(port_frozen, trainable)
    res = jax.tree.map(np.asarray, frozen["llm"])
    for name, m in _adapted(tm.llm).items():
        leaf = _port_leaf(trainable["lora"], name)
        assert _rel(m.weight.t(), _port_leaf(res, name)["w"]) < TOL
        assert _rel((m.lora_b @ m.lora_a).t(), leaf["a"] @ leaf["b"]) < TOL
        assert _rel(m.lora_m, leaf["m"]) < TOL, name
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_total, j_aux), j_grads = jax.value_and_grad(
        lambda tr: jm.loss_fn(tr, frozen, key, jb, train=False),
        has_aux=True)(jax.tree.map(jnp.asarray, trainable))
    total, aux = tm.loss(batch, train=False,
                         noisy=_design_draw(jm, batch, key))
    total.backward()
    assert abs(total.item() - float(j_total)) <= TOL * abs(float(j_total))
    for k in ("lm_loss", "design_loss", "retro_loss"):
        assert abs(aux[k].item() - float(j_aux[k])) <= TOL * abs(
            float(j_aux[k])), k
    want = trainable_state_dict(jax.tree.map(np.asarray, j_grads))
    got = tm.trainable_parameters()
    assert set(got) == set(want)
    for name, p in got.items():
        if "lora_a" not in name and "lora_b" not in name:
            assert _rel(p.grad, want[name]) < 1e-4, name


def test_pissa_export_reloads_in_both_packages(composite, tmp_path):
    """save_pretrained of a trained PiSSA + DoRA GraphLM writes the rank-2r
    adapter (with m); reloaded through load_trainable onto a model of the
    ORIGINAL weights its LLM's logits equal the residual model's, and JAX
    reads the same files into the same logits."""
    jm, frozen, trainable, port_frozen, batch = composite
    tm = _port_graph_lm(port_frozen, trainable)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():                      # "trained"
        for name, p in tm.trainable_parameters().items():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    tm.save_pretrained(str(tmp_path))
    adapter = jax_load(str(tmp_path / "adapter.msgpack"))
    q = adapter["layers"][0]["attn"]["q"]
    assert q["a"].shape == (64, 2 * RANK) and q["m"].shape == (64,)

    ids, mask = (torch.from_numpy(a) for a in _tokens())
    with torch.no_grad():
        want, _, _ = tm.llm(input_ids=ids.long(), attention_mask=mask)
    fresh = _port_graph_lm(port_frozen, trainable)
    with torch.no_grad():
        for name, m in _adapted(fresh.llm).items():    # the original base
            m.weight.copy_(torch.from_numpy(np.asarray(
                _port_leaf(port_frozen["llm"], name)["w"])).t())
    fresh._pissa_init = None
    fresh.load_trainable(str(tmp_path))
    assert fresh.llm.layers[0].attn["q"].lora_a.shape == (2 * RANK, 64)
    with torch.no_grad():
        got, _, _ = fresh.llm(input_ids=ids.long(), attention_mask=mask)
    assert _rel(got, want) < 1e-4

    bundle = jm.load_trainable(str(tmp_path))
    j_logits, _, _ = jax_forward(
        jax.tree.map(jnp.asarray, port_frozen["llm"]), jm.llm.cfg,
        input_ids=jnp.asarray(ids.numpy()),
        attention_mask=jnp.asarray(mask.numpy()), lora=bundle["lora"],
        lora_scale=jm.lora_scale)
    assert _rel(want, j_logits) < 1e-4


@pytest.mark.parametrize("flag", ["use_dora", "pissa_init"])
def test_dora_and_pissa_over_int8_raise(flag, tmp_path):
    """Over a quantized (int8) base DoRA and PiSSA raise, as JAX's do."""
    model_args, data_args, _, ft, _ = get_train_args(TINY)
    model_args = replace(model_args, quantization_bit=8)
    ft = replace(ft, **{flag: True})
    with pytest.raises(ValueError, match="full-precision"):
        build_graph_lm(model_args, data_args, ft, device="cpu")
