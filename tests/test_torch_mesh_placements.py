"""The mesh placements of ROADMAP.md Queue 1 item 9d in llamole_tpu_torch
against llamole_tpu: a quantized LLM on a mesh (int8, int4, W8A8, with
QLoRA, the int8 KV cache and ZeRO-3), the per-head q / k norms trained
under tp, and ZeRO-3 with tied embeddings.

The tiny LLM (2 layers, hidden 64, 4 heads, 2 kv heads, f32) is drawn by
JAX and carried across by weights.py; the same seeded numpy ids go
through JAX on the mesh string (conftest's virtual CPU devices, its
params placed by llm_param_pspecs or, under ZeRO-3, fsdp_param_pspecs)
and through the port on gloo ranks (parallel/dryrun.py launch, one
launch of 4 ranks on dp:2,tp:2 and one of 2 on dp:2, side by side; the
ranks' code is tests/torch_placements_worker.py), and through the port
without a mesh. Losses within 1e-5 relative, gradients within 1e-4
relative L2 per leaf, logits within 1e-5. JAX on the mesh equals JAX
without it as well (what made these placements JAX's to begin with).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params as jax_init
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu.models.gllm.quantize import \
    quantize_llm_params as jax_quantize
from llamole_tpu.parallel import mesh_from_string as jax_mesh_from_string
from llamole_tpu.parallel import shard_params as jax_shard_params
from llamole_tpu.parallel.sharding import (
    fsdp_param_pspecs as jax_fsdp_pspecs,
    llm_param_pspecs as jax_llm_pspecs)
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import lm_loss
from llamole_tpu_torch.models.gllm.quantize import quantized_bytes
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.parallel.sharding import (base_tensors,
                                                 fsdp_param_pspecs,
                                                 llm_param_pspecs, shard_llm)
from llamole_tpu_torch.weights import (_llm_path, llm_quant_of,
                                       llm_state_dict, state_dict_of)

import torch_placements_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 120            # seconds a launch of ranks may take
RANK, SCALE = 4, 2.0
REL, GRAD_REL = 1e-5, 1e-4
# (bits, act_int8, group size): group 32 splits the tiny int4 leaves into
# groups (hidden 64 -> 2, down's 128 -> 4) that divide over tp 2
SCHEMES = {"int8": (8, False, 128), "int4": (4, False, 32),
           "w8a8": (8, True, 128)}
QK = {"plain": {"qk_norm": True},
      "unit_offset": {"qk_norm": True, "rms_norm_unit_offset": True}}
TIED = {"tie_word_embeddings": True}
MESHES = {"dp:2,tp:2": 4, "dp:2": 2}


def _jcfg(**kw):
    return dataclasses.replace(JaxLLMConfig.tiny(), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(cfg, seed=0):
    """JAX's init_params in f32 with every norm scale moved off its init,
    so the norms' gradients are generic."""
    params = _np(jax_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed + 10)
    for layer in params["layers"]:
        for k in ("q_norm", "k_norm"):
            if k in layer:
                layer[k]["scale"] = (layer[k]["scale"] + 0.2 * rng.normal(
                    size=layer[k]["scale"].shape)).astype(np.float32)
    return params


def _lora(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        init_lora(jax.random.PRNGKey(seed), cfg, rank=RANK))


IDS = np.random.default_rng(3).integers(1, 500, (4, 12)).astype(np.int32)


def _cases():
    """{name: (JAX config, JAX params, JAX LoRA or None, what trains,
    ZeRO-3, the worker's case)} of every loss case."""
    out = {}
    dense = _params(_jcfg())
    lora = _lora(_jcfg())
    for scheme, (bits, a8, group) in SCHEMES.items():
        tree = _np(jax_quantize(dense, bits=bits, group_size=group,
                                act_int8=a8))
        out[f"quant-{scheme}"] = (_jcfg(), tree, lora, "lora", True)
    for name, kw in QK.items():
        out[f"qk-{name}"] = (_jcfg(**kw), _params(_jcfg(**kw)), None,
                             "qk_norm", False)
    tied = _params(_jcfg(**TIED))
    out["tied-lora"] = (_jcfg(**TIED), tied, _lora(_jcfg(**TIED)), "lora",
                        True)
    out["tied-full"] = (_jcfg(**TIED), tied, None, "full", True)
    cases = {}
    for name, (cfg, params, lora_, train, zero3) in out.items():
        kw = {k: getattr(cfg, k) for k in ("qk_norm", "rms_norm_unit_offset",
                                           "tie_word_embeddings")}
        case = {"kind": "loss", "cfg": kw, "quant": llm_quant_of(params),
                "state": llm_state_dict(params, lora_), "train": train,
                "zero3": zero3, "ids": IDS}
        if lora_ is not None:
            case.update(lora_rank=RANK, lora_scale=SCALE)
        cases[name] = (cfg, params, lora_, train, zero3, case)
    return cases


CASES = _cases()


def _unit_cases():
    """The decode case (int8 weights, int8 KV cache) and the row-parallel
    W8A8 case, whose input's largest entry of each row lies in the last
    tp rank's columns."""
    tree = CASES["quant-int8"][1]
    decode = {"kind": "decode", "cfg": {"kv_cache_dtype": "int8"},
              "quant": llm_quant_of(tree), "state": llm_state_dict(tree),
              "train": "none", "ids": IDS, "new": 8}
    rng = np.random.default_rng(9)
    w_q = torch.from_numpy(rng.integers(-127, 128, (24, 32)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.005, 0.02, 24).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 5, 32)).astype(np.float32))
    x[..., -3] = 6.0 + torch.arange(5.0)        # the row's max: rank 1's
    probe = torch.from_numpy(rng.normal(size=(3, 5, 24)).astype(np.float32))
    row = {"kind": "w8a8_row", "in": 32, "out": 24, "w_q": w_q,
           "scale": scale, "x": x, "probe": probe}
    return {"decode": decode, "w8a8-row": row}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both launches' results {mesh: {case: result}}, the ranks started
    side by side on threads while this process computes JAX's runs."""
    from concurrent.futures import ThreadPoolExecutor
    work = tmp_path_factory.mktemp("placements")
    cases = {name: c[-1] for name, c in CASES.items()}
    jobs = {"dp:2,tp:2": {**cases, **_unit_cases()},
            "dp:2": {k: v for k, v in cases.items()
                     if k.startswith("tied") or k == "quant-int8"}}

    def go(spec):
        tag = spec.replace(":", "").replace(",", "_")
        torch.save(jobs[spec], work / f"{tag}.cases.pt")
        dryrun.launch("torch_placements_worker:run", MESHES[spec], {
            "cases": str(work / f"{tag}.cases.pt"), "mesh": spec,
            "out": str(work / f"{tag}.out.pt")},
            timeout=LIMIT, workdir=str(work / tag), path=[HERE])
        return torch.load(work / f"{tag}.out.pt", weights_only=False)

    pool = ThreadPoolExecutor(len(MESHES))
    futures = {spec: pool.submit(go, spec) for spec in MESHES}
    yield futures
    pool.shutdown(wait=True)


def _results(launched, spec):
    return launched[spec].result()


def _jax(name, spec=None):
    """(loss, logits, {port name: gradient}) of JAX's run of a loss case,
    on the mesh string `spec` (its params placed by fsdp_param_pspecs
    under ZeRO-3, llm_param_pspecs otherwise) or without a mesh."""
    cfg, params, lora, train, zero3, _ = CASES[name]
    ids = jnp.asarray(IDS)

    def loss(p, lo):
        logits = jax_forward(p, cfg, input_ids=ids, lora=lo,
                             lora_scale=SCALE)[0]
        return jax_lm_loss(logits, ids), logits

    argnum = 1 if train == "lora" else 0
    f = jax.jit(jax.value_and_grad(loss, argnums=argnum, has_aux=True))
    if spec is None:
        (value, logits), grads = f(params, lora)
    else:
        mesh = jax_mesh_from_string(spec)
        specs = (jax_fsdp_pspecs(params, dp=2, tp_axis="tp") if zero3
                 else jax_llm_pspecs(params))
        with jax.set_mesh(mesh):
            (value, logits), grads = f(jax_shard_params(params, mesh, specs),
                                       lora)
    grads = _np(grads)
    named = (state_dict_of(grads["layers"], "layers.") if train == "lora"
             else llm_state_dict(grads))
    return float(value), np.asarray(logits), named


def _mesh_less(name):
    """The port's run of a loss case without a mesh."""
    case = CASES[name][-1]
    llm = worker.build(case)
    ids = torch.as_tensor(case["ids"]).long()
    logits = llm(input_ids=ids)[0]
    loss = lm_loss(logits, ids)
    loss.backward()
    return float(loss.detach()), logits.detach().numpy(), {
        n: p.grad for n, p in llm.named_parameters() if p.requires_grad}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _assert_run(got, want, what):
    """got: the port's result {loss, logits, grads}; want: (loss, logits,
    grads) of JAX or of the mesh-less port."""
    loss, logits, grads = want
    np.testing.assert_allclose(got["loss"], loss, rtol=REL, err_msg=what)
    np.testing.assert_allclose(np.asarray(got["logits"]), logits,
                               rtol=REL, atol=REL, err_msg=what)
    assert set(got["grads"]) == set(grads), what
    for n, g in grads.items():
        assert _rel_l2(got["grads"][n], np.asarray(g)) < GRAD_REL, (what, n)


def _jax_keys(name):
    """A port base tensor's name -> its JAX key path (JAX's quantized
    leaf names: w_q, w_qa or w_q4 by scheme)."""
    return _llm_path(name)[0]


def _flat_specs(tree):
    """{JAX key path with w_qa / w_q4 read as w_q: spec} of a spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        keys[-1] = "w_q" if keys[-1] in ("w_qa", "w_q4") else keys[-1]
        out[tuple(keys)] = tuple(spec)
    return out


# -- the quantized LLM -----------------------------------------------------------

@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_quantized_specs_equal_jax(scheme):
    """llm_param_pspecs and fsdp_param_pspecs (dp 2 beside tp) of the
    port's quantized base, buffers included, equal JAX's on its tree,
    spec for spec (int4's packed w_q read as JAX's [in, out])."""
    _, tree, _, _, _, case = CASES[f"quant-{scheme}"]
    llm = worker.build(case)
    base = base_tensors(llm)
    assert any(n.endswith(".w_q") for n in base)
    want_tp = _flat_specs(jax_llm_pspecs(tree))
    want_dp = _flat_specs(jax_fsdp_pspecs(tree, dp=2, tp_axis="tp"))
    got_tp = llm_param_pspecs(base)
    got_dp = fsdp_param_pspecs(base, 2, tp_axis="tp")
    assert len(base) == len(want_tp)
    for n in base:
        key = tuple(_jax_keys(n))
        assert got_tp[n] == want_tp[key], (n, got_tp[n], want_tp[key])
        assert got_dp[n] == want_dp[key], (n, got_dp[n], want_dp[key])


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_quantized_qlora_on_dp2_tp2_equals_jax(launched, scheme):
    """The quantized LLM with a LoRA adapter under ZeRO-3 on dp:2,tp:2
    (each rank keeping its tp shards' dp chunks of w_q / scale, the
    row-parallel W8A8 amax a MAX over tp): the QLoRA loss, the logits and
    the LoRA gradients equal JAX's on the same mesh string and the
    mesh-less port's; JAX's mesh run equals its mesh-less one."""
    name = f"quant-{scheme}"
    got = _results(launched, "dp:2,tp:2")[name]
    want = _jax(name, "dp:2,tp:2")
    _assert_run(got, want, f"{name} vs JAX")
    _assert_run(got, _mesh_less(name), f"{name} vs mesh-less")
    plain = _jax(name)
    np.testing.assert_allclose(want[0], plain[0], rtol=REL)
    # every quantized projection keeps dp chunks (JAX's fsdp specs give
    # each w_q a dp dimension)
    assert len(got["zero"]) == 2 * 7 + 1


def test_w8a8_row_amax_is_the_max_over_tp(launched):
    """A row-parallel W8A8 projection on tp 2 whose rows' largest input
    lies in rank 1's columns: with the amax a MAX over tp the output and
    the input's gradient (through the amax) equal the mesh-less
    projection's; each rank's own amax would miss them."""
    got = _results(launched, "dp:2,tp:2")["w8a8-row"]
    case = _unit_cases()["w8a8-row"]
    from llamole_tpu_torch.models.gllm.lora import LoRALinear
    proj = LoRALinear(32, 24, False)
    proj.set_quantized_("w8a8", case["w_q"], case["scale"])
    x = case["x"].clone().requires_grad_(True)
    y = proj(x)
    (y * case["probe"]).sum().backward()
    np.testing.assert_allclose(got["y"].numpy(), y.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["x_grad"].numpy(), x.grad.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert x.grad[..., -3].abs().min() > 0      # the max's own gradient
    gap = float((got["own_amax"] - y.detach()).abs().max())
    assert gap > 100 * float(y.detach().abs().max()) * 1e-6, gap


def test_int4_group_misalignment_raises_as_jax():
    """A row-parallel int4 projection whose in / tp is not a multiple of
    the group size (group 128 over the tiny LLM: one scale group) cannot
    split its scale groups over tp: the port refuses with the words of
    JAX's placement error on the same leaf shape."""
    import types
    dense = _params(_jcfg())
    tree = _np(jax_quantize(dense, bits=4, group_size=128))
    mesh = jax_mesh_from_string("dp:2,tp:2")
    with pytest.raises(ValueError) as jax_err:
        jax_shard_params(tree, mesh, jax_llm_pspecs(tree))
    llm = LLM(LLMConfig.tiny(), dtype=torch.float32,
              quant=llm_quant_of(tree))
    llm.load_state_dict(llm_state_dict(tree))
    with pytest.raises(ValueError) as err:
        shard_llm(llm, types.SimpleNamespace(tp=2, ep=1))
    tail = str(jax_err.value).split("which ")[-1]
    assert tail.startswith("implies that the global size of its dimension 0")
    assert str(err.value).endswith(tail), (str(err.value), tail)


def test_int8_kv_decode_on_tp_equals_mesh_less(launched):
    """The int8 LLM with the int8 KV cache (KV / tp heads and their
    scales on each rank) placed on tp 2 decodes greedily, eagerly: its
    tokens equal the mesh-less decode's."""
    got = _results(launched, "dp:2,tp:2")["decode"]
    case = _unit_cases()["decode"]
    llm = worker.build(case)
    ids = torch.as_tensor(case["ids"]).long()
    want, done = llm.generate(ids, torch.ones_like(ids), max_new_tokens=8,
                              do_sample=False, spec_tokens=0)
    assert torch.equal(got["tokens"], want)
    assert torch.equal(got["done"], done)


def test_zero3_quantized_local_bytes(launched):
    """ZeRO-3 of the int8 LLM: each rank's local bytes (quantized_bytes
    of the placed LLM) are each leaf's bytes over the ranks JAX's
    fsdp_param_pspecs splits it across, about 1/dp of the mesh-less
    quantized_bytes on dp:2 and 1/(dp tp) on dp:2,tp:2 (the per-channel
    scales and the norms stay whole, as in JAX)."""
    llm = worker.build(CASES["quant-int8"][-1])
    total = quantized_bytes(llm)
    base = base_tensors(llm)
    for spec, sizes in (("dp:2", {"dp": 2}), ("dp:2,tp:2", {"dp": 2,
                                                            "tp": 2})):
        specs = fsdp_param_pspecs(base, 2, tp_axis="tp")
        want = sum(t.numel() * t.element_size()
                   // int(np.prod([sizes.get(a, 1) for a in specs[n] if a]))
                   for n, t in base.items())
        before, placed, zero = _results(launched, spec)["quant-int8"]["bytes"]
        assert before == total
        assert zero == want, (spec, zero, want)
        share = int(np.prod(list(sizes.values())))
        assert abs(zero * share / total - 1) < 0.1, (spec, zero, total)
        assert zero < placed


# -- the q / k norms under tp ------------------------------------------------------

@pytest.mark.parametrize("kind", list(QK))
def test_qk_norm_gradients_under_tp_equal_jax(launched, kind):
    """The per-head q / k norms (qwen3's plain ones, gemma-3's unit
    offset) trained under tp 2 on dp:2,tp:2: their one scale enters each
    rank's heads through to_tp, so its gradient sums over tp; loss,
    logits and the norms' gradients equal JAX's on the mesh and the
    mesh-less port's."""
    name = f"qk-{kind}"
    got = _results(launched, "dp:2,tp:2")[name]
    want = _jax(name, "dp:2,tp:2")
    want = (want[0], want[1], {n: g for n, g in want[2].items()
                               if "q_norm" in n or "k_norm" in n})
    assert len(want[2]) == 4
    _assert_run(got, want, f"{name} vs JAX")
    _assert_run(got, _mesh_less(name), f"{name} vs mesh-less")
    np.testing.assert_allclose(want[0], _jax(name)[0], rtol=REL)


# -- ZeRO-3 with tied embeddings --------------------------------------------------

@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("train", ["lora", "full"])
def test_tied_zero3_equals_jax(launched, spec, train):
    """ZeRO-3 of a tied-embedding LLM: with LoRA the frozen embedding is
    split over dp and the head reads it gathered (LLM.tied_zero); fully
    finetuned it trains outside FSDP. Loss, logits and gradients equal
    JAX's fsdp_param_pspecs run ((tp, dp) on the tied [V, H]) and the
    mesh-less port's."""
    name = f"tied-{train}"
    got = _results(launched, spec)[name]
    assert got["tied_zero"] == (train == "lora")
    want = _jax(name, spec)
    _assert_run(got, want, f"{name} on {spec} vs JAX")
    _assert_run(got, _mesh_less(name), f"{name} on {spec} vs mesh-less")
    np.testing.assert_allclose(want[0], _jax(name)[0], rtol=REL)
