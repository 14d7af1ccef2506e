"""llamole_tpu_torch's quantized LLM (gllm/quantize.py, gllm/lora.py)
against llamole_tpu's gllm quantize / _proj, on the tiny f32 config (CPU).

JAX trees (dense and quantized, list and stacked) reach the port through
llamole_tpu_torch.weights; activations and tokens come from seeded numpy.
Tolerances, each stated where it is used: the quantizers and the bridge
bit for bit; W8A8's activation codes, scales and int32 accumulator exactly;
projections within 1e-5 (f32, tests/test_quantize.py's bound); greedy
tokens exactly; LoRA gradients over an int8 base within 1e-4 (as
test_torch_llm.py's dense ones); init statistics within 5% of the std the
scale is drawn for.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.model import _proj
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu.models.gllm.quantize import (_quantize_leaf, _quantize_leaf4,
                                              _relabel_a8,
                                              init_params_quantized)
from llamole_tpu.models.gllm.quantize import \
    quantize_llm_params as jax_quantize
from llamole_tpu.models.gllm.quantize import \
    quantized_bytes as jax_quantized_bytes
from llamole_tpu.models.gllm.stacked import stack_layers
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.lora import (LoRALinear, merge_lora,
                                                quantize_activations,
                                                unpack_int4)
from llamole_tpu_torch.models.gllm.model import lm_loss
from llamole_tpu_torch.models.gllm.quantize import (init_quantized_,
                                                    llm_quant, quant_scheme,
                                                    quantize_llm_params,
                                                    quantized_bytes)
from llamole_tpu_torch.ops.nn import int8_matmul
from llamole_tpu_torch.weights import (llm_quant_of, llm_state_dict,
                                       state_dict_of)

RANK, SCALE = 4, 2.0
# (bits, act_int8, group_size): group 32 makes the tiny int4 leaves
# grouped (hidden 64 -> 2 groups, the down projection's 128 -> 4)
SCHEMES = {"int8": (8, False, 128), "w8a8": (8, True, 128),
           "int4": (4, False, 32)}


@pytest.fixture(scope="module")
def dense():
    """(JAX cfg, dense f32 params, random LoRA) as numpy trees."""
    jcfg = JaxLLMConfig.tiny()
    params = jax.tree.map(np.asarray, JaxLLM(jcfg, jnp.float32).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(   # random B too, so the adapter changes outputs
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), jcfg, rank=RANK))
    return jcfg, params, lora


def _jax_quantized(params, scheme, stacked=False):
    bits, a8, group = SCHEMES[scheme]
    tree = stack_layers(params) if stacked else params
    return jax.tree.map(np.asarray, jax_quantize(tree, bits=bits,
                                                 group_size=group,
                                                 act_int8=a8))


def _port_quantized(params, scheme, lora=None, cfg=None):
    """The port's LLM with the dense JAX weights, quantized in place."""
    bits, a8, group = SCHEMES[scheme]
    llm = LLM(cfg or LLMConfig.tiny(), dtype=torch.float32)
    if lora is not None:
        llm.add_lora(RANK, SCALE)
    llm.load_state_dict(llm_state_dict(params, lora))
    return quantize_llm_params(llm, bits=bits, group_size=group,
                               act_int8=a8)


def _port_from_tree(qparams, lora=None, cfg=None):
    """The port's LLM built quantized and filled from a JAX quantized
    tree through the bridge."""
    llm = LLM(cfg or LLMConfig.tiny(), dtype=torch.float32,
              quant=llm_quant_of(qparams))
    if lora is not None:
        llm.add_lora(RANK, SCALE)
    llm.load_state_dict(llm_state_dict(qparams, lora))
    return llm


@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_quantized_leaves_equal_jax_bit_for_bit(dense, scheme, stacked):
    """The port's in-place quantization gives JAX quantize_llm_params'
    values and scales bit for bit (int4 unpacked to its values), in both
    JAX layouts: the list tree and the stacked one init_params_quantized
    uses, read through the bridge."""
    _, params, _ = dense
    want_tree = _jax_quantized(params, scheme, stacked)
    want = llm_state_dict(want_tree)
    got = _port_quantized(params, scheme).state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    bits, a8, group = SCHEMES[scheme]
    assert llm_quant_of(want_tree) == llm_quant(quant_scheme(bits, a8),
                                                group)
    leaf_key = {"int8": "w_q", "w8a8": "w_qa", "int4": "w_q4"}[scheme]
    layer = (jax.tree.map(lambda a: a[0], want_tree["layers_stacked"])
             if stacked else want_tree["layers"][0])
    values = np.asarray(layer["mlp"]["down"][leaf_key]).astype(np.int8)
    port_q = got["layers.0.mlp.down.w_q"]
    if scheme == "int4":
        port_q = unpack_int4(port_q)
        assert layer["mlp"]["down"]["scale"].shape == (4, 64)
    np.testing.assert_array_equal(port_q.T.numpy(), values)


def test_init_quantized_matches_init_params_quantized_structure():
    """init_quantized_ against JAX init_params_quantized (stacked): the same
    leaves, shapes and dtypes through the bridge; values in their ranges;
    the dequantized weights' std within 5% of in_dim**-0.5 (the scales'
    purpose) for both; embeddings N(0, 0.02); norms 1. A quantized build
    holds no dense projection weight at all."""
    cfg = LLMConfig.tiny()
    for scheme, (bits, a8, group) in SCHEMES.items():
        jtree = jax.tree.map(np.asarray, init_params_quantized(
            jax.random.PRNGKey(0), JaxLLMConfig.tiny(), dtype=jnp.float32,
            bits=bits, group_size=group, act_int8=a8))
        want = llm_state_dict(jtree)
        llm = LLM(cfg, dtype=torch.float32,
                  quant=llm_quant(quant_scheme(bits, a8), group))
        assert not [n for n, _ in llm.named_parameters()
                    if n.endswith(("attn.q.weight", "mlp.down.weight",
                                   "lm_head.weight"))]
        init_quantized_(llm, torch.Generator().manual_seed(0), bits=bits,
                        group_size=group, act_int8=a8)
        got = llm.state_dict()
        assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
            n: (tuple(t.shape), t.dtype) for n, t in want.items()}, scheme
        for state in (got, want):
            q = state["layers.0.mlp.gate.w_q"]
            s = state["layers.0.mlp.gate.scale"]
            if scheme == "int4":
                q = unpack_int4(q)
                assert int(q.min()) == -7 and int(q.max()) == 7
                deq = q.float() * s[0][:, None]
            else:
                assert int(q.min()) == -127 and int(q.max()) == 127
                deq = q.float() * s[:, None]
            np.testing.assert_allclose(deq.std().item(), 64 ** -0.5,
                                       rtol=0.05, err_msg=scheme)
            np.testing.assert_allclose(state["embed.weight"].std().item(),
                                       0.02, rtol=0.05)
            assert torch.all(state["final_norm.weight"] == 1)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_projection_with_lora_matches_jax_proj(scheme):
    """One projection with its adapter (the QLoRA overlay) against JAX
    _proj on the same leaf and inputs: within 1e-5 in f32 (int4: JAX
    contracts per group and scales after, the port dequantizes first)."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    a = (rng.normal(size=(64, RANK)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(RANK, 48)) * 0.1).astype(np.float32)
    if scheme == "int4":
        leaf = _quantize_leaf4({"w": jnp.asarray(w)}, group_size=16)
    else:
        leaf = _quantize_leaf({"w": jnp.asarray(w)})
        if scheme == "w8a8":
            leaf = _relabel_a8(leaf)
    leaf = jax.tree.map(np.asarray, leaf)
    want = _proj(leaf, jnp.asarray(x), {"a": a, "b": b}, SCALE)
    proj = LoRALinear(64, 48, False)
    state = state_dict_of(leaf)
    proj.set_quantized_(scheme, state["w_q"], state["scale"])
    proj.add_lora(RANK, SCALE)
    proj.load_state_dict({**state, **state_dict_of({"a": a, "b": b})})
    with torch.no_grad():
        got = proj(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_w8a8_codes_scales_and_int32_accumulator_equal_jax():
    """W8A8's activation codes and scales are JAX's formula bit for bit
    (amax floored at 1e-6, then / 127), and torch._int_mm's int32
    accumulator equals JAX's s8 x s8 -> s32 dot exactly."""
    rng = np.random.default_rng(8)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0                     # an all-zero row: the floor applies
    leaf = jax.tree.map(np.asarray, _relabel_a8(_quantize_leaf(
        {"w": jnp.asarray(w)})))
    xs = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-6) / np.float32(127)
    x8 = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(x8), jnp.asarray(leaf["w_qa"]),
                               (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got8, got_s = quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(got8.numpy(), x8)
    np.testing.assert_array_equal(got_s.numpy(), xs)
    w_q = torch.from_numpy(np.array(leaf["w_qa"])).T.contiguous()
    y32 = int8_matmul(got8.reshape(-1, 64), w_q.t())
    assert y32.dtype == torch.int32
    np.testing.assert_array_equal(y32.reshape(3, 7, 48).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (8, 60, 20), (40, 13, 7)])
def test_int8_matmul_pads_to_the_cuda_shape_rules(m, k, n):
    """Rows padded past 16, K and N to multiples of 8, then cut: the
    result equals the exact integer product; one count per call."""
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    before = int8_matmul.launches
    got = int8_matmul(a, b.t())
    assert int8_matmul.launches == before + 1
    want = a.long() @ b.long().t()
    assert got.shape == (m, n) and torch.equal(got.long(), want)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_memory_shrinks(dense, scheme):
    """Below half the f32 tree's bytes (tests/test_quantize.py's bound):
    int8 / W8A8 equal to JAX quantized_bytes of its tree, int4 below it by
    half a byte a value (the port packs two values a byte, ml_dtypes'
    int4 takes one)."""
    _, params, _ = dense
    base = LLM(LLMConfig.tiny(), dtype=torch.float32)
    base.load_state_dict(llm_state_dict(params))
    got = quantized_bytes(_port_quantized(params, scheme))
    assert got < 0.5 * quantized_bytes(base)
    assert quantized_bytes(base) == jax_quantized_bytes(params)
    tree = _jax_quantized(params, scheme)
    want = jax_quantized_bytes(tree)
    if scheme == "int4":
        want -= sum(np.asarray(leaf).size for path, leaf in
                    jax.tree_util.tree_leaves_with_path(tree)
                    if "w_q4" in jax.tree_util.keystr(path)) // 2
    assert got == want


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_greedy_generate_matches_jax(dense, scheme):
    """Greedy tokens of the quantized LLM with its adapter: the port's
    generate() (built from JAX's quantized tree through the bridge, and
    quantized in place by the port) against JAX generate, left-padded
    prompts, exact."""
    jcfg, params, lora = dense
    tree = _jax_quantized(params, scheme)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    mask[2, :6] = 0
    jout, _ = JaxLLM(jcfg, jnp.float32).generate(
        tree, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=8, do_sample=False, pad_id=0, lora=lora,
        lora_scale=SCALE, spec_tokens=0)
    for llm in (_port_from_tree(tree, lora),
                _port_quantized(params, scheme, lora)):
        out, _ = llm.generate(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask), max_new_tokens=8,
                              do_sample=False, pad_id=0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _labels(ids, mask, seed=4):
    rng = np.random.default_rng(seed)
    keep = mask.astype(bool) & (rng.random(ids.shape) < 0.5)
    return np.where(keep, ids, -100).astype(np.int32)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_lora_gradients_over_a_quantized_base_match_jax(dense, scheme):
    """QLoRA (bench.py's train mode): the loss and the LoRA gradients over
    the frozen quantized base against jax.grad of lm_loss(forward(...,
    lora=...)) (loss 1e-5 rel, gradients 1e-4); the base's buffers get no
    gradient and stay as they were."""
    jcfg, params, lora = dense
    tree = _jax_quantized(params, scheme)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, size=(2, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    labels = _labels(ids, mask)

    def j_loss(lora_):
        logits, _, _ = jax_forward(tree, jcfg, input_ids=jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask),
                                   lora=lora_, lora_scale=SCALE, train=True)
        return jax_lm_loss(logits, jnp.asarray(labels))

    want, want_g = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray,
                                                           lora))
    llm = _port_from_tree(tree, lora)
    for n, p in llm.named_parameters():
        p.requires_grad_("lora_" in n)
    before = {n: b.clone() for n, b in llm.named_buffers()}
    logits, _, _ = llm(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask))
    got = lm_loss(logits, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_g = state_dict_of(jax.tree.map(np.asarray, want_g["layers"]),
                           "layers.")
    for name, p in llm.named_parameters():
        if "lora_" in name:
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                       atol=1e-4, err_msg=name)
    assert all(torch.equal(b, before[n]) for n, b in llm.named_buffers())


def test_validation_errors_are_jax_s(dense):
    """quant_scheme, quantize_llm_params and init_quantized_ raise JAX
    quantize_llm_params' errors for 3 bits and for W8A8 at 4 bits; a
    quantized LLM refuses a second quantization and a dense draw."""
    for kw in ({"bits": 3}, {"bits": 4, "act_int8": True}):
        with pytest.raises(ValueError) as want:
            jax_quantize({}, **kw)
        for fn in (lambda: quant_scheme(kw["bits"], kw.get("act_int8",
                                                           False)),
                   lambda: quantize_llm_params(
                       LLM(LLMConfig.tiny(), torch.float32), **kw),
                   lambda: init_quantized_(
                       LLM(LLMConfig.tiny(), torch.float32),
                       torch.Generator(), **kw)):
            with pytest.raises(ValueError) as got:
                fn()
            assert str(got.value) == str(want.value)
    _, params, _ = dense
    llm = _port_quantized(params, "int8")
    with pytest.raises(ValueError, match="quantized already"):
        quantize_llm_params(llm)
    with pytest.raises(ValueError, match="init_quantized_"):
        llm.reset_parameters(torch.Generator())


def test_merge_export_and_jax_tree_refuse_a_quantized_base(dense, tmp_path):
    """merge_lora (whose JAX counterpart reads a dense base['w']), the HF
    export and import and the JAX-tree writer refuse a quantized LLM with
    a ValueError that names it, writing nothing; a dense one merges."""
    from llamole_tpu_torch.models.gllm.convert import export_hf_weights
    from llamole_tpu_torch.weights import jax_tree_of, llm_tree

    _, params, lora = dense
    llm = _port_quantized(params, "int8", lora)
    a0 = llm.layers[0].attn["q"].lora_a.clone()
    with pytest.raises(ValueError, match="quantized"):
        merge_lora(llm)
    assert torch.equal(llm.layers[0].attn["q"].lora_a, a0)
    for fn in (lambda: export_hf_weights(llm, str(tmp_path / "hf")),
               lambda: llm_tree(llm), lambda: jax_tree_of(llm),
               lambda: jax_tree_of(llm.layers[0].mlp["up"])):
        with pytest.raises(ValueError, match="quantized"):
            fn()
    assert not (tmp_path / "hf").exists()
    dense_llm = LLM(LLMConfig.tiny(), dtype=torch.float32)
    dense_llm.add_lora(RANK, SCALE)
    dense_llm.load_state_dict(llm_state_dict(params, lora))
    assert merge_lora(dense_llm) == 14


_TINY_EVAL = {"model_name_or_path": "", "dataset": "molqa_drug_examples",
              "dataset_dir": "data", "template": "default", "cutoff_len": 96,
              "learned_query_size": 8, "output_dir": "unused",
              "finetuning_type": "lora", "lora_rank": 4}


@pytest.mark.parametrize("bad", [
    {"kv_cache_dtype": "fp8"},
    {"quantization_scheme": "awq"},
    {"quantization_scheme": "w8a8"},
    {"quantization_bit": 2},
    {"quantization_bit": 4, "quantization_scheme": "w8a8"},
])
def test_loader_raises_the_jax_loaders_errors(bad):
    """build_graph_lm's argument checks against JAX load_llm's on the same
    bad values: the same ValueError and message, raised before the port
    builds anything."""
    from llamole_tpu.models.loader import load_llm
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm

    jargs = SimpleNamespace(**{
        "model_name_or_path": "", "compute_dtype": "float32",
        "kv_cache_dtype": "compute", "quantization_bit": None,
        "quantization_scheme": "weight_only", **bad})
    with pytest.raises(ValueError) as want:
        load_llm(jargs, SimpleNamespace(vocab_size=64),
                 jax.random.PRNGKey(0))
    model_args, data_args, _, ft_args, _ = get_infer_args(
        {**_TINY_EVAL, **bad})
    with pytest.raises(ValueError) as got:
        build_graph_lm(model_args, data_args, ft_args, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("asked,quant", [
    ({"quantization_bit": 8, "kv_cache_dtype": "int8"}, ("int8", 0)),
    ({"quantization_bit": 8, "quantization_scheme": "w8a8"}, ("w8a8", 0)),
    ({"quantization_bit": 4}, ("int4", 128)),
], ids=["int8+kv8", "w8a8", "int4"])
def test_loader_builds_and_serves_quantized(asked, quant):
    """build_graph_lm with quantization_bit / quantization_scheme /
    kv_cache_dtype quantizes the drawn LLM in place (equal to quantizing
    the dense build of the same seed) and serves a design request
    through DesignServer on the CPU."""
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.serve import DesignServer

    model_args, data_args, _, ft_args, _ = get_infer_args(
        {**_TINY_EVAL, **asked})
    model, tok = build_graph_lm(model_args, data_args, ft_args,
                                device="cpu", generate_mode=True)
    assert model.llm.quant == quant
    kv = asked.get("kv_cache_dtype", "compute")
    assert model.llm.cfg.kv_cache_dtype == kv
    m_args, d_args, _, f_args, _ = get_infer_args(_TINY_EVAL)
    ref, _ = build_graph_lm(m_args, d_args, f_args, device="cpu")
    quantize_llm_params(ref.llm, bits=asked["quantization_bit"],
                        act_int8=quant[0] == "w8a8")
    got, want = model.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    server = DesignServer(model, tok, batch_size=2, max_wait_s=0.1,
                          gen=GenerationSettings(max_new_tokens=4)).start()
    try:
        answer = server.submit("Design.", {"SA": 2.0}).result(timeout=300)
    finally:
        server.stop()
    assert "error" not in answer and isinstance(answer["text"], str)


def test_int8_kv_cache_through_the_loader_with_a_dense_llm():
    """kv_cache_dtype='int8' alone: a dense LLM whose generate() keeps an
    int8 cache (the JAX molqa default's cache on the port)."""
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm

    model_args, data_args, _, ft_args, _ = get_infer_args(
        {**_TINY_EVAL, "kv_cache_dtype": "int8"})
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    assert model.llm.quant is None
    ids = torch.tensor([[5, 6, 7, 8]])
    # spec_tokens=0: the per-token loop returns its decode state (greedy
    # decode drafts by default, and its state is then None, as in JAX)
    _, _, state = model.llm.generate(ids, torch.ones_like(ids),
                                     max_new_tokens=3, do_sample=False,
                                     spec_tokens=0, return_decode_state=True)
    assert state["cache"][0]["k"].dtype == torch.int8
    assert state["cache"][0]["k_scale"].dtype == torch.float32


def test_merge_adapter_refuses_a_quantized_base(tmp_path):
    """merge_adapter with quantization_bit set raises before it builds or
    writes anything."""
    from llamole_tpu_torch.train.export import merge_adapter

    with pytest.raises(ValueError, match="dense base"):
        merge_adapter({**_TINY_EVAL, "quantization_bit": 8},
                      str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()

