"""gemma-1 through the LLM's flash route, llamole_tpu_torch against
llamole_tpu (f32, CPU).

gemma-1 (`model_type: "gemma"`) is the one family whose head_dim-256
attention takes the flash route in both packages: from_hf_config sets no
softcap, window or query scale for it, so JAX's `_flash_ok` and plain
SDPA clause pass, and on the card the port runs kernel E at head_dim 256
(gemma-7b's heads; chip_smoke.py phase 22 (d)). Here one HF config dict
goes through both packages' `from_hf_config` at a 2-layer width with 4
heads of 256 and 4 KV heads, the JAX weights are carried by weights.py,
and both gates are forced as tests/test_torch_flash_attention.py forces
them (JAX's without its platform clause, the port's reading a CUDA
device; jaxlib's Pallas kernels in TPU interpret mode, the port's plain
version on the CPU):

- the flash-route logits against JAX's flash forward, pad rows included;
- the LoRA gradients of a loss over every row against jax.grad through
  JAX's flash route (jaxlib's dq and dkv kernels);
- the gate takes the route for gemma-1 and refuses it for gemma-2- and
  gemma-3-shaped configs (softcaps, windows, query scales), where JAX's
  decoder layer does.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import llamole_tpu.models.gllm.model as jax_model
import llamole_tpu_torch.models.gllm.model as port_model
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.weights import llm_state_dict

LOGIT_ATOL = 1e-4
GRAD_ATOL = 1e-4
S = 256

# gemma-7b's config.json keys at a test width: 2 layers, 4 heads of 256
GEMMA1 = {"model_type": "gemma", "vocab_size": 512, "hidden_size": 256,
          "intermediate_size": 512, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 4,
          "head_dim": 256, "hidden_act": "gelu", "rms_norm_eps": 1e-6,
          "rope_theta": 10000.0, "max_position_embeddings": 2048}
# the later gemmas' attention: logit softcaps, windows, query scales
GEMMA2 = {**GEMMA1, "model_type": "gemma2", "attn_logit_softcapping": 50.0,
          "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
          "sliding_window": 4096}
GEMMA3 = {**GEMMA1, "model_type": "gemma3_text", "query_pre_attn_scalar": 256,
          "sliding_window": 512, "sliding_window_pattern": 2,
          "rope_local_base_freq": 10000.0}


def _flash_ok_any_platform(cfg, s):
    """JAX's _flash_ok without its `platform == "tpu"` clause."""
    return (cfg.use_flash and s >= cfg.flash_min_seq and s % 128 == 0
            and cfg.head_dim_ in (128, 256))


@pytest.fixture
def forced(monkeypatch):
    """Both gates open off their platforms (the port's: as on a CUDA
    device); returns the port's and JAX's flash calls, counted."""
    calls = {"port": 0, "jax": 0}
    gate, port_flash = port_model.flash_ok, port_model.flash_attention
    jax_flash = jax_model._flash_attention

    def port_counted(*args):
        calls["port"] += 1
        return port_flash(*args)

    def jax_counted(*args):
        calls["jax"] += 1
        return jax_flash(*args)

    monkeypatch.setattr(port_model, "flash_ok",
                        lambda cfg, s, device: gate(cfg, s, "cuda"))
    monkeypatch.setattr(port_model, "flash_attention", port_counted)
    monkeypatch.setattr(jax_model, "_flash_ok", _flash_ok_any_platform)
    monkeypatch.setattr(jax_model, "_flash_attention", jax_counted)
    return calls


def _interpret(fn, *args):
    """fn(*args) as one jitted computation, waited for. Interpret mode's
    host callbacks dispatch JAX operations of their own: an eager
    operation dispatched beside them can deadlock the CPU client."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _configs(raw):
    """One HF dict through both packages' from_hf_config, the flash route
    on from S = 128."""
    flash = {"use_flash": True, "flash_min_seq": 128}
    return (replace(JaxLLMConfig.from_hf_config(raw), **flash),
            replace(LLMConfig.from_hf_config(raw), **flash))


def _pair(raw):
    jcfg, cfg = _configs(raw)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), jcfg, rank=4))
    model = LLM(cfg, dtype=torch.float32)
    model.add_lora(4, 2.0)
    model.load_state_dict(llm_state_dict(params, lora))
    return jcfg, params, lora, model


def _batch(b=2, seed=3):
    """Token ids and the attention mask: row 0 left-padded, the last row
    right-padded (a single row both)."""
    ids = np.random.default_rng(seed).integers(0, 512, size=(b, S)).astype(
        np.int32)
    mask = np.ones((b, S), np.int32)
    mask[0, :9] = 0
    mask[-1, S - 13:] = 0
    return ids, mask


def test_gemma1_config_takes_head_dim_256_plain_attention():
    """The dict reads as gemma-1 in both packages: 4 heads of 256, 4 KV
    heads, tied embeddings, no softcap, window or query scale."""
    jcfg, cfg = _configs(GEMMA1)
    for c in (jcfg, cfg):
        assert (c.num_heads, c.num_kv_heads, c.head_dim_) == (4, 4, 256)
        assert c.tie_word_embeddings and c.attn_logit_softcap is None
        assert c.sliding_window is None and c.query_scale is None
    assert port_model.plain_sdpa(cfg)


def test_gemma1_flash_logits_match_jax_flash_forward(forced):
    """The 2-layer gemma-1 through the flash route: logits within 1e-4 of
    JAX's flash forward (jaxlib's kernel in interpret mode) on real and
    padded rows, both taking the route in every layer."""
    jcfg, params, lora, model = _pair(GEMMA1)
    ids, mask = _batch()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_interpret(
            lambda p, lo: jax_forward(p, jcfg, input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      lora=lo, lora_scale=2.0)[0],
            params, lora))
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask))[0].numpy()
    assert forced == {"port": jcfg.num_layers, "jax": jcfg.num_layers}
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_gemma1_flash_lora_grads_match_jax_flash_route(forced):
    """The port's LoRA gradients through the flash route, of a weighted
    sum of every row's logits, within 1e-4 of jax.grad through JAX's
    flash route (jaxlib's forward, dq and dkv kernels in interpret mode),
    pad rows included."""
    jcfg, params, lora, model = _pair(GEMMA1)
    ids, mask = _batch()
    w = np.random.default_rng(4).normal(size=(2, S, 512)).astype(
        np.float32) * 0.01
    for n, p in model.named_parameters():
        p.requires_grad_("lora_" in n)
    logits = model(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask), train=True)[0]
    (logits * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in model.named_parameters() if "lora_" in n}
    assert forced["port"] == jcfg.num_layers
    j_params = jax.tree.map(jnp.asarray, params)

    def j_grads(lo):
        def loss(lo):
            logits, _, _ = jax_forward(j_params, jcfg,
                                       input_ids=jnp.asarray(ids),
                                       attention_mask=jnp.asarray(mask),
                                       lora=lo, lora_scale=2.0, train=True)
            return jnp.sum(logits * w)
        return jax.grad(loss)(lo)

    with pltpu.force_tpu_interpret_mode():
        want = _interpret(j_grads, jax.tree.map(jnp.asarray, lora))
    assert forced["jax"] == jcfg.num_layers
    want = {n: t for n, t in llm_state_dict(
        params, jax.tree.map(np.asarray, want)).items() if "lora_" in n}
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("raw, takes", [(GEMMA1, True), (GEMMA2, False),
                                        (GEMMA3, False)],
                         ids=["gemma1", "gemma2", "gemma3"])
def test_gate_takes_gemma1_and_refuses_the_later_gemmas(forced, monkeypatch,
                                                        raw, takes):
    """Inside each package's layer the forced gate picks the flash route
    for gemma-1 and, for gemma-2 and gemma-3 shaped configs (softcaps,
    windows, query scales), neither package does."""
    monkeypatch.setattr(jax_model, "_flash_attention",
                        lambda q, k, v, m, cfg: (
                            forced.__setitem__("jax", forced["jax"] + 1),
                            jnp.zeros(q.shape[:2] + (q.shape[2] * q.shape[3],),
                                      q.dtype))[1])
    monkeypatch.setattr(port_model, "flash_attention",
                        lambda q, k, v, m: (
                            forced.__setitem__("port", forced["port"] + 1),
                            q.new_zeros(q.shape[:2] + (q.shape[2]
                                                       * q.shape[3],)))[1])
    jcfg, params, lora, model = _pair(raw)
    ids, mask = _batch(b=1)
    jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                attention_mask=jnp.asarray(mask), lora=lora, lora_scale=2.0)
    with torch.no_grad():
        model(input_ids=torch.from_numpy(ids).long(),
              attention_mask=torch.from_numpy(mask))
    layers = jcfg.num_layers * takes
    assert forced == {"port": layers, "jax": layers}
    assert port_model.flash_ok(model.cfg, S, "cpu") == takes
