"""llamole_tpu_torch LLM against llamole_tpu's gllm (f32, CPU).

JAX params (+ LoRA) reach the port through llamole_tpu_torch.weights;
token inputs come from seeded numpy.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.model import _warped_candidates
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.models.gllm.model import rope_frequencies as jax_rope
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import (make_kv_cache,
                                                 rope_frequencies,
                                                 warped_candidates)
from llamole_tpu_torch.weights import llm_state_dict

ATOL = 1e-4   # f32 logits through a 2-layer stack


def _pair(rank=4, **overrides):
    jcfg = replace(JaxLLMConfig.tiny(), **overrides)
    params = jax.tree.map(np.asarray,
                          init_params(jax.random.PRNGKey(0), jcfg,
                                      jnp.float32))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(   # random B too, so the adapter changes outputs
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), jcfg, rank=rank))
    scale = 2.0
    model = LLM(replace(LLMConfig.tiny(), **overrides), dtype=torch.float32)
    model.add_lora(rank, scale)
    model.load_state_dict(llm_state_dict(params, lora))
    return jcfg, params, lora, scale, model


def _tokens(b=3, s=11, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :4] = 0       # left padding
    mask[2, :7] = 0
    return ids, mask


@pytest.mark.parametrize("overrides", [
    {},                                               # tiny GQA 4q/2kv
    {"rope_scaling": "llama3", "rope_theta": 5e5},
    {"attention_bias": True},                         # qwen2-style
])
def test_forward_logits_match_jax(overrides):
    jcfg, params, lora, scale, model = _pair(**overrides)
    if overrides.get("attention_bias"):   # biases init to zero: perturb
        rng = np.random.default_rng(9)
        for layer in params["layers"]:
            for name in ("q", "k", "v"):
                layer["attn"][name]["b"] = rng.normal(
                    size=layer["attn"][name]["b"].shape).astype(np.float32)
        model.load_state_dict(llm_state_dict(params, lora))
    ids, mask = _tokens()
    want, want_h, _ = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                                  attention_mask=jnp.asarray(mask),
                                  lora=lora, lora_scale=scale)
    with torch.no_grad():
        got, got_h, _ = model(input_ids=torch.from_numpy(ids).long(),
                              attention_mask=torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL)
    np.testing.assert_allclose(got_h.numpy()[real], np.asarray(want_h)[real],
                               atol=ATOL)


def test_stacked_layers_bridge_like_the_list_layout():
    from llamole_tpu.models.gllm.stacked import stack_layers

    _, params, lora, _, _ = _pair()
    flat = llm_state_dict(params, lora)
    stacked = llm_state_dict(jax.tree.map(np.asarray, stack_layers(params)),
                             jax.tree.map(np.asarray, stack_layers(lora)))
    assert sorted(flat) == sorted(stacked)
    for k in flat:
        assert torch.equal(flat[k], stacked[k]), k


def test_rope_frequencies_llama3_8b_equal():
    np.testing.assert_array_equal(
        torch.tensor(rope_frequencies(LLMConfig.llama3_8b()),
                     dtype=torch.float32).numpy(),
        np.asarray(jax_rope(JaxLLMConfig.llama3_8b())))


def test_kv_cache_prefill_decode_equals_full_forward():
    _, _, _, _, model = _pair()
    ids, mask = _tokens(s=12)
    ids_t = torch.from_numpy(ids).long()
    mask_t = torch.from_numpy(mask)
    p = 8   # prefill the first 8 slots, decode the last 4 one at a time
    with torch.no_grad():
        full, _, _ = model(input_ids=ids_t, attention_mask=mask_t)
        positions = (mask_t.cumsum(-1) - 1).clamp_min(0)
        cache = make_kv_cache(model.cfg, 3, 12, torch.float32, "cpu")
        kv_valid = torch.zeros((3, 12), dtype=torch.bool)
        kv_valid[:, :p] = mask_t[:, :p] > 0
        pre, _, cache = model(input_ids=ids_t[:, :p],
                              attention_mask=mask_t[:, :p],
                              positions=positions[:, :p], kv_cache=cache,
                              cache_index=0, kv_valid=kv_valid)
        steps = [pre]
        for t in range(p, 12):
            kv_valid[:, t] = True
            step, _, cache = model(input_ids=ids_t[:, t:t + 1],
                                   positions=positions[:, t:t + 1],
                                   kv_cache=cache, cache_index=t,
                                   kv_valid=kv_valid)
            steps.append(step)
    real = mask.astype(bool)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy()[real],
                               full.numpy()[real], atol=ATOL)


@pytest.mark.parametrize("temperature,top_p,top_k,do_sample", [
    (0.6, 0.9, 0, True),      # the llama_drug.yaml settings
    (1.0, 0.95, 0, True),
    (0.7, 0.9, 20, True),     # top-k then top-p on the renormalized set
    (1.0, 1.0, 50, True),     # top-k alone
    (1.0, 1.0, 0, True),      # full vocab
    (0.6, 0.9, 0, False),     # greedy
])
def test_warped_candidates_match_jax(temperature, top_p, top_k, do_sample):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(4, 1000)) * 3).astype(np.float32)
    jv, ji = _warped_candidates(jnp.asarray(logits), temperature, top_p,
                                top_k, do_sample)
    tv, ti = warped_candidates(torch.from_numpy(logits), temperature, top_p,
                               top_k, do_sample)
    assert (ji is None) == (ti is None)
    if not do_sample:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        return
    jv, tv = np.asarray(jv), tv.numpy()
    if ji is not None:
        ji, ti = np.asarray(ji), ti.numpy()
        for r in range(logits.shape[0]):
            assert (set(ji[r][jv[r] > -1e29].tolist())
                    == set(ti[r][tv[r] > -1e29].tolist()))
    jp = np.asarray(jax.nn.softmax(jnp.asarray(jv), -1))
    tp = torch.softmax(torch.from_numpy(tv), -1).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-6)


@pytest.mark.parametrize("repetition_penalty", [1.0, 1.3])
def test_greedy_generate_matches_jax(repetition_penalty):
    from llamole_tpu.models.gllm import LLM as JaxLLM

    jcfg, params, lora, scale, model = _pair()
    ids, mask = _tokens(s=9, seed=5)
    eos = (7, 11)
    jout, jdone = JaxLLM(jcfg, jnp.float32).generate(
        params, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=10, do_sample=False, eos_ids=eos, pad_id=258,
        lora=lora, lora_scale=scale, spec_tokens=0,
        repetition_penalty=repetition_penalty)
    tout, tdone = model.generate(
        torch.from_numpy(ids).long(), torch.from_numpy(mask),
        max_new_tokens=10, do_sample=False, eos_ids=eos, pad_id=258,
        repetition_penalty=repetition_penalty)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="MoE"):
        LLM(replace(LLMConfig.tiny(), num_experts=4), dtype=torch.float32)
    _, _, _, _, model = _pair()
    ids, mask = _tokens()
    with pytest.raises(NotImplementedError, match="speculative"):
        model.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       spec_tokens=2)
