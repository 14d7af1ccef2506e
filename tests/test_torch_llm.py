"""llamole_tpu_torch LLM against llamole_tpu's gllm (f32, CPU).

JAX params (+ LoRA) reach the port through llamole_tpu_torch.weights;
token inputs come from seeded numpy. Every family runs: llama / qwen2,
qwen3, gemma-1/2/3 and tiny_moe (FAMILIES); the MoE router, drops and
gradients are in tests/test_torch_moe.py, speculative decoding in
tests/test_torch_speculative.py.
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
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu.models.gllm.model import rope_frequencies as jax_rope
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import (lm_loss, make_kv_cache,
                                                 rope_frequencies,
                                                 warped_candidates)
from llamole_tpu_torch.weights import llm_state_dict, state_dict_of

ATOL = 1e-4   # f32 logits through a 2-layer stack

_GEMMA = dict(hidden_act="gelu_tanh", rms_norm_unit_offset=True,
              scale_embeddings=True, tie_word_embeddings=True)
# the families, at the tiny width: gemma-2 with softcaps 5 / 3, a
# query_scale (24) other than head_dim (16) and a window of 4 < the
# sequence's 11; gemma-3 with pattern 3 (layers 0, 1 local, 2 global),
# the dual rope and linear scaling; tiny_moe at the default capacity
# factor 1.25 and at 0.5, tight enough that units drop
FAMILIES = {
    "qwen3": dict(qk_norm=True, rms_norm_eps=1e-6),
    "gemma1": _GEMMA,
    "gemma2": dict(_GEMMA, sandwich_norms=True, attn_logit_softcap=5.0,
                   final_logit_softcap=3.0, query_scale=24.0,
                   sliding_window=4),
    "gemma3": dict(_GEMMA, sandwich_norms=True, qk_norm=True,
                   query_scale=24.0, sliding_window=4,
                   sliding_window_pattern=3, rope_local_base_freq=1e4,
                   rope_scaling="linear", rope_scaling_factor=8.0,
                   num_layers=3, rope_theta=1e6),
    "moe": dict(num_experts=4, num_experts_per_tok=2),
    "moe_drops": dict(num_experts=4, num_experts_per_tok=2,
                      moe_capacity_factor=0.5),
}


def _pair(rank=4, perturb_norms=False, **overrides):
    """JAX params (+ a random LoRA) and the port's LLM holding them.
    perturb_norms: every norm scale + N(0, 0.1), so that the unit-offset
    and q/k norms (drawn as 0 or 1) are exercised."""
    jcfg = replace(JaxLLMConfig.tiny(), **overrides)
    params = jax.tree.map(np.asarray,
                          init_params(jax.random.PRNGKey(0), jcfg,
                                      jnp.float32))
    if perturb_norms:
        noise = np.random.default_rng(8)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: (a + noise.normal(size=a.shape).astype(
                np.float32) * 0.1) if path[-1].key == "scale" else a,
            params)
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
    *FAMILIES.values(),
], ids=["tiny", "llama3", "qwen2", *FAMILIES])
def test_forward_logits_match_jax(overrides):
    jcfg, params, lora, scale, model = _pair(
        perturb_norms=overrides in FAMILIES.values(), **overrides)
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
    """(Named when S²-attn raised.) An unknown KV cache dtype is refused;
    S²-attn (shift_attn) and every family config build."""
    LLM(replace(LLMConfig.tiny(), shift_attn=True), dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        LLM(replace(LLMConfig.tiny(), kv_cache_dtype="fp8"),
            dtype=torch.float32)
    for overrides in FAMILIES.values():
        LLM(replace(LLMConfig.tiny(), **overrides), dtype=torch.float32)


def _family_cached_steps(model, ids, mask, p):
    """Prefill the first p slots, then decode the rest one at a time;
    returns the logits of every slot."""
    b, s = ids.shape
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    positions = (mask_t.cumsum(-1) - 1).clamp_min(0)
    cache = make_kv_cache(model.cfg, b, s, torch.float32, "cpu")
    kv_valid = torch.zeros((b, s), dtype=torch.bool)
    kv_valid[:, :p] = mask_t[:, :p] > 0
    pre, _, cache = model(input_ids=ids_t[:, :p], attention_mask=mask_t[:, :p],
                          positions=positions[:, :p], kv_cache=cache,
                          cache_index=0, kv_valid=kv_valid)
    steps = [pre]
    for t in range(p, s):
        kv_valid[:, t] = mask_t[:, t] > 0
        step, _, cache = model(input_ids=ids_t[:, t:t + 1],
                               positions=positions[:, t:t + 1],
                               kv_cache=cache, cache_index=t,
                               kv_valid=kv_valid)
        steps.append(step)
    return torch.cat(steps, 1).numpy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cached_decode_equals_full_forward(family):
    """Prefill 5 slots and decode 7 one at a time: the logits equal the
    no-cache forward's (ATOL), across gemma-2's window of 4 and gemma-3's
    local / global layers. Capacity drops make an MoE layer's output
    depend on the tokens routed with it (a decode step routes one token a
    row, the forward all of them), so the MoE cases run at a capacity
    factor of E, where no unit drops."""
    overrides = dict(FAMILIES[family])
    if "num_experts" in overrides:
        overrides["moe_capacity_factor"] = float(overrides["num_experts"])
    _, _, _, _, model = _pair(perturb_norms=True, **overrides)
    ids, mask = _tokens(s=12)
    with torch.no_grad():
        full, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                           attention_mask=torch.from_numpy(mask))
        steps = _family_cached_steps(model, ids, mask, 5)
    real = mask.astype(bool)
    np.testing.assert_allclose(steps[real], full.numpy()[real], atol=ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_greedy_generate_matches_jax(family):
    """Greedy generate (the default: drafts on, except under gemma-2/3's
    sliding windows) gives JAX's tokens, done flags and stop triggers on
    left-padded prompts, with the adapter."""
    from llamole_tpu.models.gllm import LLM as JaxLLM

    jcfg, params, lora, scale, model = _pair(perturb_norms=True,
                                             **FAMILIES[family])
    ids, mask = _tokens(s=9, seed=5)
    eos = (7, 11)
    jout, jdone, jtrig = JaxLLM(jcfg, jnp.float32).generate(
        params, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=10, do_sample=False, eos_ids=eos, pad_id=258,
        lora=lora, lora_scale=scale, return_trigger=True)
    tout, tdone, ttrig = model.generate(
        torch.from_numpy(ids).long(), torch.from_numpy(mask),
        max_new_tokens=10, do_sample=False, eos_ids=eos, pad_id=258,
        return_trigger=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(ttrig.numpy(), np.asarray(jtrig))


def _labels(ids, mask, seed=4):
    """Labels = ids on a random half of the real positions, -100 else."""
    rng = np.random.default_rng(seed)
    keep = mask.astype(bool) & (rng.random(ids.shape) < 0.5)
    return np.where(keep, ids, -100).astype(np.int32)


def test_lm_loss_and_lora_gradients_match_jax():
    """lm_loss of the training forward against JAX's (1e-5 rel) and the
    LoRA gradients against jax.grad of forward + lm_loss (1e-4); an
    all-ignored label row set gives 0, as in JAX."""
    jcfg, params, lora, scale, model = _pair()
    ids, mask = _tokens()
    labels = _labels(ids, mask)

    def j_loss(lora_):
        logits, _, _ = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask),
                                   lora=lora_, lora_scale=scale, train=True)
        return jax_lm_loss(logits, jnp.asarray(labels))

    want, want_g = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray, lora))
    logits, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask))
    got = lm_loss(logits, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_g = state_dict_of(jax.tree.map(np.asarray, want_g["layers"]),
                           "layers.")
    for name, p in model.named_parameters():
        if "lora_" in name:
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                       atol=1e-4, err_msg=name)
    none = torch.full_like(torch.from_numpy(labels), -100)
    assert lm_loss(logits.detach(), none).item() == 0.0


def test_remat_gives_the_same_gradients():
    """cfg.remat recomputes each layer in the backward: same loss and
    gradients as keeping the activations."""
    grads = []
    for remat in (False, True):
        _, _, _, _, model = _pair(remat=remat)
        assert model.cfg.remat is remat
        ids, mask = _tokens()
        logits, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                             attention_mask=torch.from_numpy(mask))
        lm_loss(logits, torch.from_numpy(_labels(ids, mask))).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if "lora_" in n})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=0, atol=1e-6)


def _int8_pair():
    """_pair()'s weights in an LLM with kv_cache_dtype='int8', and the JAX
    config to match."""
    jcfg, params, lora, scale, model = _pair()
    int8 = LLM(replace(LLMConfig.tiny(), kv_cache_dtype="int8"),
               dtype=torch.float32)
    int8.add_lora(4, scale)
    int8.load_state_dict(model.state_dict())
    return (replace(jcfg, kv_cache_dtype="int8"), params, lora, scale,
            model, int8)


def test_int8_kv_cache_greedy_generate_matches_jax():
    """tests/test_llm.py::test_int8_kv_cache_generation on both packages:
    the cache leaves are int8 (f32 scale planes), and greedy tokens with
    the int8 cache equal JAX's int8 generate (exact, left-padded prompts,
    with the adapter) and the port's compute-dtype cache's."""
    from llamole_tpu.models.gllm import LLM as JaxLLM

    jcfg8, params, lora, scale, model, int8 = _int8_pair()
    ids, mask = _tokens(s=9, seed=5)
    jout, _ = JaxLLM(jcfg8, jnp.float32).generate(
        params, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=8, do_sample=False, pad_id=0, lora=lora,
        lora_scale=scale, spec_tokens=0)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
    # spec_tokens=0: the per-token loop returns its decode state
    out8, _, state = int8.generate(*args, max_new_tokens=8, do_sample=False,
                                   pad_id=0, spec_tokens=0,
                                   return_decode_state=True)
    entry = state["cache"][0]
    assert entry["k"].dtype == entry["v"].dtype == torch.int8
    assert entry["k_scale"].dtype == entry["v_scale"].dtype == torch.float32
    np.testing.assert_array_equal(out8.numpy(), np.asarray(jout))
    out, _ = model.generate(*args, max_new_tokens=8, do_sample=False,
                            pad_id=0)
    np.testing.assert_array_equal(out.numpy(), out8.numpy())


def test_int8_kv_cache_one_step_logit_fidelity():
    """tests/test_llm.py::test_int8_kv_cache_logit_fidelity: the prefill's
    last logits with an int8 cache stay within 2% (of the largest logit)
    of the compute-dtype cache's, and equal JAX's int8-cache logits
    within ATOL."""
    jcfg8, params, lora, scale, model, int8 = _int8_pair()
    ids, mask = _tokens(s=8, seed=6)
    b, p, total = ids.shape[0], ids.shape[1], 12
    kv_valid = np.concatenate([mask > 0, np.zeros((b, total - p), bool)], 1)
    j_cache = [{k: jnp.zeros((b, total, jcfg8.num_kv_heads, 16), jnp.int8)
                for k in ("k", "v")} | {
               k: jnp.zeros((b, total, jcfg8.num_kv_heads), jnp.float32)
               for k in ("k_scale", "v_scale")}
               for _ in range(jcfg8.num_layers)]
    want, _, _ = jax_forward(params, jcfg8, input_ids=jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask),
                             kv_cache=j_cache, cache_index=jnp.asarray(0),
                             kv_valid=jnp.asarray(kv_valid), lora=lora,
                             lora_scale=scale)
    last = {}
    for name, llm in (("compute", model), ("int8", int8)):
        cache = make_kv_cache(llm.cfg, b, total, torch.float32, "cpu")
        with torch.no_grad():
            logits, _, _ = llm(input_ids=torch.from_numpy(ids).long(),
                               attention_mask=torch.from_numpy(mask),
                               kv_cache=cache, cache_index=0,
                               kv_valid=torch.from_numpy(kv_valid))
        last[name] = logits[:, -1].numpy()
    assert cache[0]["k"].dtype == torch.int8
    denom = np.abs(last["compute"]).max() + 1e-9
    assert np.abs(last["compute"] - last["int8"]).max() / denom < 0.02
    np.testing.assert_allclose(last["int8"], np.asarray(want[:, -1]),
                               atol=ATOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("s", [1, 2])
def test_per_row_cache_writes_past_the_end_are_dropped(kv, s):
    """cache_append with per-row offsets against JAX _cache_append
    (mode="drop"): rows whose columns fall past the cache's end keep what
    they held, the rest are written (int8: quantized), exactly."""
    from llamole_tpu.models.gllm.model import _cache_append
    from llamole_tpu_torch.models.gllm.model import cache_append

    cfg = replace(LLMConfig.tiny(), kv_cache_dtype=kv)
    rng = np.random.default_rng(11)
    b, t = 4, 6
    cache = make_kv_cache(cfg, b, t, torch.float32, "cpu")[0]
    for name, buf in cache.items():   # nonzero contents to keep
        buf.copy_(torch.from_numpy(
            rng.integers(-50, 50, size=buf.shape)).to(buf.dtype))
    before = {k: v.numpy().copy() for k, v in cache.items()}
    k = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    index = np.array([0, t - s, t - 1, t], np.int32)   # the last two spill
    want = _cache_append({n: jnp.asarray(a) for n, a in before.items()},
                         jnp.asarray(k), jnp.asarray(v), jnp.asarray(index))
    cache_append(cache, torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(index).long())
    for name in cache:
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(cache["k"][3].numpy(), before["k"][3])
