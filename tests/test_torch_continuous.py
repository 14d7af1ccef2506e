"""llamole_tpu_torch's SlotDecoder (continuous decoding) against the JAX
SlotDecoder and the port's own LLM.generate, on the tiny f32 LLM with a
rank-4 adapter, JAX weights carried into the port through the weight
bridge; prompts from seeded numpy.

Tolerance: every comparison is an exact greedy token match (f32 on the
CPU, argmax over logits that agree to ~1e-6 between the paths).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.continuous import SlotDecoder as JaxSlotDecoder
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.continuous import SlotDecoder, _bucket
from llamole_tpu_torch.weights import llm_state_dict

VOCAB = 97
RANK, SCALE = 4, 2.0


@pytest.fixture(scope="module")
def tiny():
    """(JAX LLM, params, lora, port LLM holding the same weights)."""
    jllm = JaxLLM(JaxLLMConfig.tiny(VOCAB), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jllm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(   # random B too, so the adapter changes outputs
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), JaxLLMConfig.tiny(VOCAB),
                  rank=RANK))
    llm = LLM(LLMConfig.tiny(VOCAB), dtype=torch.float32)
    llm.add_lora(RANK, SCALE)
    llm.load_state_dict(llm_state_dict(params, lora))
    return jllm, params, lora, llm


def _generate(llm, prompt, *, max_new, eos_ids):
    """The full [max_new] greedy row of the port's generate() (pads after
    a stop). Slot outputs are padded to the same shape to compare: token
    0 is a real vocab token, so stripping pads would be ambiguous."""
    ids = torch.tensor([prompt])
    out, _ = llm.generate(ids, torch.ones_like(ids, dtype=torch.int32),
                          max_new_tokens=max_new, do_sample=False,
                          eos_ids=eos_ids, pad_id=0)
    return out[0].numpy()


def _padded(got, max_new):
    full = np.zeros((max_new,), np.int64)
    full[:len(got)] = got
    return full


def _decoder(llm, **kw):
    base = dict(slots=2, cache_len=64, max_new_tokens=8, eos_ids=(9,),
                pad_id=0, do_sample=False, chunk_steps=3,
                prompt_buckets=(8,))
    return SlotDecoder(llm, **{**base, **kw})


def test_bucket_selection():
    assert _bucket(3, (8, 16)) == 8
    assert _bucket(8, (8, 16)) == 8
    assert _bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError, match="exceeds"):
        _bucket(17, (8, 16))


def test_greedy_parity_with_jax_slot_decoder_and_generate(tiny):
    """Every request through the pool emits exactly the JAX SlotDecoder's
    tokens and the port's generate()'s, stops on eos and on the budget
    included, whatever its slot-mates."""
    jllm, params, lora, llm = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, size=n).tolist()
               for n in (3, 7, 5, 11, 4)]
    kw = dict(slots=2, cache_len=64, max_new_tokens=10, eos_ids=(9, 23),
              pad_id=0, do_sample=False, chunk_steps=3,
              prompt_buckets=(8, 16))
    jdec = JaxSlotDecoder(jllm, params, lora=lora, lora_scale=SCALE, **kw)
    jrids = [jdec.submit(p) for p in prompts]
    want = jdec.drain()
    dec = SlotDecoder(llm, **kw)
    rids = [dec.submit(p) for p in prompts]
    got = dec.drain()
    assert set(got) == set(rids)
    stops = 0
    for rid, jrid, prompt in zip(rids, jrids, prompts):
        toks, trig = got[rid]
        np.testing.assert_array_equal(toks, np.asarray(want[jrid][0]))
        assert trig == want[jrid][1]
        np.testing.assert_array_equal(
            _padded(toks, 10),
            _generate(llm, prompt, max_new=10, eos_ids=(9, 23)))
        stops += trig != -1
    assert 0 < stops < len(prompts)   # stops on eos and on the budget
    assert dec.idle and dec.chunks_run >= 3


def test_staggered_admission_does_not_change_outputs(tiny):
    """A request admitted mid-flight decodes the tokens it decodes in an
    empty pool (slot isolation)."""
    *_, llm = tiny
    rng = np.random.default_rng(1)
    a = rng.integers(1, VOCAB, size=6).tolist()
    b = rng.integers(1, VOCAB, size=4).tolist()
    dec = _decoder(llm, eos_ids=(), chunk_steps=2)
    ra = dec.submit(a)
    dec.step()          # a is mid-decode
    rb = dec.submit(b)  # b joins a running pool
    results = dec.drain()
    solo = _decoder(llm, eos_ids=(), chunk_steps=2)
    rb2 = solo.submit(b)
    np.testing.assert_array_equal(results[rb][0], solo.drain()[rb2][0])
    np.testing.assert_array_equal(
        _padded(results[ra][0], 8), _generate(llm, a, max_new=8, eos_ids=()))


def test_slot_reuse_and_chunks_run(tiny):
    """More requests than slots: retirement frees slots for the queue and
    every request completes (each slot's state rows rewritten for its new
    occupant: the outputs still match generate())."""
    *_, llm = tiny
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, VOCAB, size=rng.integers(2, 8)).tolist()
               for _ in range(7)]
    dec = _decoder(llm, cache_len=32, max_new_tokens=5, eos_ids=(),
                   chunk_steps=5)
    rids = [dec.submit(p) for p in prompts]
    results = dec.drain()
    assert set(results) == set(rids)
    assert all(len(results[r][0]) == 5 for r in rids)
    assert dec.idle and dec.chunks_run >= 4   # 7 requests / 2 slots
    assert sorted(dec._free) == [0, 1]
    for rid, prompt in zip(rids, prompts):
        np.testing.assert_array_equal(
            results[rid][0], _generate(llm, prompt, max_new=5, eos_ids=()))


def test_shared_prefix_parity_and_fallback(tiny):
    """Prefix admissions emit the full path's tokens (the prefix's KV rows
    prefill once, suffixes attend over them); prompts that do not start
    with the prefix, or equal it, take the full path."""
    jllm, params, lora, llm = tiny
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, VOCAB, size=6).tolist()
    suffixes = [rng.integers(1, VOCAB, size=n).tolist() for n in (3, 5, 2)]
    prompts = [prefix + s for s in suffixes]
    other = rng.integers(1, VOCAB, size=7).tolist()   # no prefix match
    dec = _decoder(llm, shared_prefix=prefix)
    jdec = JaxSlotDecoder(jllm, params, lora=lora, lora_scale=SCALE,
                          slots=2, cache_len=64, max_new_tokens=8,
                          eos_ids=(9,), pad_id=0, do_sample=False,
                          chunk_steps=3, prompt_buckets=(8,),
                          shared_prefix=prefix)
    rids = [dec.submit(p) for p in prompts + [other]]
    jrids = [jdec.submit(p) for p in prompts + [other]]
    results, want = dec.drain(), jdec.drain()
    assert dec.prefix_admissions == len(prompts)
    for rid, jrid, prompt in zip(rids, jrids, prompts + [other]):
        np.testing.assert_array_equal(results[rid][0],
                                      np.asarray(want[jrid][0]))
        np.testing.assert_array_equal(
            _padded(results[rid][0], 8),
            _generate(llm, prompt, max_new=8, eos_ids=(9,)))
    # prompt == prefix: no suffix token left for a first sample -> full
    rid = dec.submit(list(prefix))
    out = dec.drain()[rid][0]
    assert dec.prefix_admissions == len(prompts)
    np.testing.assert_array_equal(
        _padded(out, 8), _generate(llm, prefix, max_new=8, eos_ids=(9,)))


def test_oversized_prompt_refused_without_slot_leak(tiny):
    """submit() refuses a prompt past every bucket before a slot is
    claimed; the pool serves on afterwards."""
    *_, llm = tiny
    dec = _decoder(llm, cache_len=32, max_new_tokens=4, eos_ids=(),
                   chunk_steps=2)
    for _ in range(3):   # more refusals than slots: a leak would show
        with pytest.raises(ValueError, match="exceeds"):
            dec.submit(list(range(1, 20)))
    rid = dec.submit([1, 2, 3])
    results = dec.drain()
    assert len(results[rid][0]) == 4
    assert len(dec._free) == 2


def test_cache_len_guard(tiny):
    *_, llm = tiny
    with pytest.raises(ValueError, match="cache_len"):
        SlotDecoder(llm, slots=2, cache_len=16, max_new_tokens=16,
                    prompt_buckets=(8,))
    with pytest.raises(ValueError, match="shared prefix 4"):
        SlotDecoder(llm, slots=2, cache_len=26, max_new_tokens=16,
                    prompt_buckets=(8,), shared_prefix=[1, 2, 3, 4])


def test_int8_kv_and_sliding_window_are_refused(tiny):
    """A shared prefix with sliding windows is refused with the JAX
    package's message (the suffix's left padding shifts its slots but not
    the prefix's); the pool over a sliding-window LLM runs without one
    (tests/test_torch_llm.py holds the windowed decode to JAX's). The int8
    KV cache is not refused either (gllm/model.py): the pool over such an
    LLM holds int8 values and f32 scale planes, and a kv_cache_dtype other
    than 'compute' or 'int8' is a ValueError, as in the JAX loader."""
    *_, llm = tiny
    cfg = replace(LLMConfig.tiny(VOCAB), sliding_window=4)
    windowed = LLM(cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="shared_prefix is not supported"):
        SlotDecoder(windowed, slots=2, cache_len=64, max_new_tokens=8,
                    prompt_buckets=(8,), shared_prefix=[5, 6, 7])
    SlotDecoder(windowed, slots=2, cache_len=64, max_new_tokens=8,
                prompt_buckets=(8,))
    int8 = LLM(replace(LLMConfig.tiny(VOCAB), kv_cache_dtype="int8"),
               dtype=torch.float32)
    dec = SlotDecoder(int8, slots=2, cache_len=64, max_new_tokens=8,
                      prompt_buckets=(8,))
    entry = dec.cache[0]
    assert entry["k"].dtype == entry["v"].dtype == torch.int8
    assert entry["k_scale"].shape == entry["k"].shape[:3]
    assert entry["v_scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        LLM(replace(LLMConfig.tiny(VOCAB), kv_cache_dtype="fp8"),
            dtype=torch.float32)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """The tiny pair with kv_cache_dtype='int8' on both sides."""
    _, params, lora, llm = tiny
    jllm = JaxLLM(replace(JaxLLMConfig.tiny(VOCAB), kv_cache_dtype="int8"),
                  dtype=jnp.float32)
    llm8 = LLM(replace(LLMConfig.tiny(VOCAB), kv_cache_dtype="int8"),
               dtype=torch.float32)
    llm8.add_lora(RANK, SCALE)
    llm8.load_state_dict(llm.state_dict())
    return jllm, params, lora, llm8


@pytest.mark.parametrize("prefixed", [False, True],
                         ids=["full", "shared_prefix"])
def test_int8_kv_pool_matches_jax_slot_decoder_and_generate(tiny_int8,
                                                            prefixed):
    """The JAX test_int8_kv_slot_parity on both packages: with an int8 KV
    cache the staged prefill's int8 values and scale planes go into the
    slot verbatim (also over the stored prefix rows) and every step
    quantizes the row it writes, so the pool emits exactly the JAX
    SlotDecoder's greedy tokens and the port's int8 generate()'s, one of
    its slots finishing at the cache's end (cache_len = bucket + budget:
    its next write falls past the end and is dropped)."""
    jllm, params, lora, llm = tiny_int8
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, VOCAB, size=5).tolist() if prefixed else None
    prompts = [(prefix or []) + rng.integers(1, VOCAB, size=n).tolist()
               for n in (3, 6, 9, 4)]
    kw = dict(slots=2, cache_len=16 + 6 + (5 if prefixed else 0),
              max_new_tokens=6, eos_ids=(9,), pad_id=0, do_sample=False,
              chunk_steps=2, prompt_buckets=(8, 16), shared_prefix=prefix)
    jdec = JaxSlotDecoder(jllm, params, lora=lora, lora_scale=SCALE, **kw)
    jrids = [jdec.submit(p) for p in prompts]
    want = jdec.drain()
    dec = SlotDecoder(llm, **kw)
    rids = [dec.submit(p) for p in prompts]
    got = dec.drain()
    assert dec.cache[0]["k"].dtype == torch.int8
    assert dec.prefix_admissions == (len(prompts) if prefixed else 0)
    for rid, jrid, prompt in zip(rids, jrids, prompts):
        np.testing.assert_array_equal(got[rid][0], np.asarray(want[jrid][0]))
        assert got[rid][1] == want[jrid][1]
        np.testing.assert_array_equal(
            _padded(got[rid][0], 6),
            _generate(llm, prompt, max_new=6, eos_ids=(9,)))


def test_sampled_decoding_is_seeded(tiny):
    """Sampling draws from the pool's own generator: one seed, one
    output; every row keeps its budget."""
    *_, llm = tiny
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, size=n).tolist() for n in (4, 6, 3)]

    def run(seed):
        dec = _decoder(llm, do_sample=True, temperature=1.0, top_p=0.9,
                       eos_ids=(), seed=seed)
        rids = [dec.submit(p) for p in prompts]
        out = dec.drain()
        return [out[r][0] for r in rids]

    first, again = run(3), run(3)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 8 and ((0 <= a) & (a < VOCAB)).all()


_GEMMA = dict(hidden_act="gelu_tanh", rms_norm_unit_offset=True,
              scale_embeddings=True, tie_word_embeddings=True)
POOL_FAMILIES = {
    "qwen3": dict(qk_norm=True),
    "gemma2": dict(_GEMMA, sandwich_norms=True, attn_logit_softcap=5.0,
                   final_logit_softcap=3.0, query_scale=24.0,
                   sliding_window=4),
    "gemma3": dict(_GEMMA, sandwich_norms=True, qk_norm=True,
                   query_scale=24.0, sliding_window=4,
                   sliding_window_pattern=3, rope_local_base_freq=1e4,
                   rope_scaling="linear", num_layers=3),
    "moe": dict(num_experts=4, num_experts_per_tok=2),
}


@pytest.mark.parametrize("family", list(POOL_FAMILIES))
def test_every_family_runs_in_the_pool(family):
    """The pool over a qwen3, gemma-2 (window 4, shorter than the
    prompts plus their decode), gemma-3 or MoE LLM emits the JAX
    SlotDecoder's tokens and triggers, request for request."""
    from llamole_tpu.models.gllm.model import init_params

    overrides = POOL_FAMILIES[family]
    jcfg = replace(JaxLLMConfig.tiny(VOCAB), **overrides)
    noise = np.random.default_rng(8)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + noise.normal(size=a.shape).astype(np.float32)
                         * 0.1) if path[-1].key == "scale" else a,
        jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg,
                                             jnp.float32)))
    llm = LLM(replace(LLMConfig.tiny(VOCAB), **overrides),
              dtype=torch.float32)
    llm.load_state_dict(llm_state_dict(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, size=n).tolist() for n in (3, 7, 5, 6)]
    kw = dict(slots=2, cache_len=64, max_new_tokens=10, eos_ids=(9, 23),
              pad_id=0, do_sample=False, chunk_steps=3, prompt_buckets=(8,))
    jdec = JaxSlotDecoder(JaxLLM(jcfg, dtype=jnp.float32), params, **kw)
    jrids = [jdec.submit(p) for p in prompts]
    want = jdec.drain()
    dec = SlotDecoder(llm, **kw)
    rids = [dec.submit(p) for p in prompts]
    got = dec.drain()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(got[rid][0],
                                      np.asarray(want[jrid][0]))
        assert got[rid][1] == want[jrid][1]
