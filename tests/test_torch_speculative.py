"""Prompt-lookup speculative decoding of llamole_tpu_torch against
llamole_tpu (f32, CPU): the n-gram drafts equal JAX's on random
histories; greedy decoding with drafts gives the per-token loop's and
JAX's speculative tokens, done flags, stop triggers and verify steps
(K in {1, 2, 4}, n-gram in {1, 2, 3}, stop tokens, the budget boundary,
the int8 KV cache, a repetitive prompt, a guard trip and its
continuation); the auto rule and its fallbacks; sampled marginals against
the per-token loop by total variation, as tests/test_speculative.py
bounds them. JAX params reach the port through llamole_tpu_torch.weights;
prompts come from seeded numpy."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import ngram_drafts
from llamole_tpu_torch.weights import llm_state_dict

VOCAB = 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**overrides):
    jllm = JaxLLM(replace(JaxLLMConfig.tiny(VOCAB), **overrides),
                  dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jllm.init(jax.random.PRNGKey(0)))
    llm = LLM(replace(LLMConfig.tiny(VOCAB), **overrides),
              dtype=torch.float32)
    llm.load_state_dict(llm_state_dict(params))
    return jllm, params, llm


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _prompt(b=3, p=9):
    """Ragged left-padded prompts (tests/test_speculative.py's)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(2, VOCAB, size=(b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    for i, n_pad in enumerate([0, 3, 5][:b]):
        ids[i, :n_pad] = 0
        mask[i, :n_pad] = 0
    return ids, mask


def _both(jllm, params, llm, ids, mask, **kw):
    """(JAX outputs, port outputs) as numpy, with trigger and iterations."""
    kw = dict(kw, return_trigger=True, return_spec_iters=True)
    want = jllm.generate(params, jax.random.PRNGKey(1), jnp.asarray(ids),
                         jnp.asarray(mask), **kw)
    got = llm.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       **kw)
    return ([np.asarray(w) for w in want],
            [g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
             for g in got])


def _assert_same(a, b, what=""):
    for x, y, name in zip(a, b, ("tokens", "done", "trigger", "iterations")):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


@pytest.mark.parametrize("ngram", [1, 2, 3, 4])
@pytest.mark.parametrize("K", [1, 3])
def test_ngram_drafts_equal_jax(ngram, K):
    """Random histories with invalid (left-pad) columns, a planted earlier
    occurrence of the tail and rows without one: the port's drafts are
    JAX's."""
    p, max_new = 10, 12
    L = p + max_new
    rng = np.random.default_rng(ngram * 10 + K)
    for _ in range(5):
        b = 6
        hist = rng.integers(0, 5, size=(b, L + 1)).astype(np.int32)
        hvalid = np.zeros((b, L + 1), bool)
        gen = rng.integers(1, max_new, size=b).astype(np.int32)
        for r in range(b):
            pad = rng.integers(0, 4)
            hvalid[r, pad:p + gen[r]] = True
        from llamole_tpu.models.gllm.model import LLM as _JaxLLM
        want = np.asarray(_JaxLLM._ngram_drafts(
            jnp.asarray(hist), jnp.asarray(hvalid), jnp.asarray(gen), p, L,
            ngram, K))
        got = ngram_drafts(torch.from_numpy(hist).long(),
                           torch.from_numpy(hvalid),
                           torch.from_numpy(gen).long(), p, L, ngram, K)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_drafts_follow_the_most_recent_match():
    """tests/test_speculative.py::test_ngram_draft_proposer's histories."""
    p, max_new = 8, 8
    L = p + max_new
    hist = np.zeros((2, L + 1), np.int64)
    hvalid = np.zeros((2, L + 1), bool)
    hist[0, :p] = [5, 6, 9, 5, 6, 7, 2, 3]
    hvalid[0, :p] = True
    hist[0, p:p + 2] = [5, 6]
    hvalid[0, p:p + 2] = True
    hist[1, :p] = [4, 8, 0, 1, 4, 8, 4, 8]
    hvalid[1, 3:p] = True
    hist[1, p:p + 2] = [4, 8]
    hvalid[1, p:p + 2] = True
    drafts = ngram_drafts(torch.from_numpy(hist), torch.from_numpy(hvalid),
                          torch.tensor([2, 2]), p, L, 2, 3).numpy()
    np.testing.assert_array_equal(drafts[0], [7, 2, 3])
    np.testing.assert_array_equal(drafts[1][:2], [4, 8])


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_greedy_spec_equals_the_loop_and_jax(tiny, K, ngram):
    """Drafts on: the tokens, done flags and triggers of the per-token loop
    (spec_tokens=0) and of JAX's speculative path (with its verify-step
    count), without stop tokens and with two that the greedy rows emit
    (one row stops early, one near the end)."""
    jllm, params, llm = tiny
    ids, mask = _prompt()
    base = llm.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                        max_new_tokens=24, do_sample=False,
                        spec_tokens=0)[0].numpy()
    for eos in ((), (int(base[0, 10]), int(base[1, 5]))):
        kw = dict(max_new_tokens=24, do_sample=False, pad_id=0, eos_ids=eos)
        want, got = _both(jllm, params, llm, ids, mask, spec_tokens=K,
                          spec_ngram=ngram, **kw)
        _assert_same(want, got, f"eos={eos}")
        loop = llm.generate(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), spec_tokens=0,
                            return_trigger=True, **kw)
        _assert_same([t.numpy() for t in loop], got[:3], "loop")
        if eos:
            assert got[1].all()


def _cyclic_prompt(llm, b=1):
    """The prompt, its greedy continuation, the prompt again: greedy
    decoding replays the continuation, and lookup finds it."""
    ids0 = torch.arange(5, 17)[None].repeat(b, 1)
    base, _ = llm.generate(ids0, torch.ones_like(ids0), max_new_tokens=16,
                           do_sample=False, spec_tokens=0)
    ids = torch.cat([ids0, base, ids0], dim=1)
    return ids.numpy().astype(np.int32), np.ones(ids.shape, np.int32)


def test_repetitive_prompt_accepts_drafts(tiny):
    """Where the history predicts the continuation, drafts are accepted
    (fewer verify steps than tokens) and the output is still the loop's
    and JAX's."""
    jllm, params, llm = tiny
    ids, mask = _cyclic_prompt(llm, b=2)
    want, got = _both(jllm, params, llm, ids, mask, max_new_tokens=16,
                      do_sample=False, pad_id=0, spec_tokens=4)
    _assert_same(want, got)
    loop = llm.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                        max_new_tokens=16, do_sample=False, spec_tokens=0)
    np.testing.assert_array_equal(got[0], loop[0].numpy())
    assert int(got[3]) <= 12


def test_budget_boundary_sets_done_and_trigger(tiny):
    """A stop token sampled exactly at the budget's end is never emitted
    but sets done and the trigger, as in the per-token loop: budgets of 2
    and 7 across K, the port's drafted tokens, done and trigger the
    loop's, its tokens and verify steps JAX's. JAX's speculative path
    leaves done / trigger unset where a verify step fills the budget
    without reaching the token after it (budget 2 here); that is the one
    place the two differ, and there the port gives the loop's."""
    jllm, params, llm = tiny
    ids, mask = _prompt()
    jax_missed = 0
    for max_new in (2, 7):
        full = llm.generate(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), max_new_tokens=max_new + 1,
                            do_sample=False, spec_tokens=0)[0].numpy()
        eos = (int(full[0, max_new]),)       # row 0's boundary token
        for K in (1, 3):
            kw = dict(max_new_tokens=max_new, do_sample=False, pad_id=0,
                      eos_ids=eos, spec_tokens=K)
            want, got = _both(jllm, params, llm, ids, mask, **kw)
            np.testing.assert_array_equal(got[0], want[0])
            assert int(got[3]) == int(want[3])
            loop = llm.generate(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask), return_trigger=True,
                                **dict(kw, spec_tokens=0))
            _assert_same([t.numpy() for t in loop], got[:3])
            assert got[1][0] and got[2][0] == eos[0]
            differ = (want[1] != got[1]) | (want[2] != got[2])
            if differ.any():
                assert (got[1][differ] & ~want[1][differ]).all()
                assert (want[2][differ] == -1).all()
                assert (got[2][differ] == eos[0]).all()
                jax_missed += 1
    assert jax_missed == 2        # budget 2, K = 1 and 3


def test_int8_kv_cache_under_drafting():
    """With the int8 KV cache, drafts on give the per-token loop's tokens
    and JAX's speculative outputs."""
    jllm, params, llm = _pair(kv_cache_dtype="int8")
    ids, mask = _prompt()
    for K in (2, 4):
        want, got = _both(jllm, params, llm, ids, mask, max_new_tokens=16,
                          do_sample=False, pad_id=0, spec_tokens=K)
        _assert_same(want, got)
        loop = llm.generate(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), max_new_tokens=16,
                            do_sample=False, spec_tokens=0)
        np.testing.assert_array_equal(got[0], loop[0].numpy())
    ids, mask = _cyclic_prompt(llm)
    want, got = _both(jllm, params, llm, ids, mask, max_new_tokens=16,
                      do_sample=False, pad_id=0, spec_tokens=4)
    _assert_same(want, got)


def test_guard_trip_continues_per_token(tiny):
    """Random prompts defeat the drafts: the guard trips after spec_probe
    verify steps (the iterations returned), and the per-token
    continuation finishes every row with the loop's and JAX's tokens,
    done flags and triggers, stops included; a probe window longer than
    the decode never trips."""
    jllm, params, llm = tiny
    ids, mask = _prompt()
    base = llm.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                        max_new_tokens=20, do_sample=False,
                        spec_tokens=0)[0].numpy()
    eos = (int(base[2, 15]),)
    for probe in (3, 8):
        kw = dict(max_new_tokens=20, do_sample=False, pad_id=0, eos_ids=eos,
                  spec_tokens=2, spec_probe=probe)
        want, got = _both(jllm, params, llm, ids, mask, **kw)
        _assert_same(want, got, f"probe={probe}")
        assert int(got[3]) == probe       # tripped right after the probe
        loop = llm.generate(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), return_trigger=True,
                            **dict(kw, spec_tokens=0))
        _assert_same([t.numpy() for t in loop], got[:3])
    kw = dict(max_new_tokens=20, do_sample=False, pad_id=0, spec_tokens=2,
              spec_probe=100)
    want, got = _both(jllm, params, llm, ids, mask, **kw)
    _assert_same(want, got)
    assert int(got[3]) > 8


def test_auto_rule_and_fallbacks(tiny):
    """spec_tokens=None: K=2 for greedy decode (verify steps counted, the
    per-token loop's tokens), the per-token loop when sampling; drafts
    stay off under a repetition penalty, a sliding window and a budget
    of one token (the iterations are per-token steps), with the loop's
    and JAX's tokens."""
    jllm, params, llm = tiny
    ids, mask = _cyclic_prompt(llm)
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    loop = llm.generate(t_ids, t_mask, max_new_tokens=16, do_sample=False,
                        spec_tokens=0)[0]
    auto = llm.generate(t_ids, t_mask, max_new_tokens=16, do_sample=False,
                        return_spec_iters=True)
    two = llm.generate(t_ids, t_mask, max_new_tokens=16, do_sample=False,
                       spec_tokens=2, return_spec_iters=True)
    assert torch.equal(auto[0], loop) and auto[2] == two[2] < 15
    sampled = llm.generate(t_ids, t_mask, max_new_tokens=6, do_sample=True,
                           temperature=1.0, return_spec_iters=True,
                           generator=torch.Generator().manual_seed(0))
    assert sampled[2] == 6        # per-token steps: no drafts

    ids, mask = _prompt(b=2)
    for overrides, kw in (({}, dict(repetition_penalty=1.3)),
                          ({"sliding_window": 4}, {}),
                          ({}, dict(max_new_tokens=1))):
        jl, pr, lm = (jllm, params, llm) if not overrides else _pair(
            **overrides)
        kw = dict(dict(max_new_tokens=8, do_sample=False, pad_id=0), **kw)
        want, got = _both(jl, pr, lm, ids, mask, spec_tokens=3, **kw)
        _assert_same(want, got, str(overrides or kw))
        off = lm.generate(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), spec_tokens=0,
                          return_spec_iters=True, **kw)
        np.testing.assert_array_equal(got[0], off[0].numpy())
        assert int(got[3]) == off[2]     # the same per-token steps
    with_state = llm.generate(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask), max_new_tokens=4,
                              do_sample=False, return_decode_state=True)
    assert with_state[2] is None          # drafted: no reusable state


@pytest.mark.parametrize("top_p,top_k", [(0.9, 0), (1.0, 8), (1.0, 0)])
def test_sampled_marginals_match_the_loop(tiny, top_p, top_k):
    """Per-position marginals over 2048 rows of one prompt: drafts on
    (K=3) against the per-token loop, within tests/test_speculative.py's
    bound, 1.5 x the loop's own seed-to-seed total variation + 0.05."""
    _, _, llm = tiny
    n = 2048
    ids = torch.tensor([[5, 9, 33, 70]]).repeat(n, 1)
    mask = torch.ones_like(ids)
    kw = dict(max_new_tokens=4, do_sample=True, temperature=1.0,
              top_p=top_p, top_k=top_k, pad_id=0)

    def draw(seed, spec):
        return llm.generate(ids, mask, spec_tokens=spec,
                            generator=torch.Generator().manual_seed(seed),
                            **kw)[0].numpy()

    base, base2, out = draw(3, 0), draw(5, 0), draw(4, 3)
    for pos in range(4):
        hb = np.bincount(base[:, pos], minlength=VOCAB) / n
        hb2 = np.bincount(base2[:, pos], minlength=VOCAB) / n
        hs = np.bincount(out[:, pos], minlength=VOCAB) / n
        tv = 0.5 * np.abs(hb - hs).sum()
        tv_floor = 0.5 * np.abs(hb - hb2).sum()
        assert tv < 1.5 * tv_floor + 0.05, \
            f"pos {pos}: TV {tv:.3f} vs floor {tv_floor:.3f}"


def test_sampled_spec_respects_the_budget(tiny):
    """Sampled decoding with drafts: [B, max_new] tokens in the
    vocabulary, a seeded generator giving the same tokens twice."""
    _, _, llm = tiny
    ids, mask = _prompt(b=2)
    outs = [llm.generate(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         max_new_tokens=7, do_sample=True, temperature=0.8,
                         pad_id=0, spec_tokens=4,
                         generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2)]
    assert outs[0].shape == (2, 7)
    assert 0 <= int(outs[0].min()) and int(outs[0].max()) < VOCAB
    assert torch.equal(outs[0], outs[1])
