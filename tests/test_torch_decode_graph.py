"""generate's per-token decode replayed as a CUDA graph (LLM._decode_graph).

On the CPU: the step the graph records, a forward with the cache index as
a [B] tensor, equals the eager loop's step with an int index bit for bit
(logits and cache), for a compute-dtype and an int8 cache and a
sliding-window family; and the graph applies only on the card, to dense
MLPs without W8A8 projections. On the card (marked `gpu`, skipped here):
graphed generate gives the eager loop's tokens, greedy and sampled.
tests/test_torch_llm.py holds the eager loop to the JAX package.

This file imports only torch and the port, so the machine with the card
runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import make_kv_cache
from llamole_tpu_torch.models.gllm.quantize import quantize_llm_params

FAMILIES = {
    "tiny": {},
    "int8_cache": {"kv_cache_dtype": "int8"},
    "gemma2": dict(hidden_act="gelu_tanh", rms_norm_unit_offset=True,
                   scale_embeddings=True, tie_word_embeddings=True,
                   sandwich_norms=True, attn_logit_softcap=5.0,
                   final_logit_softcap=3.0, query_scale=24.0,
                   sliding_window=4),
}


def _llm(device="cpu", dtype=torch.float32, rank=4, **overrides):
    model = LLM(replace(LLMConfig.tiny(), **overrides), dtype=dtype,
                device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    model.reset_parameters(gen)
    model.add_lora(rank, 2.0)
    model.reset_lora(gen)
    with torch.no_grad():   # a nonzero B, so the adapter changes outputs
        for m in model.modules():
            if getattr(m, "lora_b", None) is not None:
                m.lora_b.normal_(generator=gen).mul_(0.05)
    return model


def _prompts(device="cpu", b=3, s=11, seed=3):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 512, size=(b, s))).to(device)
    mask = torch.ones((b, s), dtype=torch.int32, device=device)
    mask[1, :4] = 0       # left padding
    mask[2, :7] = 0
    return ids, mask


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_index_step_equals_the_int_index_step(family):
    model = _llm(**FAMILIES[family])
    ids, mask = _prompts()
    b, p, total = ids.shape[0], ids.shape[1], ids.shape[1] + 4
    positions = (mask.cumsum(-1) - 1).clamp_min(0)
    with torch.no_grad():
        cache = make_kv_cache(model.cfg, b, total, torch.float32, "cpu")
        kv_valid = torch.zeros((b, total), dtype=torch.bool)
        kv_valid[:, :p] = mask > 0
        model(input_ids=ids, attention_mask=mask, positions=positions,
              kv_cache=cache, cache_index=0, kv_valid=kv_valid)
        tok = torch.tensor([[5], [17], [301]])
        pos = positions[:, -1:] + 1
        for t in range(p, total):
            kv_valid[:, t] = True
            twin = [{k: v.clone() for k, v in e.items()} for e in cache]
            want, _, _ = model(input_ids=tok, positions=pos, kv_cache=cache,
                               cache_index=t, kv_valid=kv_valid)
            got, _, _ = model(input_ids=tok, positions=pos, kv_cache=twin,
                              cache_index=torch.full((b,), t),
                              kv_valid=kv_valid)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            for e_got, e_want in zip(twin, cache):
                for name in e_want:
                    torch.testing.assert_close(e_got[name], e_want[name],
                                               rtol=0, atol=0, msg=name)
            tok = want[:, -1].argmax(-1, keepdim=True)
            pos = pos + 1


def test_graphs_apply_on_the_card_to_dense_mlps_without_w8a8():
    card = torch.device("cuda")
    dense = _llm()
    assert not dense._graphs_apply(torch.device("cpu"))
    assert dense._graphs_apply(card)
    dense.decode_graphs = False
    assert not dense._graphs_apply(card)
    assert not _llm(num_experts=4, num_experts_per_tok=2)._graphs_apply(card)
    for bits, act_int8, applies in ((8, False, True), (8, True, False),
                                    (4, False, True)):
        quantized = quantize_llm_params(_llm(dtype=torch.bfloat16),
                                        bits=bits, act_int8=act_int8)
        assert quantized._graphs_apply(card) is applies, (bits, act_int8)


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_graphed_generate_gives_the_eager_tokens(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _llm("cuda", **FAMILIES[family])
    ids, mask = _prompts("cuda")
    runs = {}
    for graphs in (False, True):
        model.decode_graphs = graphs
        before = LLM.graph_replays
        greedy, _ = model.generate(ids, mask, max_new_tokens=12,
                                   do_sample=False, spec_tokens=0)
        sampled, _ = model.generate(
            ids, mask, max_new_tokens=12, temperature=0.6, top_p=0.9,
            generator=torch.Generator(device="cuda").manual_seed(1))
        runs[graphs] = (greedy, sampled, LLM.graph_replays - before)
    assert runs[False][2] == 0 and runs[True][2] > 0
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=0, atol=0)
    torch.testing.assert_close(runs[True][1], runs[False][1], rtol=0, atol=0)
