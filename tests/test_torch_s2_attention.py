"""LongLoRA S²-attn in llamole_tpu_torch against llamole_tpu (f32, CPU).

`s2_attention` against JAX `_s2_attention` on tests/test_s2_attention.py's
cases (groups of the unshifted heads, causality within groups, GQA,
padding on the shifted heads) and its gradients against jax.grad;
`LLM.forward(train=True)` with shift_attn against JAX's forward; the gate
(S²-attn or full attention) picks JAX's path for an undivisible length,
a softcap / sliding-window family, eval and the cached path, which the
call counter shows. Under tensor parallelism (tp:2 over gloo ranks,
parallel/dryrun.py launch of tests/torch_ep_sp_worker.py) each rank
shifts the heads whose global index is in the second half: the loss and
the adapter's gradients equal JAX's forward(train=True) and the
mesh-less port's.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm import init_lora
from llamole_tpu.models.gllm.model import _s2_attention
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import lm_loss, s2_attention
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.weights import llm_state_dict

ATOL = 1e-5    # attention outputs and their gradients (f32)
LOGIT_ATOL = 1e-4

# (b, s, h, kv, d, group, padding): tests/test_s2_attention.py's cases
CASES = {
    "first_group": (2, 16, 4, 4, 8, 4, None),
    "causal": (1, 16, 4, 4, 8, 4, None),
    "gqa": (1, 8, 4, 2, 8, 4, None),
    "shifted_padding": (1, 16, 4, 4, 8, 4, "trailing"),
    "left_padding": (2, 16, 4, 2, 8, 8, "leading"),
}


def _qkv(case, seed):
    b, s, h, kv, d, group, padding = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    if padding == "trailing":
        mask[:, -4:] = 0
    elif padding == "leading":
        mask[1, :5] = 0
    return q, k, v, mask, group


@pytest.mark.parametrize("case", list(CASES))
def test_s2_attention_matches_jax(case):
    """Outputs and the gradients of q, k, v equal JAX's (f32, 1e-5)."""
    q, k, v, mask, group = _qkv(case, 0)
    w = np.random.default_rng(1).normal(
        size=(q.shape[0], q.shape[1], q.shape[2] * q.shape[3])).astype(
        np.float32)

    def jax_loss(q, k, v):
        out = _s2_attention(q, k, v, jnp.asarray(mask), group)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    calls = s2_attention.calls
    got = s2_attention(tq, tk, tv, torch.from_numpy(mask), group)
    assert s2_attention.calls == calls + 1
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   rtol=0)


def test_s2_padding_keeps_pad_keys_out():
    """Poisoned padded keys leave every valid position's output of both
    head halves unchanged (the rolled per-group key mask)."""
    q, k, v, mask, group = _qkv("shifted_padding", 3)
    base = s2_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                        group)
    k[:, -4:] = 1e4
    v[:, -4:] = 1e4
    pert = s2_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                        group)
    torch.testing.assert_close(base[:, :-4], pert[:, :-4], atol=1e-5,
                               rtol=1e-5)


def _pair(**overrides):
    jcfg = replace(JaxLLMConfig.tiny(), shift_attn=True, **overrides)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        init_lora(jax.random.PRNGKey(2), jcfg, rank=4))
    model = LLM(replace(LLMConfig.tiny(), shift_attn=True, **overrides),
                dtype=torch.float32)
    model.add_lora(4, 2.0)
    model.load_state_dict(llm_state_dict(params, lora))
    return jcfg, params, lora, model


def _tokens(b, s, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 5:] = 0          # right padding, as the collator pads
    return ids, mask


def _both(jcfg, params, lora, model, s, train):
    ids, mask = _tokens(2, s)
    want, _, _ = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask), lora=lora,
                             lora_scale=2.0, train=train)
    calls = s2_attention.calls
    got, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    return s2_attention.calls - calls


def test_forward_train_with_shift_attn_matches_jax():
    """LLM.forward(train=True) with shift_attn at a length that divides
    (16: groups of 4): logits equal JAX's, S²-attn ran in every layer,
    and differ from the full-attention eval forward, which runs none;
    the logits' gradients reach the adapter."""
    jcfg, params, lora, model = _pair()
    assert _both(jcfg, params, lora, model, 16, True) == jcfg.num_layers
    assert _both(jcfg, params, lora, model, 16, False) == 0
    ids, mask = (torch.from_numpy(a) for a in _tokens(2, 16))
    train, _, _ = model(input_ids=ids.long(), attention_mask=mask,
                        train=True)
    with torch.no_grad():
        full, _, _ = model(input_ids=ids.long(), attention_mask=mask)
    assert float((train - full).abs().max()) > 1e-4
    train.square().sum().backward()
    assert float(model.layers[0].attn["q"].lora_a.grad.abs().sum()) > 0


@pytest.mark.parametrize("what, s, overrides", [
    ("undivisible", 11, {}),            # int(11 / 4) = 2, 11 % 2 != 0
    ("short", 7, {}),                   # int(7 / 4) = 1 < 2
    ("group_ratio", 12, {"group_size_ratio": 0.5}),  # groups of 6: S²
    ("softcap", 16, {"attn_logit_softcap": 5.0}),
    ("window", 16, {"sliding_window": 4}),
])
def test_gate_takes_jax_path(what, s, overrides):
    """The gate falls back to full attention where JAX's does, without a
    word (no S² call), and takes S²-attn where it divides."""
    jcfg, params, lora, model = _pair(**overrides)
    calls = _both(jcfg, params, lora, model, s, True)
    assert calls == (jcfg.num_layers if what == "group_ratio" else 0)


def test_generation_never_runs_s2():
    """The cached path (prefill and decode) attends fully."""
    _, _, _, model = _pair()
    ids, mask = (torch.from_numpy(a) for a in _tokens(2, 16))
    calls = s2_attention.calls
    model.generate(ids.long(), mask, max_new_tokens=4, do_sample=False,
                   spec_tokens=0)
    assert s2_attention.calls == calls


def test_s2_under_tp_matches_jax_and_the_mesh_less_port(tmp_path):
    """tp:2 with GQA (4 query heads and 2 KV heads: each rank 2 and 1, so
    rank 0 holds the unshifted half and rank 1 the shifted one): the
    training forward's LM loss (1e-5) and the adapter's gradients (1e-4)
    equal jax.grad through JAX's forward(train=True) and the mesh-less
    port's; S²-attn ran in every layer on every rank."""
    jcfg, params, lora, model = _pair()
    ids, mask = _tokens(2, 16)
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    torch.save({"cfg": model.cfg, "state": model.state_dict(),
                "ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
                "labels": torch.from_numpy(labels)}, tmp_path / "data.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    dryrun.launch("torch_ep_sp_worker:s2", 2,
                  {"mesh": "tp:2", "data": str(tmp_path / "data.pt"),
                   "out": str(tmp_path)}, timeout=120,
                  workdir=str(tmp_path / "ranks"), path=[here])
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    j_params = jax.tree.map(jnp.asarray, params)

    def j_loss(lo):
        logits, _, _ = jax_forward(j_params, jcfg,
                                   input_ids=jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask), lora=lo,
                                   lora_scale=2.0, train=True)
        return jax_lm_loss(logits, jnp.asarray(labels))

    want, want_g = jax.jit(jax.value_and_grad(j_loss))(
        jax.tree.map(jnp.asarray, lora))
    want_g = {n: t for n, t in llm_state_dict(
        params, jax.tree.map(np.asarray, want_g)).items() if "lora_" in n}
    for p in model.parameters():
        p.requires_grad_(False)
    for n, p in model.named_parameters():
        p.requires_grad_("lora_" in n)
    logits, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask), train=True)
    plain = lm_loss(logits, torch.from_numpy(labels))
    plain.backward()
    for r in ranks:
        assert r["s2_calls"] == jcfg.num_layers
        np.testing.assert_allclose(r["loss"], float(want), rtol=1e-5)
        np.testing.assert_allclose(r["loss"], float(plain.detach()),
                                   rtol=1e-5)
    got = ranks[0]["grads"]
    assert set(got) == set(want_g)
    for n, p in model.named_parameters():
        if "lora_" not in n:
            continue
        np.testing.assert_allclose(got[n].numpy(), want_g[n].numpy(),
                                   atol=1e-4, err_msg=n)
        np.testing.assert_allclose(got[n].numpy(), p.grad.numpy(),
                                   atol=1e-4, err_msg=n)
