"""The LLM's flash route in llamole_tpu_torch against llamole_tpu (f32, CPU).

JAX's route (`_flash_attention`) calls jaxlib's Pallas TPU flash kernels;
here they run in TPU interpret mode. The port's route runs kernel E on the
card and its plain version (`flash_attention_reference`) on the CPU,
which these tests reach by forcing both gates: JAX's `_flash_ok` with its
platform clause dropped, the port's `flash_ok` with its device clause
read as CUDA (monkeypatched here; neither package changes).

- the plain version's output and dq / dk / dv against JAX's interpret-mode
  forward and custom VJP, padded rows included (segment semantics: a pad
  query attends the pad keys at or before it), and in bf16 the card's
  gate for kernel E between the two;
- a 2-layer LLM (head_dim 128) with the JAX weights carried through
  weights.py: its flash-route logits against JAX's flash forward, and its
  LoRA gradients of a loss over real rows against JAX's einsum path;
- the gate takes the flash route exactly where JAX's decoder_layer does;
- remat recomputes the route with the same gradients;
- on gloo meshes (dp:2,tp:2, where the route sees this rank's heads, and
  the GPipe stages of pp:2) the route's loss and LoRA gradients equal the
  mesh-less route's.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, replace

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
from llamole_tpu.models.gllm.model import make_kv_cache as jax_kv_cache
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.model import lm_loss, make_kv_cache
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.ops.flash_attention import flash_attention_reference
from llamole_tpu_torch.weights import llm_state_dict

ATOL = 2e-5         # attention outputs and their gradients (f32)
LOGIT_ATOL = 1e-4
GRAD_ATOL = 1e-4
MESH_REL = 1e-5     # the mesh runs' loss against the mesh-less one
HERE = os.path.dirname(os.path.abspath(__file__))

# (b, s, h, kv, d)
SHAPES = [(2, 256, 4, 2, 128), (1, 256, 2, 1, 256)]


def _segments(b, s):
    """Row 0 left-padded; row 1 right-padded. A single row is padded at
    both ends, so its trailing pads share segment 0 with its leading ones."""
    mask = np.ones((b, s), np.int32)
    mask[0, :9] = 0
    if b > 1:
        mask[1, s - 13:] = 0
    else:
        mask[0, s - 13:] = 0
    return mask


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


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_jax_interpret_kernels(shape):
    """flash_attention_reference and its autograd against JAX's
    _flash_attention with jaxlib's Pallas forward, dkv and dq kernels in
    interpret mode: output and dq / dk / dv within 2e-5, pad rows too."""
    b, s, h, kv, d = shape
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    w = rng.normal(size=(b, s, h * d)).astype(np.float32)
    mask = _segments(b, s)

    def jax_loss(q, k, v):
        out = jax_model._flash_attention(q, k, v, jnp.asarray(mask), None)
        return jnp.sum(out * w), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), grads = _interpret(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention_reference(tq, tk, tv, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for name, t, g in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_reference_in_bf16_passes_the_card_gate_with_jax_kernels():
    """In bf16 the plain version keeps jaxlib's rounding points (P cast to
    v's dtype, delta from the bf16 output, dS cast after the scale):
    chip_smoke.py's gate for kernel E (flash_gate, each tile of 64
    positions of a head within 2x the other computation's gap to the f32
    result plus a bf16 step) holds it against jaxlib's interpret-mode
    kernels, and those against it, on the same bf16 inputs."""
    import chip_smoke
    b, s, h, kv, d = SHAPES[0]
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in (
        (b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h * d))]
    mask = _segments(b, s)
    q, k, v, w = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)

    def jax_loss(q, k, v, w):
        out = jax_model._flash_attention(q, k, v, jnp.asarray(mask), None)
        return jnp.sum(out.astype(jnp.float32) * w.astype(jnp.float32)), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = _interpret(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True),
            *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
              for t in (q, k, v, w)))
    jaxlib = [torch.from_numpy(np.array(a.astype(jnp.float32)))
              for a in (out, *grads)]
    seg = torch.from_numpy(mask)
    out, grads = chip_smoke._flash_grads(flash_attention_reference, q, k, v,
                                         w, seg)
    exact = chip_smoke._flash_grads(flash_attention_reference,
                                    *(t.float() for t in (q, k, v, w)), seg)
    for name, plain, kern, x in zip(("out", "dq", "dk", "dv"),
                                    (out, *grads), jaxlib,
                                    (exact[0], *exact[1])):
        assert plain.dtype == torch.bfloat16
        assert chip_smoke.flash_gate(plain, kern, x, d, 2.0) <= 1.0, name
        assert chip_smoke.flash_gate(kern, plain, x, d, 2.0) <= 1.0, name


def _configs(**overrides):
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                rope_theta=10000.0, max_position_embeddings=2048,
                rope_scaling=None, use_flash=True, flash_min_seq=128)
    base.update(overrides)
    return JaxLLMConfig(**base), LLMConfig(**base)


def _pair(**overrides):
    jcfg, cfg = _configs(**overrides)
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


def _tokens(b, s, seed=3):
    ids = np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)
    return ids, _segments(b, s)


def _jax_logits(jcfg, params, lora, ids, mask, train=False, **kw):
    logits, _, _ = jax_forward(params, jcfg, input_ids=jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask), lora=lora,
                               lora_scale=2.0, train=train, **kw)
    return np.asarray(logits)


def _port_logits(model, ids, mask, train=False, **kw):
    logits, _, _ = model(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask), train=train,
                         **kw)
    return logits


def test_slice_logits_match_jax_flash_forward(forced, monkeypatch):
    """The 2-layer LLM through the flash route: logits within 1e-4 of
    JAX's flash forward (jaxlib's kernel in interpret mode) on real and
    padded rows, both taking the route in every layer; JAX's einsum path
    differs on the padded rows, where the segments matter."""
    jcfg, params, lora, model = _pair()
    ids, mask = _tokens(2, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_interpret(
            lambda p, lo: jax_forward(p, jcfg, input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      lora=lo, lora_scale=2.0)[0],
            params, lora))
    with torch.no_grad():
        got = _port_logits(model, ids, mask).numpy()
    assert forced == {"port": jcfg.num_layers, "jax": jcfg.num_layers}
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    monkeypatch.setattr(jax_model, "_flash_ok", lambda cfg, s: False)
    einsum = _jax_logits(jcfg, params, lora, ids, mask)
    real = mask > 0
    np.testing.assert_allclose(got[real], einsum[real], atol=LOGIT_ATOL,
                               rtol=0)
    assert np.abs(got[~real] - einsum[~real]).max() > 1e-2


def _real_rows_loss(logits, w, mask):
    """A loss that reads the logits of real tokens only."""
    return (logits * w * mask[..., None]).sum()


def _lora_grads(model, ids, mask, w):
    model.zero_grad(set_to_none=True)
    for n, p in model.named_parameters():
        p.requires_grad_("lora_" in n)
    logits = _port_logits(model, ids, mask, train=True)
    _real_rows_loss(logits, torch.from_numpy(w),
                    torch.from_numpy(mask).float()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if "lora_" in n}


def test_slice_lora_grads_match_jax_einsum_path(forced, monkeypatch):
    """The port's LoRA gradients through the flash route, of a loss over
    real rows, within 1e-4 of jax.grad through JAX's einsum path (real
    rows never see a pad key on either path)."""
    jcfg, params, lora, model = _pair()
    ids, mask = _tokens(2, 128)
    w = np.random.default_rng(4).normal(size=(2, 128, 512)).astype(
        np.float32) * 0.01
    got = _lora_grads(model, ids, mask, w)
    assert forced["port"] == jcfg.num_layers
    j_params = jax.tree.map(jnp.asarray, params)

    def j_loss(lo):
        logits, _, _ = jax_forward(j_params, jcfg,
                                   input_ids=jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask), lora=lo,
                                   lora_scale=2.0, train=True)
        return _real_rows_loss(logits, w, jnp.asarray(mask, jnp.float32))

    monkeypatch.setattr(jax_model, "_flash_ok", lambda cfg, s: False)
    want = jax.jit(jax.grad(j_loss))(jax.tree.map(jnp.asarray, lora))
    want = {n: t for n, t in llm_state_dict(
        params, jax.tree.map(np.asarray, want)).items() if "lora_" in n}
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=n)


# (what, s, config overrides, train, cached)
GATE_CASES = [
    ("flash", 128, {}, False, False),
    ("flash_train", 256, {}, True, False),
    ("below_min_seq", 64, {}, False, False),
    ("not_multiple_of_128", 192, {}, False, False),
    ("head_dim_64", 128, {"head_dim": 64}, False, False),
    ("softcap", 128, {"attn_logit_softcap": 5.0}, False, False),
    ("sliding_window", 128, {"sliding_window": 32}, False, False),
    ("query_scale", 128, {"query_scale": 64.0}, False, False),
    ("s2_wins_in_training", 128, {"shift_attn": True}, True, False),
    ("s2_eval_is_flash", 128, {"shift_attn": True}, False, False),
    ("cached", 128, {}, False, True),
]


@pytest.mark.parametrize("what, s, overrides, train, cached", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_takes_the_route_where_jax_does(forced, monkeypatch, what, s,
                                             overrides, train, cached):
    """The port's flash_ok (device clause read as CUDA) inside its layer
    picks the flash route in the same layers as JAX's decoder_layer with
    _flash_ok minus its platform clause: the gate's own clauses, the
    plain-SDPA clauses, S²-attn first in training, never with a cache."""
    # the route's function itself is not under test: both answer zeros
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
    jcfg, params, lora, model = _pair(num_layers=1, **overrides)
    ids, mask = _tokens(1, s)
    jkw, kw = {}, {}
    if cached:
        jkw = {"kv_cache": jax_kv_cache(jcfg, 1, s, jnp.float32, False),
               "cache_index": jnp.asarray(0)}
        kw = {"kv_cache": make_kv_cache(model.cfg, 1, s, torch.float32,
                                        "cpu"), "cache_index": 0}
    _jax_logits(jcfg, params, lora, ids, mask, train=train, **jkw)
    with torch.no_grad():
        _port_logits(model, ids, mask, train=train, **kw)
    takes = what.startswith("flash") or what == "s2_eval_is_flash"
    assert forced == {"port": jcfg.num_layers * takes,
                      "jax": jcfg.num_layers * takes}
    assert port_model.flash_ok(model.cfg, s, "cpu") == (
        _flash_ok_any_platform(jcfg, s) and port_model.plain_sdpa(jcfg))


def test_flash_ok_is_false_off_the_card():
    """Unforced, the gate is false on the CPU (as JAX's is off the TPU):
    use_flash changes nothing there."""
    _, cfg = _configs()
    assert port_model.flash_ok(cfg, 128, "cuda")
    assert not port_model.flash_ok(cfg, 128, "cpu")
    assert not port_model.flash_ok(replace(cfg, use_flash=False), 128,
                                   "cuda")


def test_remat_recomputes_the_route_with_equal_grads(forced):
    """cfg.remat (torch.utils.checkpoint) runs the route again in the
    backward: the LoRA gradients equal the stored-activation ones."""
    _, _, _, model = _pair()
    ids, mask = _tokens(2, 128)
    w = np.random.default_rng(5).normal(size=(2, 128, 512)).astype(
        np.float32) * 0.01
    plain = _lora_grads(model, ids, mask, w)
    assert forced["port"] == model.cfg.num_layers
    model.cfg.remat = True
    remat = _lora_grads(model, ids, mask, w)
    assert forced["port"] == 3 * model.cfg.num_layers
    for n, g in plain.items():
        torch.testing.assert_close(remat[n], g, atol=1e-6, rtol=0)


# (mesh, microbatches, the route's calls on each rank and the heads they
# see: 2 layers on every tp rank, one stage's layer a microbatch under pp)
MESHES = (("dp:2,tp:2", 1, 2, [2, 1]),
          ("pp:2", 2, 2, [4, 2]))


def test_route_on_tp_and_pp_meshes_matches_the_mesh_less_route(forced,
                                                                tmp_path):
    """Gloo ranks (tests/torch_flash_worker.py, the gate forced there as
    here) take the causal-LM loss of a padded [4, 128] batch through
    pipeline_lm_loss on dp:2,tp:2 (q / k / v hold this rank's 2 heads and
    1 KV head) and on the GPipe stages of pp:2 (2 microbatches): the loss
    within 1e-5 and each stage's LoRA gradients within 1e-4 of the
    mesh-less route's."""
    _, _, _, model = _pair()
    torch.save(model.state_dict(), tmp_path / "state.pt")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 512, size=(4, 128)).astype(np.int64)
    mask = np.ones((4, 128), np.int64)
    mask[0, :9] = 0
    mask[1, 128 - 13:] = 0
    labels = np.where(mask > 0, ids, -100)
    batch = {"input_ids": ids.tolist(), "attention_mask": mask.tolist(),
             "labels": labels.tolist()}

    def run(spec, m):
        return dryrun.launch(
            "torch_flash_worker:flash_loss", 4 if "dp" in spec else 2,
            {"config": asdict(model.cfg), "state": str(tmp_path / "state.pt"),
             "mesh": spec, "microbatches": m, "batch": batch},
            timeout=120, path=[HERE],
            workdir=str(tmp_path / spec.replace(":", "").replace(",", "_")))

    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = [pool.submit(run, spec, m) for spec, m, _, _ in MESHES]
        for n, p in model.named_parameters():
            p.requires_grad_("lora_" in n)
        logits = _port_logits(model, ids, mask, train=True)
        want = lm_loss(logits, torch.from_numpy(labels))
        want.backward()
        assert forced["port"] == model.cfg.num_layers
        grads = {n: p.grad for n, p in model.named_parameters()
                 if "lora_" in n}
        for (spec, _, calls, heads), future in zip(MESHES, futures):
            ranks = future.result()
            got = {}
            for rank in ranks:
                assert rank["calls"] == [heads] * calls, spec
                np.testing.assert_allclose(rank["loss"],
                                           float(want.detach()),
                                           rtol=MESH_REL, err_msg=spec)
                got.update(rank["grads"])
            assert set(got) == set(grads), spec
            for n, g in grads.items():
                np.testing.assert_allclose(np.asarray(got[n]), g.numpy(),
                                           atol=GRAD_ATOL, rtol=0,
                                           err_msg=f"{spec} {n}")
