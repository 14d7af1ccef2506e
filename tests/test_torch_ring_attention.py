"""Ring attention of llamole_tpu_torch (ops/ring_attention.py) against
llamole_tpu's ring_attention (f32, CPU).

Gloo ranks (parallel/dryrun.py launch, each a process of
tests/torch_ep_sp_worker.py importing no JAX, 120 s a launch) run the
port's multi-controller ring on sp:2, sp:4 and dp:2,sp:2 over one batch
drawn with numpy (B 4, S 16, 2 heads of 8; keys padded at the left of
one row and at the right of another, so a rank's whole block can be
padding): each rank's output block and its q / k / v gradients (of the
output against a drawn cotangent) are assembled into the whole arrays
and held within 1e-5 to JAX's ring_attention on the same mesh string
(conftest's 8 virtual CPU devices), to jax.grad through it, and to plain
causal attention. One rank (no sp group) is the same function: its
forward and backward equal plain attention's too.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.ops.ring_attention import ring_attention as jax_ring
from llamole_tpu.parallel import mesh_from_string as jax_mesh_from_string
from llamole_tpu_torch.ops.ring_attention import ring_attention
from llamole_tpu_torch.parallel import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 120
ATOL = 1e-5
MESHES = {"sp:2": 2, "sp:4": 4, "dp:2,sp:2": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(b=4, s=16, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    arrs = {n: rng.normal(size=(b, s, h, d)).astype(np.float32)
            for n in ("q", "k", "v", "cot")}
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0          # left padding: rank 0's block of sp:4 dead
    mask[2, -6:] = 0         # right padding
    arrs["mask"] = mask
    return arrs


def _plain(q, k, v, mask):
    """Causal attention over the whole sequence in f64 (torch)."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    allowed = (torch.ones(s, s, dtype=torch.bool).tril()[None, None]
               & (mask > 0)[:, None, None, :])
    logits = torch.where(allowed, logits, -1e30)
    p = torch.where(allowed, torch.softmax(logits, -1), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.fixture(scope="module")
def arrays():
    return _draw()


@pytest.fixture(scope="module")
def plain(arrays):
    """Plain attention's output and q / k / v gradients (f64)."""
    q, k, v = (torch.from_numpy(arrays[n]).double().requires_grad_(True)
               for n in ("q", "k", "v"))
    out = _plain(q, k, v, torch.from_numpy(arrays["mask"]))
    out.backward(torch.from_numpy(arrays["cot"]).double())
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.fixture(scope="module")
def launched(arrays, tmp_path_factory):
    """Every mesh's ranks, side by side on threads."""
    from concurrent.futures import ThreadPoolExecutor
    work = tmp_path_factory.mktemp("ring")
    torch.save({n: torch.from_numpy(a) for n, a in arrays.items()},
               work / "data.pt")

    def go(spec):
        out = work / spec.replace(":", "").replace(",", "_")
        out.mkdir()
        dryrun.launch("torch_ep_sp_worker:ring", MESHES[spec],
                      {"mesh": spec, "data": str(work / "data.pt"),
                       "out": str(out)},
                      timeout=LIMIT, workdir=str(out / "ranks"), path=[HERE])
        return [torch.load(out / f"rank{r}.pt")
                for r in range(MESHES[spec])]

    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {spec: pool.submit(go, spec) for spec in MESHES}
        yield futures


def _assemble(ranks, arrays):
    """The ranks' blocks joined into the whole output and gradients."""
    out = np.zeros_like(arrays["q"])
    grads = [np.zeros_like(arrays["q"]) for _ in range(3)]
    for r in ranks:
        rows, cols = slice(*r["rows"]), slice(*r["cols"])
        out[rows, cols] = r["out"].numpy()
        for g, got in zip(grads, r["grads"]):
            g[rows, cols] = got.numpy()
    return out, grads


def _jax(arrays, spec):
    mesh = jax_mesh_from_string(spec)
    q, k, v, cot = (jnp.asarray(arrays[n]) for n in ("q", "k", "v", "cot"))
    mask = jnp.asarray(arrays["mask"])

    def f(q, k, v):
        out = jax_ring(q, k, v, mask, mesh)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("spec", list(MESHES))
def test_ring_matches_jax_and_plain_attention(arrays, plain, launched,
                                              spec):
    """The port's ring on the mesh: output and q / k / v gradients within
    1e-5 of JAX's ring on the same mesh (jax.grad) and of plain causal
    attention."""
    got, got_grads = _assemble(launched[spec].result(), arrays)
    want, want_grads = _jax(arrays, spec)
    np.testing.assert_allclose(got, want, atol=ATOL, err_msg=spec)
    np.testing.assert_allclose(got, plain[0], atol=ATOL, err_msg=spec)
    for name, g, w, p in zip("qkv", got_grads, want_grads, plain[1]):
        assert np.abs(w).max() > 1e-3, name
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"{spec} d{name}")
        np.testing.assert_allclose(g, p, atol=ATOL, err_msg=f"{spec} d{name}")


def test_one_rank_is_plain_attention(arrays, plain):
    """Without an sp group the ring is one block: forward and backward
    equal plain causal attention's, and the output keeps q's dtype."""
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, torch.from_numpy(arrays["mask"]))
    out.backward(torch.from_numpy(arrays["cot"]))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), plain[0], atol=ATOL)
    for t, p in zip((q, k, v), plain[1]):
        np.testing.assert_allclose(t.grad.numpy(), p, atol=ATOL)
    bf = ring_attention(*(t.detach().bfloat16() for t in (q, k, v)), None)
    assert bf.dtype == torch.bfloat16
