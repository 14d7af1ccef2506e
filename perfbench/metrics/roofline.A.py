"""Kernel A (ops/fused_attention.py, its split-TF32 body on the f32
GraphDiT): the least time its traced launches could take
(bounds.attention_bound at the sampler's shape: 2 x batch graphs under
guidance, max_n_nodes, the denoiser's heads) over their device time in
the trace, in %. Nothing is read when the trace holds another number of
the kernel's events than its launch counter counted."""

from perfbench import bounds, trace


def read(run):
    t = run.trace
    if not t:
        return None
    n, sec = trace.kernel_time(t, "attention_tf32x3")
    if not n or n != t.get("a_launches") or sec <= 0:
        return None
    dit = run.shapes["graphdit"]
    heads = dit["num_heads"]
    bound_ms, _ = bounds.attention_bound(
        run.shapes["sampler_rows"], dit["max_n_nodes"], heads,
        dit["hidden_size"] // heads, "float32", True)
    return n * bound_ms * 1e-3 / sec * 100.0
