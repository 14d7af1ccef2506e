"""Kernel E (ops/flash_attention.py: forward, dq, dkv and the group sum):
the least time its traced launches could take (bounds.flash_bound,
forward and backward, at each traced micro step's shape, over the pairs
its rows' segments attend) over their device time in the trace, in %.
Nothing is read when the trace holds another number of the forward, dq
or dkv kernels' events than their launch counters counted."""

from perfbench import bounds, trace


def read(run):
    t = run.trace
    if not t or not t.get("batches") or not t.get("flash_launches"):
        return None
    got = t["flash_launches"]
    for needle, key in (("flash_fwd", "launches_fwd"),
                        ("flash_bwd_dq", "launches_dq"),
                        ("flash_bwd_dkv", "launches_dkv")):
        if trace.kernel_time(t, needle)[0] != got[key] or not got[key]:
            return None
    sec = sum(trace.kernel_time(t, k)[1] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_group_sum"))
    llm = run.shapes["llm"]
    hd = llm.get("head_dim") or llm["hidden_size"] // llm["num_heads"]
    bound_ms = 0.0
    for width, lengths in t["batches"]:
        shape = (len(lengths), width, llm["num_heads"], llm["num_kv_heads"],
                 hd)
        pairs = bounds.flash_pairs(lengths, width)
        bound_ms += llm["num_layers"] * (
            bounds.flash_bound(shape, llm["dtype"], pairs, False)[0]
            + bounds.flash_bound(shape, llm["dtype"], pairs, True)[0])
    if sec <= 0:
        return None
    return bound_ms * 1e-3 / sec * 100.0
