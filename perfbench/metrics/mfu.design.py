"""The whole design step's share of the card's bf16 peak over the traced
window (one whole design batch): the model FLOPs of that batch's generate
calls (prefill over the real prompt tokens, one token a row a decode
step, attention over the context), its query extension and its denoiser
calls (two graphs a row under guidance, each reverse step), over the
window's length x 989 TFLOP/s, in %."""

from perfbench import bounds, flops


def read(run):
    t, sh = run.trace, run.shapes
    if not t or t.get("batch") is None or not t.get("window_s"):
        return None
    llm, n = sh["llm"], sh["llm_params"]
    total = 0.0
    for c in sh.get("generate", []):
        if c["batch"] != t["batch"]:
            continue
        total += flops.llm_tokens(n, sum(c["prompt_tokens"]))
        total += flops.attention(llm, sum(flops.causal_pairs(p)
                                          for p in c["prompt_tokens"]))
        steps = max(c["steps"] - 1, 0)
        total += flops.llm_tokens(n, c["rows"] * steps)
        for p in c["prompt_tokens"]:
            total += flops.attention(llm, steps * p + steps * (steps + 1) // 2)
        if c["kind"] == "analysis":
            q = sh["query_tokens"]
            total += flops.llm_tokens(n, c["rows"] * q)
            for p in c["prompt_tokens"]:
                total += flops.attention(llm, q * (p + steps) + q * (q + 1)
                                         // 2)
    calls = sum(1 for b in sh["sampler_batches"] if b == t["batch"])
    total += (calls * sh["reverse_steps"] * sh["sampler_rows"]
              * flops.denoiser(sh["graphdit"], sh["xdim"]))
    if not total:
        return None
    return total / (t["window_s"] * bounds.MFU_PEAK_FLOPS) * 100.0
