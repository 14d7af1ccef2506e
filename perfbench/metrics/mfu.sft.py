"""The whole training step's share of the card's bf16 peak over the traced
window (whole micro steps): for each traced micro step, the LLM's forward
(2 N a real token) and the frozen base's input gradients (2 N), the
causal attention pairs of the real tokens forward and backward, and the
graph losses (the denoiser on each design graph and the GIN predictor,
forward and input gradients; GraphCLIP forward), over the window's length
x 989 TFLOP/s, in %. Recomputation is not counted."""

from perfbench import bounds, flops


def read(run):
    t, sh = run.trace, run.shapes
    if not t or not t.get("batches") or not t.get("window_s"):
        return None
    llm, n = sh["llm"], sh["llm_params"]
    dit, pred, clip = sh["graphdit"], sh["predictor"], sh["graphclip"]
    total = 0.0
    for width, lengths in t["batches"]:
        total += 2 * flops.llm_tokens(n, sum(lengths))
        total += flops.attention(llm, sum(flops.causal_pairs(L)
                                          for L in lengths), backward=True)
        rows = len(lengths)
        nodes = dit["max_n_nodes"]
        total += 3 * rows * flops.denoiser(dit, sh["xdim"])
        total += 3 * rows * flops.gin(pred["num_layer"], pred["hidden_size"],
                                      nodes)
        total += 2 * rows * flops.gin(clip["num_layer"], clip["hidden_size"],
                                      nodes)
    return total / (t["window_s"] * bounds.MFU_PEAK_FLOPS) * 100.0
