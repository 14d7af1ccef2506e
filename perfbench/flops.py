"""Model FLOPs from shapes, for the whole-step shares of the peak (the
`mfu.*` metrics). A multiply-add is 2 FLOPs. Counted: the work the
model needs for the tokens and graphs a window served, not what the
program runs besides (padding rows, recomputation).

  llm_tokens   2 N a token through the decoder's N non-embedding weights
               (the head included)
  attention    4 d a (query, key) pair in each head and layer (q.k and
               p.v); a backward that forms input gradients adds 8 d
               (dV, dP, dQ, dK)
  denoiser     a graph of n nodes through GraphDiT: its embedders, each
               block's projections, attention and AdaLN, the output layer
  gin          a graph through a GIN stack of width h: each layer's MLP
               (h -> 4h -> h) over its nodes
"""


def llm_tokens(n_params: int, tokens: int) -> float:
    return 2.0 * n_params * tokens


def attention(llm: dict, pairs: int, backward: bool = False) -> float:
    d = llm.get("head_dim") or llm["hidden_size"] // llm["num_heads"]
    per = (12 if backward else 4) * d
    return float(per) * llm["num_heads"] * llm["num_layers"] * pairs


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def denoiser(dit: dict, xdim: int) -> float:
    """One graph's forward."""
    h, n = dit["hidden_size"], dit["max_n_nodes"]
    in_dim = xdim + n * dit["Edim"]
    mlp = int(h * dit["mlp_ratio"])
    per_block = (2 * n * (3 * h * h + h * h + 2 * mlp * h)
                 + 2 * (h * h + 6 * h * h) + 4 * h * n * n)
    embed = 2 * n * in_dim * h + 2 * (256 * h + h * h) + 2 * dit["text_dim"] * h
    out = 2 * n * (h * h + h * in_dim) + 2 * (h * h + 2 * in_dim * h)
    return float(dit["depth"] * per_block + embed + out)


def gin(layers: int, h: int, nodes: int) -> float:
    return float(layers * 2 * nodes * (h * 4 * h + 4 * h * h))
