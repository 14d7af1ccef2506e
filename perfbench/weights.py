"""Weights drawn from the seed on the card, the same tensors for the
program and for the plain reference.

`spec(cfg, dims)` lists every tensor of the composite model (name, shape,
dtype, init) from the configuration file's sizes alone; the names are
the state-dict names of llamole_tpu_torch's GraphLM, so `load_into` can
fill the port's modules and `tensors` can hand the reference the same
values. Tensors are drawn in groups (the embedding, the head, each
decoder layer, each graph module, the connectors): one torch.Generator
on the device per group, seeded from (seed, group), and one randn call
for the whole group in the dtype the tensor is served in, sliced and
scaled. So any group can be drawn again alone, in the same bits.
"""

import hashlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for one group of one run's draws."""
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _linear(name, out, inp, dtype, bias, lora=None):
    """(name, shape, dtype, init) of a projection, its bias and adapter.
    init: ("normal", std), ("ones", std) = 1 + std * N, ("zeros",)."""
    rows = [(f"{name}.weight", (out, inp), dtype, ("normal", inp ** -0.5))]
    if bias:
        rows.append((f"{name}.bias", (out,), dtype, ("normal", 0.02)))
    if lora is not None:
        rank, b_std, lora_dtype = lora
        rows.append((f"{name}.lora_a", (rank, inp), lora_dtype,
                     ("normal", 1.0 / rank)))
        rows.append((f"{name}.lora_b", (out, rank), lora_dtype,
                     ("normal", b_std) if b_std else ("zeros",)))
    return rows


def _norm(name, dim, dtype, bias=True):
    rows = [(f"{name}.weight", (dim,), dtype, ("ones", 0.05))]
    if bias:
        rows.append((f"{name}.bias", (dim,), dtype, ("normal", 0.02)))
    return rows


def _norm_mlp(name, inp, hid, out, dtype):
    return (_linear(f"{name}.fc1", hid, inp, dtype, True)
            + _norm(f"{name}.norm", hid, dtype)
            + _linear(f"{name}.fc2", out, hid, dtype, True))


def llm_groups(llm: dict, lora_rank: int, lora_b_std: float,
               lora_dtype: str):
    """[(group, rows)] of the decoder: the embedding, each layer, the
    final norm and the head."""
    dt = llm["dtype"]
    h, inter = llm["hidden_size"], llm["intermediate_size"]
    hd = llm.get("head_dim") or h // llm["num_heads"]
    q, kv = llm["num_heads"] * hd, llm["num_kv_heads"] * hd
    bias = llm["attention_bias"]
    lora = (lora_rank, lora_b_std, lora_dtype)
    groups = [("llm.embed", [("llm.embed.weight", (llm["vocab_size"], h), dt,
                              ("normal", 0.02))])]
    for i in range(llm["num_layers"]):
        p = f"llm.layers.{i}"
        rows = _norm(f"{p}.input_norm", h, dt, bias=False)
        rows += _linear(f"{p}.attn.q", q, h, dt, bias, lora)
        rows += _linear(f"{p}.attn.k", kv, h, dt, bias, lora)
        rows += _linear(f"{p}.attn.v", kv, h, dt, bias, lora)
        rows += _linear(f"{p}.attn.o", h, q, dt, False, lora)
        rows += _norm(f"{p}.post_norm", h, dt, bias=False)
        rows += _linear(f"{p}.mlp.gate", inter, h, dt, False, lora)
        rows += _linear(f"{p}.mlp.up", inter, h, dt, False, lora)
        rows += _linear(f"{p}.mlp.down", h, inter, dt, False, lora)
        groups.append((p, rows))
    groups.append(("llm.final_norm",
                   _norm("llm.final_norm", h, dt, bias=False)))
    groups.append(("llm.lm_head", [("llm.lm_head.weight",
                                    (llm["vocab_size"], h), dt,
                                    ("normal", h ** -0.5))]))
    return groups


def denoiser_rows(dit: dict, xdim: int, dtype: str):
    p = "graph_decoder.denoiser"
    h, n, edim = dit["hidden_size"], dit["max_n_nodes"], dit["Edim"]
    in_dim = xdim + n * edim
    rows = _linear(f"{p}.x_embedder.linear", h, in_dim, dtype, False)
    rows += _norm(f"{p}.x_embedder.norm", h, dtype)
    rows += _linear(f"{p}.t_embedder.fc1", h, 256, dtype, True)
    rows += _linear(f"{p}.t_embedder.fc2", h, h, dtype, True)
    rows.append((f"{p}.y_embedder.null_embedding", (dit["ydim"], h), dtype,
                 ("normal", 1.0)))
    for d in range(dit["ydim"]):
        rows += _linear(f"{p}.y_embedder.mlps.{d}.fc1", h, 1, dtype, True)
        rows += _linear(f"{p}.y_embedder.mlps.{d}.fc2", h, h, dtype, False)
    rows.append((f"{p}.txt_embedder.null_embedding", (1, h), dtype,
                 ("normal", 1.0)))
    rows += _linear(f"{p}.txt_embedder.linear", h, dit["text_dim"], dtype,
                    True)
    dh = h // dit["num_heads"]
    mlp = int(h * dit["mlp_ratio"])
    for j in range(dit["depth"]):
        b = f"{p}.blocks.{j}"
        rows += _linear(f"{b}.attn.qkv", 3 * h, h, dtype, False)
        rows += _norm(f"{b}.attn.q_norm", dh, dtype)
        rows += _norm(f"{b}.attn.k_norm", dh, dtype)
        rows += _linear(f"{b}.attn.proj", h, h, dtype, True)
        rows += _linear(f"{b}.mlp.fc1", mlp, h, dtype, True)
        rows += _linear(f"{b}.mlp.fc2", h, mlp, dtype, True)
        rows += _linear(f"{b}.ada_fc1", h, h, dtype, True)
        rows += _linear(f"{b}.ada_fc2", 6 * h, h, dtype, True)
    o = f"{p}.output_layer"
    rows += _linear(f"{o}.decoder.fc1", h, h, dtype, True)
    rows += _linear(f"{o}.decoder.fc2", in_dim, h, dtype, True)
    rows += _linear(f"{o}.ada_fc1", h, h, dtype, True)
    rows += _linear(f"{o}.ada_fc2", 2 * in_dim, h, dtype, True)
    return rows


def gin_rows(prefix: str, gin: dict, dtype: str, predictor: bool):
    """GraphCLIP (predictor False) or the template predictor."""
    h, layers = gin["hidden_size"], gin["num_layer"]
    rows = [(f"{prefix}.atom_encoder", (118, h), dtype, ("normal", 1.0)),
            (f"{prefix}.virtualnode", (h,), dtype, ("normal", 0.02))]
    if predictor:
        rows.append((f"{prefix}.text_dropping", (1, gin["text_input_size"]),
                     dtype, ("normal", 1.0)))
    for l in range(layers):
        c = f"{prefix}.convs.{l}"
        rows.append((f"{c}.bond_embedding", (5, h), dtype, ("normal", 1.0)))
        rows.append((f"{c}.eps", (), dtype, ("normal", 0.1)))
        rows += _norm_mlp(f"{c}.mlp", h, 4 * h, h, dtype)
    if predictor:
        for l in range(layers):
            rows += _linear(f"{prefix}.adapters.{l}", 3 * h,
                            gin["text_input_size"], dtype, True)
    else:
        for l in range(layers):
            rows += _norm(f"{prefix}.norms.{l}", h, dtype)
    for l in range(layers - 1):
        rows += _norm_mlp(f"{prefix}.vn_mlps.{l}", h, 4 * h, h, dtype)
    if predictor:
        rows += _norm_mlp(f"{prefix}.decoder", h, 4 * h, gin["out_dim"],
                          dtype)
    else:
        rows += _norm_mlp(f"{prefix}.projection", h, h, h, dtype)
    return rows


def spec(cfg: dict, xdim: int, lora_b_std: float
         ) -> List[Tuple[str, list]]:
    """[(group, [(name, shape, dtype name, init)])] of the whole model.
    xdim: the GraphDiT's active atom types (from the corpus)."""
    llm, dit = cfg["llm"], cfg["graphdit"]
    gdt = cfg["graph_dtype"]
    lm_h, text = llm["hidden_size"], dit["text_dim"]
    clip, pred = cfg["graphclip"], cfg["predictor"]
    groups = llm_groups(llm, cfg["lora_rank"], lora_b_std, cfg["lora_dtype"])
    groups.append(("graph_decoder", denoiser_rows(dit, xdim, gdt)))
    groups.append(("graph_encoder", gin_rows("graph_encoder", clip, gdt,
                                             False)))
    groups.append(("graph_predictor", gin_rows("graph_predictor", pred, gdt,
                                               True)))
    conn = _linear("connectors.graph_to_lm", lm_h, clip["hidden_size"],
                   "float32", True)
    conn += _linear("connectors.lm_to_graph_decoder", text, lm_h, "float32",
                    True)
    conn += _linear("connectors.lm_to_graph_predictor",
                    pred["text_input_size"], lm_h, "float32", True)
    groups.append(("connectors", conn))
    return groups


def draw_group(seed: int, group: str, rows, device
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of one group, from one generator and one randn call
    per dtype."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    by_dtype: Dict[str, list] = OrderedDict()
    for row in rows:
        by_dtype.setdefault(row[2], []).append(row)
    for dtype, part in by_dtype.items():
        total = sum(_numel(shape) for _, shape, _, _ in part)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=DTYPES[dtype])
        off = 0
        for name, shape, _, init in part:
            n = _numel(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if init[0] == "zeros":
                t.zero_()
            elif init[0] == "ones":
                t.mul_(init[1]).add_(1.0)
            else:
                t.mul_(init[1])
            yield name, t


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def load_into(model: torch.nn.Module, groups, seed: int) -> int:
    """Fill every parameter of `model` (the port's GraphLM) from the draws,
    group by group; a parameter the spec lacks, or one of another shape or
    dtype, raises. Returns the number of tensors filled."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    filled = set()
    for group, rows in groups:
        for name, t in draw_group(seed, group, rows, device):
            p = params.get(name)
            if p is None:
                raise KeyError(f"the model has no parameter {name}")
            if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
                raise ValueError(f"{name}: the model holds {tuple(p.shape)} "
                                 f"{p.dtype}, the draw {tuple(t.shape)} "
                                 f"{t.dtype}")
            p.copy_(t)
            filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no draw for the model's {missing[:5]}")
    return len(filled)


def tensors(groups, seed: int, device, prefixes=None,
            dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the groups whose name starts with one of
    `prefixes` (all of them when None), drawn as the program gets them
    and then cast to `dtype` (float32 for the reference)."""
    out = {}
    for group, rows in groups:
        if prefixes is not None and not group.startswith(tuple(prefixes)):
            continue
        for name, t in draw_group(seed, group, rows, device):
            out[name] = t.to(dtype)
    return out
