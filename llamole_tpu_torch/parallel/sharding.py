"""Partition specs of mesh training (counterpart of
llamole_tpu/parallel/sharding.py) and their DTensor / FSDP2 placements.

The three spec functions take the port's parameters by name ({name:
tensor}, the LLM's own names; a quantized projection's w_q / scale
buffers too) and return for each the JAX package's PartitionSpec as a
tuple of axis names, one entry per dimension of the JAX leaf (weights.py's
bridge: a projection's [in, out], the port's [out, in] transposed; int4's
packed [out, in / 2] is JAX's [in, out]; scales [out] or [groups, out] on
both sides), so they equal JAX's spec for spec:

  llm_param_pspecs   Megatron tensor parallelism: q / k / v / gate / up
                     column-parallel (None, tp), o / down row-parallel
                     (tp, None), the embedding vocab-sharded (tp, None),
                     lm_head on its vocab dimension (None, tp); norms,
                     biases and the router replicated (()); MoE experts
                     on ep when it is given (replicated otherwise).
  zero1_opt_pspecs   ZeRO-1: dp on the largest dp-divisible dimension of
                     each optimizer-state leaf (ties: the later one).
  fsdp_param_pspecs  ZeRO-3: dp on the largest dp-divisible dimension not
                     taken by tp / ep, for every leaf of two dimensions
                     or more.

`spec_to_placements` maps a spec onto a mesh's DTensor placements in the
port's orientation. `shard_llm` places the LLM on the tp axis (the
adapter factor on a projection's sharded side follows its base weight:
B [out, r] of a column-parallel projection, A [r, in] of a row-parallel
one, DoRA's magnitude and a column-parallel bias on out; a quantized
base's buffers by their JAX specs, gllm/lora.py's module docstring) and
an MoE LLM's experts on the ep axis: the sharded leaves become DTensors,
the replicated ones stay plain tensors; the per-head q / k norms, whose
one scale every rank's heads use, have their gradient summed over tp.
`fsdp_llm` shards the frozen LLM's storage over dp with FSDP2's
fully_shard, one unit per decoder layer plus the embedding and the
head, `shard_placement_fn` following fsdp_param_pspecs (with ep
composed) and the leaves that spec leaves replicated (norms, the
adapter) ignored; a quantized base's buffers, which FSDP2 does not
manage, are cut to their dp chunks by the same specs and all-gathered
per product (`Zero`), and a tied head reads the frozen embedding's dp
chunks through comm.gathered_linear.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..weights import _llm_path

Spec = Tuple[Optional[str], ...]

_COLUMN = ("q", "k", "v", "gate", "up")
_ROW = ("o", "down")


def _jax_shape(name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The JAX leaf's shape of a port tensor (int4's packed w_q: two
    values a byte along in)."""
    keys, transposed = _llm_path(name)
    shape = tuple(t.shape)
    if keys[-1] == "w_q" and t.dtype == torch.uint8:
        shape = (shape[0], 2 * shape[1])
    return shape[::-1] if transposed and len(shape) == 2 else shape


def _spec_for(name: str, shape, tp_axis: str, ep_axis: Optional[str]
              ) -> Spec:
    keys, _ = _llm_path(name)
    ndim = len(shape)
    if "experts" in keys:
        if ep_axis is None:
            return ()
        return (ep_axis,) + (None,) * (ndim - 1)
    if "router" in keys or ndim <= 1:
        return ()
    if "embed" in keys:
        return (tp_axis, None)
    if "lm_head" in keys:
        return (None, tp_axis)
    owner = keys[-2] if len(keys) >= 2 else ""
    if owner in _COLUMN:
        return (None, tp_axis)
    if owner in _ROW:
        return (tp_axis, None)
    return ()


def llm_param_pspecs(params: Dict[str, torch.Tensor], tp_axis: str = "tp",
                     ep_axis: Optional[str] = None) -> Dict[str, Spec]:
    """{name: JAX spec} of the LLM's base parameters (names as
    LLM.named_parameters() gives them, no adapter; base_tensors adds a
    quantized base's buffers)."""
    return {n: _spec_for(n, p.shape, tp_axis, ep_axis)
            for n, p in params.items()}


def _largest_divisible(shape, dp: int, taken=()) -> Optional[int]:
    cands = [(d, i) for i, d in enumerate(shape)
             if i not in taken and d % dp == 0 and d >= dp]
    return max(cands)[1] if cands else None


def zero1_opt_pspecs(state: Any, dp: int, axis: str = "dp") -> Any:
    """The spec of every tensor leaf of `state` (nested dicts / lists, the
    moments laid out as the JAX bundle tree): dp on its largest
    dp-divisible dimension, () for scalars and indivisible leaves."""
    if isinstance(state, dict):
        return {k: zero1_opt_pspecs(v, dp, axis) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(zero1_opt_pspecs(v, dp, axis) for v in state)
    shape = tuple(getattr(state, "shape", ()))
    best = _largest_divisible(shape, dp) if shape else None
    if best is None:
        return ()
    return tuple(axis if i == best else None for i in range(len(shape)))


def fsdp_param_pspecs(params: Dict[str, torch.Tensor], dp: int,
                      dp_axis: str = "dp", tp_axis: Optional[str] = None,
                      ep_axis: Optional[str] = None) -> Dict[str, Spec]:
    """{name: JAX spec} of ZeRO-3: llm_param_pspecs (when tp_axis or
    ep_axis is given) with dp added on the largest dp-divisible free
    dimension of each leaf of two dimensions or more."""
    out = {}
    for name, p in params.items():
        shape = _jax_shape(name, p)
        spec = (_spec_for(name, shape, tp_axis, ep_axis)
                if tp_axis or ep_axis else ())
        if len(shape) < 2:
            out[name] = spec
            continue
        full = list(spec) + [None] * (len(shape) - len(spec))
        best = _largest_divisible(
            shape, dp, taken={i for i, a in enumerate(full) if a is not None})
        if best is None:
            out[name] = spec
            continue
        full[best] = dp_axis
        out[name] = tuple(full)
    return out


def base_tensors(llm: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the LLM's base: its parameters and its quantized
    projections' w_q / scale buffers, the adapter left out."""
    out = {n: p for n, p in llm.named_parameters() if "lora_" not in n}
    out.update(llm.named_buffers())
    return out


def check_divisible(name: str, t: torch.Tensor, spec: Spec,
                    sizes: Dict[str, int]) -> None:
    """JAX's device_put refusal of a spec that does not divide its leaf
    (the words after the sharding it names)."""
    shape = _jax_shape(name, t)
    for i, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if shape[i] % n:
            raise ValueError(
                f"{name}: the spec {spec} on the mesh {sizes} implies that "
                f"the global size of its dimension {i} should be divisible "
                f"by {n}, but it is equal to {shape[i]} (full shape: "
                f"{shape})")


def port_dim(name: str, jax_dim: int, ndim: int) -> int:
    """The port tensor's dimension of a JAX leaf's dimension."""
    _, transposed = _llm_path(name)
    return ndim - 1 - jax_dim if transposed and ndim == 2 else jax_dim


def spec_to_placements(name: str, spec: Spec, ndim: int,
                       mesh_axes: Sequence[str]):
    """DTensor placements, one per mesh axis, of a port tensor whose JAX
    spec is `spec`: Shard(port dimension) on each axis the spec names,
    Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: port_dim(name, i, ndim) for i, a in enumerate(spec)
             if a is not None}
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_axes]


def shard_params(params: Dict[str, torch.Tensor], mesh,
                 specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """{name: DTensor} of full (replicated, identical on every rank)
    tensors placed on `mesh` by their JAX specs; each rank keeps its
    chunks, without a collective."""
    return {n: _place(t, mesh, spec_to_placements(
        n, specs[n], t.dim(), mesh.mesh_dim_names)) for n, t in params.items()}


def replicate(params: Dict[str, torch.Tensor], mesh
              ) -> Dict[str, torch.Tensor]:
    return shard_params(params, mesh, {n: () for n in params})


def _place(t: torch.Tensor, mesh, placements):
    """DTensor.from_local of this rank's chunk of a full tensor."""
    from torch.distributed.tensor import DTensor, Shard
    local = t.detach()
    coord = mesh.get_coordinate()
    for axis, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.mesh.shape[axis], dim=pl.dim)[
                coord[axis]]
    # a chunk gets storage of its own: a view would keep the whole tensor
    local = local.contiguous() if local.numel() == t.numel() else \
        local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor on every rank (a collective for a sharded
    DTensor): what the checkpoints write."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


@dataclass
class TP:
    """A projection's (or the embedding's, or a q / k norm's)
    tensor-parallel role."""
    style: str       # "col" (output sharded), "row" (input sharded),
    #                  "vocab", "heads" (a norm over this rank's heads)
    group: Any
    size: int
    rank: int


@dataclass
class Zero:
    """ZeRO-3 of a quantized projection's base: the port dimension of w_q
    and of scale whose chunks the dp ranks hold (None: whole on each)."""
    group: Any
    size: int
    q_dim: Optional[int]
    scale_dim: Optional[int]

    def gather(self, q: torch.Tensor, scale: torch.Tensor):
        """This rank's whole (tensor-parallel) w_q and scale from its dp
        chunks."""
        from .comm import all_gather_dim
        if self.q_dim is not None:
            q = all_gather_dim(q, self.q_dim, self.size, self.group)
        if self.scale_dim is not None:
            scale = all_gather_dim(scale, self.scale_dim, self.size,
                                   self.group)
        return q, scale


def _adapter_spec(owner_style: str, leaf: str) -> Optional[int]:
    """The port dimension an adapter leaf shards on, following its base."""
    if owner_style == "col" and leaf in ("lora_b", "lora_m", "bias"):
        return 0
    if owner_style == "row" and leaf == "lora_a":
        return 1
    return None


def shard_llm(llm: nn.Module, groups) -> None:
    """Place the LLM's parameters, and a quantized base's buffers, on the
    tp axis as DTensors (every rank holds the same full LLM before; each
    keeps its chunks) and give each projection, the embedding, the head
    and the q / k norms their TP role. An MoE LLM's experts split their
    expert dimension over ep (whole on every rank when ep is 1) and its
    MoE layers get their MoEMesh (models/gllm/model.py moe_mlp: routing
    over the data ranks, experts over ep); the router stays replicated.
    A spec that does not divide its leaf (say, a row-parallel int4
    projection whose in / tp is not a multiple of the group size) raises
    as JAX's placement does."""
    from torch.distributed.tensor import DTensor, Shard
    from ..models.gllm.lora import LoRALinear
    from ..models.gllm.model import MoEMesh
    cfg = llm.cfg
    tp = groups.tp
    ep = getattr(groups, "ep", 1)
    if cfg.num_experts % ep:
        raise ValueError(f"ep={ep} does not divide the experts "
                         f"({cfg.num_experts})")
    for what, n in (("attention heads", cfg.num_heads),
                    ("kv heads", cfg.num_kv_heads),
                    ("intermediate size", cfg.intermediate_size),
                    ("vocabulary", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the {what} ({n})")
    base = base_tensors(llm)
    specs = llm_param_pspecs(base)
    for name, t in base.items():
        if not isinstance(t, DTensor):
            check_divisible(name, t, specs[name], {"tp": tp})
    mesh = groups.mesh["tp"]
    if cfg.num_experts > 0:
        llm.moe_mesh = MoEMesh(groups.data_group, groups.data,
                               groups.data_rank, groups.ep_group, ep,
                               groups.ep_rank)
        for layer in llm.layers:
            layer.mlp.mesh = llm.moe_mesh
    role = {}
    for name, m in llm.named_modules():
        if isinstance(m, LoRALinear):
            owner = name.split(".")[-1]
            style = ("row" if owner in _ROW else "col")
            m.tp = TP(style, groups.tp_group, tp, groups.tp_rank)
            role[name] = style
    llm.embed.tp = TP("vocab", groups.tp_group, tp, groups.tp_rank)
    llm.tp = llm.embed.tp
    if cfg.qk_norm:
        for layer in llm.layers:
            layer.q_norm.tp = layer.k_norm.tp = TP(
                "heads", groups.tp_group, tp, groups.tp_rank)
    for name in [n for n, _ in llm.named_parameters()]:
        p = llm.get_parameter(name)   # one old parameter alive at a time
        owner, leaf = name.rsplit(".", 1)
        if isinstance(p, DTensor):
            continue
        if ".experts." in name:
            if ep == 1:
                continue     # whole on every rank
            placed = _place(p.data, groups.mesh["ep"], [Shard(0)])
        elif specs.get(name):
            placed = shard_params({name: p.data}, mesh, specs)[name]
        else:
            d = _adapter_spec(role.get(owner, ""), leaf)
            if d is None:
                continue     # replicated leaves stay plain tensors
            placed = _place(p.data, mesh, [Shard(d)])
        setattr(llm.get_submodule(owner), leaf,
                nn.Parameter(placed, requires_grad=p.requires_grad))
    for name, b in list(llm.named_buffers()):
        if specs.get(name) and not isinstance(b, DTensor):
            owner, leaf = name.rsplit(".", 1)
            setattr(llm.get_submodule(owner), leaf,
                    shard_params({name: b}, mesh, specs)[name])


def _dp_chunk(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """A tp-placed DTensor (or a plain tensor, replicated over tp) ->
    the DTensor on the (dp, tp) mesh of this rank's chunk along `dim`
    over dp, the rest freed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tp_place = t.placements[0] if isinstance(t, DTensor) else Replicate()
    chunk = local(t).chunk(groups.dp, dim=dim)[groups.dp_rank].clone(
        memory_format=torch.contiguous_format)
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(chunk, groups.mesh["dp", "tp"],
                              [Shard(dim), tp_place], run_check=False,
                              shape=t.shape, stride=stride)


def _zero_quantized(llm: nn.Module, groups) -> None:
    """ZeRO-3 of the quantized projections' buffers (FSDP2 manages
    parameters only): each w_q / scale that fsdp_param_pspecs gives dp
    keeps this rank's dp chunk, and the projection its Zero."""
    from ..models.gllm.lora import LoRALinear
    for name, m in llm.named_modules():
        if (not isinstance(m, LoRALinear) or m.quant is None
                or m.zero is not None):
            continue
        leaves = {f"{name}.w_q": m.w_q, f"{name}.scale": m.scale}
        specs = fsdp_param_pspecs(leaves, groups.dp, tp_axis="tp")
        dims = [port_dim(n, specs[n].index("dp"), t.dim())
                if "dp" in specs[n] else None for n, t in leaves.items()]
        if dims == [None, None]:
            continue
        for leaf, d in zip(("w_q", "scale"), dims):
            if d is not None:
                setattr(m, leaf, _dp_chunk(getattr(m, leaf), d, groups))
        m.zero = Zero(groups.dp_group, groups.dp, *dims)


def fsdp_llm(llm: nn.Module, groups) -> None:
    """ZeRO-3: FSDP2 over the dp axis on the LLM's frozen storage, one
    unit per decoder layer, the embedding and the head. Only the leaves
    fsdp_param_pspecs gives dp are sharded (placement from the spec);
    the rest (norms, indivisible leaves, every trainable leaf: the
    optimizer reduces those itself) are ignored by FSDP, and a unit left
    with nothing to shard is not wrapped. A quantized base's buffers
    keep their dp chunks (_zero_quantized). With tied embeddings the
    head reads the embedding outside its unit: a frozen, dp-sharded one
    through LLM.tied_zero (comm.gathered_linear gathers it for the
    product and again for the backward); a trainable one stays outside
    FSDP, whole on each dp rank."""
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard
    names = {id(p): n for n, p in llm.named_parameters()}
    frozen = {n: p for n, p in llm.named_parameters() if not p.requires_grad}
    specs = fsdp_param_pspecs(frozen, groups.dp, tp_axis="tp",
                              ep_axis="ep" if getattr(groups, "ep", 1) > 1
                              else None)
    dims = {}
    for n, spec in specs.items():
        if "dp" in spec:
            dims[n] = port_dim(n, spec.index("dp"), frozen[n].dim())
    ignored = {id(p) for n, p in llm.named_parameters() if n not in dims}
    dp_mesh = groups.mesh["dp"]

    def placement(p):
        return Shard(dims[names[id(p)]])

    # each unit is its own FSDP root (no wrapped parent), for which FSDP2
    # would keep the gathered weights after the forward: reshard them, so
    # at most one unit's weights are whole at a time (the ZeRO-3 dataflow;
    # the backward gathers each layer again)
    for unit in (*llm.layers, llm.embed, llm.lm_head):
        if unit is None or isinstance(unit, FSDPModule):
            continue         # tied, or placed by an earlier run
        if all(id(p) in ignored for p in unit.parameters()):
            continue
        fully_shard(unit, mesh=dp_mesh, reshard_after_forward=True,
                    shard_placement_fn=placement,
                    ignored_params={p for p in unit.parameters()
                                    if id(p) in ignored})
    _zero_quantized(llm, groups)
    if llm.lm_head is None and "embed.weight" in dims:
        llm.tied_zero = (dims["embed.weight"], groups.dp, groups.dp_group)


def shard_graph_lm(model: nn.Module, groups, zero3: bool) -> None:
    """Place a GraphLM on the mesh for training: its LLM tensor-parallel
    (shard_llm; a full-finetune LLM trains sharded), under ZeRO-3 the
    LLM's frozen storage FSDP2-sharded over dp (fsdp_llm), with a pp axis
    each stage's trainable layer leaves on their stage (pipeline.py
    place_stages; ZeRO-3 beside pp only with dp 1, where it shards
    nothing, as in JAX), and the loss told its data group
    (GraphLM.mesh_groups). The graph modules and the connectors stay
    plain tensors, replicated. A model placed before (an earlier run on
    it) must be on a mesh of the same layout."""
    from .pipeline import check_pipeline_zero, place_stages
    old = model.mesh_groups
    if old is not None and (old.size, old.coord) != (groups.size,
                                                     groups.coord):
        raise ValueError(f"the model is placed on a mesh {old.size}; "
                         f"it cannot move to {groups.size}")
    check_pipeline_zero(groups.size, 3 if zero3 else 0)
    shard_llm(model.llm, groups)
    if zero3 and groups.pp == 1:
        fsdp_llm(model.llm, groups)
    if groups.pp > 1:
        place_stages(model, groups)
    model.mesh_groups = groups
