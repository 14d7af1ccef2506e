"""The mmsft optimizers (counterpart of llamole_tpu/train/trainer.py
create_optimizer and llamole_tpu/train/optimizers.py): AdamW under
global-norm clipping, or the custom chain with GaLore, LoRA+ and BAdam,
wrapped in gradient accumulation, with the learning-rate schedules in
closed form.

The JAX package builds it from optax:

    MultiSteps(chain(clip_by_global_norm(max_grad_norm),
                     adamw(schedule, b1, b2, eps, weight_decay)), k)

and this module does the same arithmetic on torch tensors, in the same
order: the micro-step gradients are averaged over the window of k
(optax's running mean acc += (g - acc) / (n + 1)); on the k-th the mean
is clipped to max_grad_norm when its global norm exceeds it, Adam's
moments are updated and bias-corrected, weight decay is added to the
update (decoupled, as optax's add_decayed_weights), and the parameters
move by -schedule(count) * update, count being the number of updates
before this one (so a warmup schedule gives lr 0 at the first update).

The custom chain (JAX build_custom_optimizer, `CustomAdamW`), when the
finetuning arguments ask for GaLore, BAdam or LoRA+:

    MultiSteps(chain(clip_by_global_norm(max_grad_norm),
                     chain(core, [add_decayed_weights(wd)], [badam],
                           [scale_lora_b(ratio)],
                           scale_by_learning_rate(schedule))), k)

  core   Adam over every leaf, or with GaLore (arXiv 2403.03507) the
         leaves that are 2-D with min(shape) > rank take Adam in a
         rank-r subspace: every update_interval updates the basis is
         refreshed from the SVD of the gradient (the shorter side of the
         JAX leaf: [in, r] left basis when in <= out, else [out, r]
         right), the moments live in the projected space, and the update
         is projected back and scaled; the other leaves take plain Adam.
         Each leaf's basis and low-rank moments are held in the JAX
         leaf's orientation ([in, out] for a projection whose port
         weight is [out, in]), so the state equals JAX's leaf for leaf.
  decay  weight decay added at full rank, after the back-projection
  BAdam  layer-mode block descent: the leaves, in the JAX bundle tree's
         flatten order (dict keys sorted, list items in order), are
         dealt round-robin into n_blocks blocks; only the block
         (start + count // switch_interval) % n_blocks moves. Every
         leaf's moments still update.
  LoRA+  the update of every leaf whose JAX path has a segment holding
         "lora" and ends in "b" (the adapters' B) times the ratio
  lr     times -schedule(count)

On a mesh (`groups`, parallel/mesh.py MeshGroups) each rank holds its
tensor-parallel shard of every parameter (the optimizer works on the
DTensors' local tensors) and the micro step's gradients are summed over
the data group (dcn x dp) as they are accumulated. ZeRO-1 (`zero1`)
shards the moments and the accumulator over dp on the dimension
parallel/sharding.py zero1_opt_pspecs picks (the largest dp-divisible
one of the JAX leaf; under tp the largest free one if that is the tp
dimension): the gradient is reduce-scattered, the clip reads the global
norm, the update runs on this rank's chunk and the parameter is
all-gathered. The gradients' reductions and the all-gather go in buckets
(parallel/comm.py): one collective per bucket, not per parameter. A leaf
sharded over ep (an MoE expert) is summed over the data group like any
other. GaLore on a part of a leaf (its tp shard, its ZeRO-1 chunk)
gathers the leaf's whole gradient for the SVD at a refresh (every rank
gets the same basis), projects its own part through the basis rows of
its part, summing the partial products over the ranks that split the
basis's side, and keeps its part of the projected moments (split on
the other side). Beside a pp axis each stage's optimizer holds its own
leaves; BAdam's blocks are dealt over every stage's names, as JAX's one
optimizer over the whole tree deals them.
"""

import contextlib
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..models.gllm.lora import svd
from ..utils.serialization import to_state_dict
from ..weights import bundle_path, bundle_tree, nest

Schedule = Callable[[int], float]


def wants_custom_optimizer(finetuning_args) -> bool:
    return bool(finetuning_args is not None and (
        getattr(finetuning_args, "use_galore", False)
        or getattr(finetuning_args, "use_badam", False)
        or getattr(finetuning_args, "loraplus_lr_ratio", None)))


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine_decay(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * c / steps))
    return f


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two pieces."""
    def f(count: int) -> float:
        return first(count) if count < boundary else second(count - boundary)
    return f


def warmup_cosine_decay_schedule(peak: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps): linear warmup from 0, then cosine decay to 0."""
    return _join(_linear(0.0, peak, warmup_steps),
                 _cosine_decay(peak, max(decay_steps - warmup_steps, 1)),
                 warmup_steps)


def make_schedule(args, num_training_steps: int) -> Schedule:
    """The learning rate at each optimizer update (counted from 0), as
    create_optimizer builds it: warmup then cosine decay to 0, warmup
    then linear decay to 0, or constant."""
    lr = args.learning_rate
    warmup = args.warmup_steps or int(args.warmup_ratio * num_training_steps)
    if args.lr_scheduler_type == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, w, max(n, w + 1))
        w = max(warmup, 1)
        return warmup_cosine_decay_schedule(
            lr, w, max(num_training_steps, w + 1))
    if args.lr_scheduler_type == "linear":
        w = max(warmup, 1)
        return _join(_linear(0.0, lr, w),
                     _linear(lr, 0.0, max(num_training_steps - warmup, 1)), w)
    return lambda count: lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def int32_scalar(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def load_into(want: Any, got: Any, where: str, counts: List[int]) -> None:
    """Copy the state-dict tree `got` into the tensors of `want` (the
    optimizer's own state in state-dict form: its leaves are views of the
    optimizer's tensors); {} stands for a masked leaf; every "count"
    leaf's value goes to `counts`. A key, shape or masking that differs
    raises (ValueError); a key `got` holds an empty {} under (JAX's empty
    groups) is ignored."""
    if isinstance(want, torch.Tensor):
        if (not isinstance(got, torch.Tensor)
                or tuple(got.shape) != tuple(want.shape)):
            shape = tuple(got.shape) if isinstance(got, torch.Tensor) else got
            raise ValueError(f"opt_state leaf {where} does not match the "
                             f"optimizer's: {shape} where it holds "
                             f"{tuple(want.shape)}")
        want.copy_(got.to(want.dtype))
        return
    if not isinstance(got, dict):
        raise ValueError(f"opt_state leaf {where} does not match the "
                         f"optimizer's: {type(got).__name__}")
    keys = {k for k in got if k in want
            or not (isinstance(got[k], dict) and not got[k])}
    if keys != set(want):
        raise ValueError(f"opt_state {where} does not match the optimizer's: "
                         f"keys {sorted(keys)}, expected {sorted(want)}")
    for k in want:
        if k == "count":
            counts.append(int(got[k]))
        else:
            load_into(want[k], got[k], f"{where}/{k}", counts)


class AccumulatingAdamW:
    """optax.MultiSteps(chain(clip_by_global_norm, adamw)) over named
    parameters. `accumulate()` takes each parameter's .grad of one micro
    step and returns True when it completed a window and updated the
    parameters."""

    CHAIN = "adamw"

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, accumulation_steps: int = 1,
                 groups=None, zero1: bool = False):
        self.params = params
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.k = max(int(accumulation_steps), 1)
        self.count = 0        # updates applied
        self.mini_step = 0    # micro steps in the current window
        self.groups = groups
        # every pipeline stage's names (ours without pp): the checkpoints'
        # view, as JAX's one optimizer over the whole tree
        self.all_names = list(params)
        if groups is not None and groups.pp > 1:
            from ..parallel.pipeline import every_stage
            self.all_names = list(dict.fromkeys(
                n for names in every_stage(list(params), groups)
                for n in names))
        self.shard_dim = ({n: zero1_dim(n, p, groups) for n, p in
                           params.items()} if zero1 and groups else {})
        self.last_grad_norm = float("nan")   # the last micro step's
        self.acc = {n: torch.zeros_like(self._mine(n, p))
                    for n, p in params.items()}
        self.mu = {n: self._moment(n, p) for n, p in params.items()}
        self.nu = {n: self._moment(n, p) for n, p in params.items()}

    def _mine(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The part of p (a view) this rank's optimizer state covers: its
        tensor-parallel shard, and of that its ZeRO-1 chunk."""
        t = local_data(p)
        d = self.shard_dim.get(name)
        if d is None:
            return t
        return t.chunk(self.groups.dp, dim=d)[self.groups.dp_rank]

    def _moment(self, name: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(self._mine(name, p))

    def _sharded(self) -> Dict[str, int]:
        """{name: its ZeRO-1 chunk's dimension} of the chunked names."""
        return {n: d for n, d in self.shard_dim.items() if d is not None}

    def _reduce(self, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """A micro step's local gradients summed over the data group
        (ZeRO-1: reduce-scattered to this rank's chunks over dp, then
        summed over dcn), in bucketed collectives."""
        from ..parallel.comm import all_reduce_many, reduce_scatter_many
        gr = self.groups
        if gr is None:
            return grads
        dims = self._sharded()
        out = all_reduce_many({n: g for n, g in grads.items()
                               if n not in dims}, gr.data_group)
        part = reduce_scatter_many({n: g for n, g in grads.items()
                                    if n in dims}, dims, gr.dp, gr.dp_group)
        if gr.dcn_group is not None:
            part = all_reduce_many(part, gr.dcn_group)
        out.update(part)
        if gr.pp > 1:   # leaves outside the layer stack: every pp share
            out.update(all_reduce_many({n: g for n, g in out.items()
                                        if not self._staged(n)},
                                       gr.pp_group))
        return out

    def _staged(self, name: str) -> bool:
        """A leaf of one pipeline stage's layers (its stage alone holds
        it), rather than one replicated over pp."""
        from ..parallel.pipeline import layer_index
        return (self.groups is not None and self.groups.pp > 1
                and name.startswith("llm.") and layer_index(name) is not None)

    def _copies(self, name: str) -> int:
        """How many ranks hold this name's optimizer part identically."""
        gr = self.groups
        distinct = sharded_ways(self.params[name]) * (
            gr.dp if self.shard_dim.get(name) is not None else 1) * (
            gr.pp if self._staged(name) else 1)
        return gr.world // distinct

    def global_norm(self, values: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of {name: this rank's part}: on a mesh the
        squares of every rank's parts, each copy counted once."""
        if self.groups is None:
            return global_norm(values.values())
        from ..parallel.comm import all_reduce_
        sq = sum((t.float() * t.float()).sum() / self._copies(n)
                 for n, t in values.items())
        return torch.sqrt(all_reduce_(sq))

    @torch.no_grad()
    def accumulate(self) -> bool:
        n_acc = self.mini_step
        grads = self._reduce({
            name: (local_data(p.grad) if p.grad is not None
                   else torch.zeros_like(local_data(p)))
            for name, p in self.params.items()})
        for name, g in grads.items():
            acc = self.acc[name]
            acc.add_((g.to(acc.dtype) - acc) / (n_acc + 1))
        self.last_grad_norm = float(self.global_norm(grads))
        del grads
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        self._update()
        self.mini_step = 0
        for acc in self.acc.values():
            acc.zero_()
        return True

    def _adam(self, name: str, g: torch.Tensor, c1: float,
              c2: float) -> torch.Tensor:
        """Adam's bias-corrected direction; the moments update in place."""
        mu, nu = self.mu[name], self.nu[name]
        mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
        return (mu / c1) / (torch.sqrt(nu / c2) + self.eps)

    def _direction(self, name: str, p: torch.Tensor, g: torch.Tensor,
                   c1: float, c2: float) -> Optional[torch.Tensor]:
        """The update the learning rate scales (None: the leaf stays)."""
        update = self._adam(name, g, c1, c2)
        if self.weight_decay:
            update = update + self.weight_decay * p
        return update

    def _update(self) -> None:
        from ..parallel.comm import all_gather_many
        grads = self.acc
        norm = self.global_norm(grads)
        clip = bool(norm >= self.max_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, param in self.params.items():
            p = self._mine(name, param)
            g = grads[name]
            if clip:
                g = g / norm.to(g.dtype) * self.max_grad_norm
            update = self._direction(name, p, g, c1, c2)
            if update is not None:
                p.add_(update.to(p.dtype), alpha=-lr)
        dims = self._sharded()
        if dims:    # ZeRO-1: every rank's updated chunks
            whole = all_gather_many({n: self._mine(n, self.params[n])
                                     for n in dims}, dims, self.groups.dp,
                                    self.groups.dp_group)
            for n, t in whole.items():
                local_data(self.params[n]).copy_(t)

    # -- whole state, for checkpoints ----------------------------------------
    def _wholes(self, parts: Dict[str, torch.Tensor], key: str = "acc"
                ) -> Dict[str, torch.Tensor]:
        """This rank's parts of the names' state `key` -> the whole
        tensors (the ranks' ZeRO-1 chunks gathered in bucketed calls,
        tensor-parallel shards joined: collectives on a mesh)."""
        from ..parallel.comm import all_gather_many
        from ..parallel.sharding import full
        dims = {n: d for n, d in self._sharded().items() if n in parts}
        out = dict(parts)
        if dims:
            out.update(all_gather_many({n: parts[n] for n in dims}, dims,
                                       self.groups.dp, self.groups.dp_group))
        for n, t in out.items():
            p = self.params[n]
            if tp_sharded(p):
                from torch.distributed.tensor import DTensor
                out[n] = full(DTensor.from_local(
                    t, p.device_mesh, p.placements, run_check=False,
                    shape=p.shape, stride=p.stride()))
        return out

    def _part(self, name: str, whole: torch.Tensor, zero1: bool = True,
              key: str = "acc") -> torch.Tensor:
        """_wholes' inverse for one name: this rank's part of a whole
        tensor (zero1 False: its tensor-parallel shard, as the parameter
        holds it)."""
        p = self.params[name]
        if tp_sharded(p):
            for axis, pl in enumerate(p.placements):
                if hasattr(pl, "dim"):
                    coord = p.device_mesh.get_coordinate()[axis]
                    whole = whole.chunk(p.device_mesh.size(axis),
                                        dim=pl.dim)[coord]
        d = self.shard_dim.get(name) if zero1 else None
        if d is not None:
            whole = whole.chunk(self.groups.dp, dim=d)[self.groups.dp_rank]
        return whole

    STATE = ("acc", "mu", "nu")
    EXTRA_STATE = ()    # state beyond STATE that a checkpoint keeps

    @contextlib.contextmanager
    def whole_state(self, load: bool = False):
        """Inside the block the state (acc, mu, nu and EXTRA_STATE) holds
        whole tensors, as the mesh-less optimizer's, of every pipeline
        stage's leaves; with load, what the block wrote into them is
        taken back into this rank's parts after it. Without a mesh the
        state as it is."""
        if self.groups is None:
            yield
            return
        parts = {k: getattr(self, k) for k in self.STATE + self.EXTRA_STATE}
        for k, d in parts.items():
            whole = self._wholes(d, k)
            if self.groups.pp > 1:    # and every pipeline stage's leaves
                from ..parallel.pipeline import gather_stage_dicts
                whole = gather_stage_dicts(whole, self.groups)
            setattr(self, k, whole)
        try:
            yield
            if load:
                for k, d in parts.items():
                    whole = getattr(self, k)
                    for n, t in d.items():
                        t.copy_(self._part(n, whole[n], key=k))
        finally:
            for k, d in parts.items():
                setattr(self, k, d)

    # -- the state in flax's state-dict layout --------------------------------
    def chain_state(self) -> Dict[str, Any]:
        """The state of the chain after clipping, as flax's to_state_dict
        lays out JAX's optax state: adamw is chain(scale_by_adam,
        add_decayed_weights, scale_by_learning_rate) = {"0":
        ScaleByAdamState(count, mu, nu), "1": {}, "2": {count}}, the
        moments as the bundle tree. Leaves are views of the optimizer's
        tensors (load_chain_state writes through them)."""
        c = int32_scalar(self.count)
        return {"0": {"count": c, "mu": bundle_tree(self.mu),
                      "nu": bundle_tree(self.nu)},
                "1": {}, "2": {"count": int32_scalar(self.count)}}

    @torch.no_grad()
    def load_chain_state(self, chain: Dict[str, Any]) -> List[int]:
        """chain_state's inverse: copies the moments from a state dict of
        either package; returns every count it held. Other parts, keys,
        shapes or masking raise (ValueError)."""
        want = to_state_dict(self.chain_state())
        if not isinstance(chain, dict) or set(chain) != set(want):
            got = sorted(chain) if isinstance(chain, dict) else chain
            raise ValueError(f"opt_state is not the optimizer's chain "
                             f"({self.CHAIN}): parts {got}, expected "
                             f"{sorted(want)}")
        counts: List[int] = []
        load_into(want, chain, "", counts)
        return counts


class GaLore(NamedTuple):
    rank: int = 16
    update_interval: int = 200
    scale: float = 0.25


class BAdam(NamedTuple):
    n_blocks: int = 4
    switch_interval: int = 50
    start_block: int = 0


def galore_basis(g: torch.Tensor, rank: int) -> torch.Tensor:
    """The orthonormal basis of the shorter side of g [m, n] (JAX
    _galore_core project_matrix): [m, r] left singular vectors when
    m <= n, else [n, r] right ones, from an f32 SVD."""
    m, n = g.shape
    u, _, vt = svd(g.float())
    return (u[:, :rank] if m <= n else vt[:rank].t()).contiguous()


def _flatten_key(path: List[str]):
    """jax.tree.flatten's order of a bundle path: dict keys sorted as
    strings, list items (digit segments) by index."""
    return tuple((0, int(k), "") if k.isdigit() else (1, 0, k) for k in path)


def badam_blocks(names, n_blocks: int) -> Dict[str, int]:
    """BAdam's block of each GraphLM trainable-bundle name: the leaves in
    the JAX bundle tree's flatten order, dealt round-robin."""
    order = sorted(names, key=lambda n: _flatten_key(bundle_path(n)[0]))
    return {n: i % n_blocks for i, n in enumerate(order)}


class CustomAdamW(AccumulatingAdamW):
    """The custom chain (module docstring) over GraphLM trainable-bundle
    names; galore / badam / loraplus_lr_ratio None leave a part out."""

    CHAIN = "GaLore / Adam, decay, BAdam, LoRA+, schedule"
    EXTRA_STATE = ("proj",)     # GaLore's bases ({} without GaLore)

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Schedule, *, galore: Optional[GaLore] = None,
                 badam: Optional[BAdam] = None,
                 loraplus_lr_ratio: Optional[float] = None, **kwargs):
        self.paths = {n: bundle_path(n) for n in params}
        self.galore = galore
        self.galore_names = {
            n for n, p in params.items()
            if galore is not None and p.dim() == 2
            and min(p.shape) > galore.rank}
        self.badam = badam
        self.loraplus_lr_ratio = loraplus_lr_ratio
        self.lora_b = {n for n in params if loraplus_lr_ratio
                       and self.paths[n][0][-1] == "b"
                       and any("lora" in k for k in self.paths[n][0])}
        self.proj = {n: self._oriented_zeros(n, params[n], basis=True)
                     for n in sorted(self.galore_names)}
        super().__init__(params, schedule, **kwargs)
        # BAdam deals, and a whole state lays out, every stage's leaves
        self.block = (badam_blocks(self.all_names, badam.n_blocks)
                      if badam is not None else {})
        self.galore_all = set(self.galore_names)
        if self.groups is not None and self.groups.pp > 1:
            from ..parallel.pipeline import every_stage
            self.galore_all = {n for low in every_stage(
                sorted(self.galore_names), self.groups) for n in low}

    def _path(self, name: str):
        return self.paths.get(name) or bundle_path(name)

    def _jax_shape(self, name: str, p: torch.Tensor):
        """The JAX leaf's shape [m, n] of a 2-D parameter."""
        return tuple(p.shape[::-1]) if self.paths[name][1] else tuple(p.shape)

    def _galore_split(self, name: str) -> Dict[int, tuple]:
        """{JAX dimension: (process group, ranks, this rank's index, mesh
        axis)} of the dimensions on which this rank's gradient of a
        GaLore leaf is a part of the whole: its tensor-parallel shard and
        its ZeRO-1 chunk (empty without a mesh)."""
        p, flip = self.params[name], self.paths[name][1]
        out = {}
        if tp_sharded(p):
            mesh = p.device_mesh
            for axis, pl in enumerate(p.placements):
                if hasattr(pl, "dim"):
                    out[1 - pl.dim if flip else pl.dim] = (
                        mesh.get_group(axis), mesh.size(axis),
                        mesh.get_coordinate()[axis],
                        mesh.mesh_dim_names[axis])
        d = self.shard_dim.get(name)
        if d is not None:
            gr = self.groups
            out[1 - d if flip else d] = (gr.dp_group, gr.dp, gr.dp_rank,
                                         "dp")
        return out

    def _oriented_zeros(self, name: str, p: torch.Tensor,
                        basis: bool) -> torch.Tensor:
        """GaLore's zero basis (f32) or low-rank moment (p's dtype) in the
        JAX orientation: basis [m, r] and moments [r, n] when m <= n, else
        [n, r] and [m, r], the moments this rank's part of their side.
        JAX's initial basis is the SVD of a zero gradient; any basis
        does, as the first update refreshes it."""
        m, n = self._jax_shape(name, p)
        r = self.galore.rank
        if basis:
            return torch.zeros((m, r) if m <= n else (n, r),
                               dtype=torch.float32, device=p.device)
        split = self._galore_split(name)
        if m <= n:
            shape = (r, n // split.get(1, (None, 1))[1])
        else:
            shape = (m // split.get(0, (None, 1))[1], r)
        return torch.zeros(shape, dtype=p.dtype, device=p.device)

    def _moment(self, name: str, p: torch.Tensor) -> torch.Tensor:
        if name in self.galore_names:
            return self._oriented_zeros(name, p, basis=False)
        return super()._moment(name, p)

    def _galore(self, name: str, g: torch.Tensor, c1: float,
                c2: float) -> torch.Tensor:
        from ..parallel.comm import all_gather_dim, all_reduce_
        gj = g.t() if self.paths[name][1] else g    # (this rank's part of)
        m, n = self._jax_shape(name, self.params[name])  # JAX's [m, n]
        split = self._galore_split(name)
        if (self.count - 1) % self.galore.update_interval == 0:
            whole = gj
            for dim, (group, size, _, _) in split.items():
                whole = all_gather_dim(whole, dim, size, group)
            self.proj[name] = galore_basis(whole, self.galore.rank)
        proj = self.proj[name]
        left = m <= n
        side = split.get(0 if left else 1)     # the basis's side split
        if side is not None:
            proj = proj.chunk(side[1])[side[2]]
        low = proj.t().to(gj.dtype) @ gj if left else gj @ proj.to(gj.dtype)
        if side is not None:
            low = all_reduce_(low.contiguous(), side[0])
        u = self._adam(name, low, c1, c2)
        full = proj.to(u.dtype) @ u if left else u @ proj.t().to(u.dtype)
        full = (self.galore.scale * full).to(g.dtype)
        return full.t() if self.paths[name][1] else full

    def _moment_side(self, name: str):
        """(dimension, split) of a GaLore leaf's moments that this rank
        holds a part of, or None."""
        m, n = self._jax_shape(name, self.params[name])
        dim = 1 if m <= n else 0
        split = self._galore_split(name).get(dim)
        return None if split is None else (dim, split)

    def _wholes(self, parts, key="acc"):
        if key == "proj":
            return dict(parts)
        if key not in ("mu", "nu"):
            return super()._wholes(parts, key)
        low = {n: t for n, t in parts.items() if n in self.galore_names}
        out = super()._wholes({n: t for n, t in parts.items()
                               if n not in low}, key)
        from ..parallel.comm import all_gather_dim
        for n, t in low.items():
            side = self._moment_side(n)
            out[n] = t if side is None else all_gather_dim(
                t, side[0], side[1][1], side[1][0])
        return out

    def _part(self, name, whole, zero1=True, key="acc"):
        if key == "proj":
            return whole
        if key in ("mu", "nu") and name in self.galore_names:
            side = self._moment_side(name)
            return whole if side is None else whole.chunk(
                side[1][1], dim=side[0])[side[1][2]]
        return super()._part(name, whole, zero1, key)

    def _direction(self, name, p, g, c1, c2):
        if name in self.galore_names:
            update = self._galore(name, g, c1, c2)
        else:
            update = self._adam(name, g, c1, c2)
        if self.weight_decay:
            update = update + self.weight_decay * p
        if self.badam is not None:
            b = self.badam
            active = (b.start_block + (self.count - 1) // b.switch_interval
                      ) % b.n_blocks
            if self.block[name] != active:
                return None
        if name in self.lora_b:
            update = update * self.loraplus_lr_ratio
        return update

    def _tree(self, values: Dict[str, torch.Tensor], names,
              transpose: bool) -> Dict:
        """The bundle tree of values[name] for `names`, {} (masked) at the
        other leaves; transpose: lay 2-D leaves out as the JAX leaf."""
        def leaf(n):
            if n not in names:
                return {}
            t = values[n].detach()
            return t.t() if transpose and self._path(n)[1] else t
        # every leaf the state holds: each stage's in a whole state
        return nest((self._path(n)[0], leaf(n)) for n in self.all_names
                    if n in self.mu)

    def chain_state(self) -> Dict[str, Any]:
        """JAX build_custom_optimizer's chain state: [core, decay?,
        BAdamState(count)?, LoRA+ {}?, {count}] keyed "0", "1", ...; with
        GaLore the core is multi_transform's {"inner_states": {"galore":
        {"inner_state": GaLoreState(count, proj, inner=ScaleByAdamState)},
        "plain": {"inner_state": ScaleByAdamState}}}, each group's trees
        masked ({}) at the other group's leaves."""
        c = self.count
        everything = set(self.mu)
        if self.galore is None:
            core = {"count": int32_scalar(c),
                    "mu": self._tree(self.mu, everything, True),
                    "nu": self._tree(self.nu, everything, True)}
        else:
            low = self.galore_all & everything
            plain = everything - low
            core = {"inner_states": {
                "galore": {"inner_state": {
                    "count": int32_scalar(c),
                    "proj": self._tree(self.proj, low, False),
                    "inner": {"count": int32_scalar(c),
                              "mu": self._tree(self.mu, low, False),
                              "nu": self._tree(self.nu, low, False)}}},
                "plain": {"inner_state": {
                    "count": int32_scalar(c),
                    "mu": self._tree(self.mu, plain, True),
                    "nu": self._tree(self.nu, plain, True)}}}}
        parts = [core]
        if self.weight_decay:
            parts.append({})
        if self.badam is not None:
            parts.append({"count": int32_scalar(c)})
        if self.loraplus_lr_ratio:
            parts.append({})
        parts.append({"count": int32_scalar(c)})
        return {str(i): part for i, part in enumerate(parts)}


def local_data(t: torch.Tensor) -> torch.Tensor:
    """The tensor's storage on this rank: a DTensor's local shard."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t.data


def tp_sharded(p: torch.Tensor) -> bool:
    """Whether p is a DTensor sharded on an axis of its mesh (tp, or ep
    for an MoE expert)."""
    from torch.distributed.tensor import DTensor
    return isinstance(p, DTensor) and any(hasattr(pl, "dim")
                                          for pl in p.placements)


def sharded_ways(p: torch.Tensor) -> int:
    """Into how many distinct parts a DTensor's placements cut it (1 for
    a plain tensor)."""
    if not tp_sharded(p):
        return 1
    out = 1
    for axis, pl in enumerate(p.placements):
        if hasattr(pl, "dim"):
            out *= p.device_mesh.size(axis)
    return out


def zero1_dim(name: str, p: torch.Tensor, groups) -> Optional[int]:
    """The port dimension of p's ZeRO-1 chunk over dp (None: its state
    replicates): zero1_opt_pspecs on the JAX leaf, or under tp, when that
    is the tp-sharded dimension, the largest dp-divisible other one."""
    from ..parallel.sharding import zero1_opt_pspecs
    path, transposed = bundle_path(name)
    shape = tuple(p.shape)
    flip = transposed and len(shape) == 2
    jax_shape = shape[::-1] if flip else shape
    spec = zero1_opt_pspecs(torch.empty(jax_shape, device="meta"),
                            groups.dp)
    if not spec:
        return None
    d = spec.index("dp")
    d = len(shape) - 1 - d if flip else d
    taken = {pl.dim for pl in getattr(p, "placements", ())
             if hasattr(pl, "dim")}
    mine = local_data(p).shape
    if d in taken or mine[d] % groups.dp:
        free = [(mine[i], i) for i in range(len(mine))
                if i not in taken and mine[i] % groups.dp == 0
                and mine[i] >= groups.dp]
        return max(free)[1] if free else None
    return d


def create_optimizer(args, num_training_steps: int,
                     params: Dict[str, torch.nn.Parameter],
                     finetuning_args=None, groups=None, zero1: bool = False):
    """(optimizer, schedule) from TrainingArguments; num_training_steps
    counts optimizer updates. finetuning_args asking for GaLore, BAdam or
    LoRA+ give the custom chain (CustomAdamW, over GraphLM
    trainable-bundle names). groups / zero1: mesh training (module
    docstring)."""
    schedule = make_schedule(args, num_training_steps)
    kwargs = dict(b1=args.adam_beta1, b2=args.adam_beta2,
                  eps=args.adam_epsilon, weight_decay=args.weight_decay,
                  max_grad_norm=args.max_grad_norm,
                  accumulation_steps=args.gradient_accumulation_steps,
                  groups=groups, zero1=zero1)
    if not wants_custom_optimizer(finetuning_args):
        return AccumulatingAdamW(params, schedule, **kwargs), schedule
    ft = finetuning_args
    galore = (GaLore(ft.galore_rank, ft.galore_update_interval,
                     ft.galore_scale)
              if getattr(ft, "use_galore", False) else None)
    badam = (BAdam(max(ft.badam_n_blocks, 1), ft.badam_switch_interval,
                   ft.badam_start_block)
             if getattr(ft, "use_badam", False) else None)
    return CustomAdamW(params, schedule, galore=galore, badam=badam,
                       loraplus_lr_ratio=getattr(ft, "loraplus_lr_ratio",
                                                 None) or None,
                       **kwargs), schedule
