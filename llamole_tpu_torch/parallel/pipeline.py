"""GPipe pipeline parallelism for the decoder stack (counterpart of
llamole_tpu/parallel/pipeline.py).

The JAX package shards the leading depth axis of the stacked layer
parameters over the mesh's 'pp' axis and runs the schedule in a
shard_map. The port keeps the LLM's list layout (gllm/stacked.py is
TPU-only), so stage s of S owns the contiguous layers [s L/S, (s+1) L/S),
the same split as JAX's sharding of the depth axis, and the schedule runs
one process per rank:

  tick t:  stage s processes microbatch (t - s) and sends its activation
           to stage s+1 (point-to-point). M microbatches, S stages ->
           M + S - 1 ticks, bubble fraction (S-1)/(M+S-1).

The schedule is one torch.autograd.Function (_GPipe): its forward runs
the ticks, recording each microbatch's stage graph; the last stage's
outputs are then broadcast to every pp rank (JAX's masked psum). Its
backward is the reverse schedule: the incoming gradients are summed over
pp (psum's transpose), the last stage backpropagates each microbatch in
reverse order and sends the input's gradient to the stage before.

The loss convention is the data-parallel one of GraphLM.loss: every
rank returns its share, and the shares of the pp and dp ranks sum to the
loss. Each pp rank computes the embedding, the final norm and the head
itself (JAX runs them under plain GSPMD); its share of a loss computed
after the pipeline is 1/S of it, so a leaf replicated over pp (the
embedding, the head, the connectors) gets its gradient by a sum over pp,
and a stage's layers get theirs on their own stage.

Conventions as in JAX: cfg.num_layers % S == 0, batch % M == 0; the
microbatch rows shard over dp when dp divides them (else every dp rank
computes the whole microbatch, with JAX's warning). MoE training and
sliding-window configs are refused as JAX refuses them. cfg.remat
recomputes each layer in the backward (torch.utils.checkpoint).
"""

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..utils.constants import IGNORE_INDEX
from ..utils.logging import get_logger

logger = get_logger(__name__)

_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def layer_index(name: str) -> Optional[int]:
    """The decoder layer a parameter name belongs to ('layers.3.attn...',
    'llm.layers.3...'), None outside the layer stack."""
    m = _LAYER.search(name)
    return int(m.group(1)) if m else None


def stage_of(layer: int, num_layers: int, stages: int) -> int:
    """The pp stage that owns a layer (JAX's depth sharding)."""
    return layer // (num_layers // stages)


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def pipeline_param_pspecs(params: Dict[str, torch.Tensor],
                          axis: str = "pp") -> Dict[str, Tuple]:
    """{name: JAX spec} for the LLM's parameters by their list-layout
    names: a layer's leaf gets the spec of the stacked [L, ...] leaf it is
    a slice of, its depth over `axis` (its stage: stage_of); every other
    leaf replicates. Parameters without layer leaves raise, as JAX's
    strict call on a tree without a stacked subtree does."""
    if not any(layer_index(n) is not None for n in params):
        raise ValueError("pipeline parallelism needs the layer stack "
                         "(no 'layers.N.' leaf among the parameters)")
    return {n: ((axis,) + (None,) * p.dim() if layer_index(n) is not None
                else ()) for n, p in params.items()}


def check_pipeline(cfg, stages: int, batch: int, num_microbatches: int,
                   train: bool) -> None:
    """JAX pipeline_decoder_forward's refusals, in its order."""
    if cfg.num_experts > 0 and train:
        # inference (train=False) is fine: the aux loss only matters for
        # router gradients
        raise ValueError(
            "pipelined TRAINING drops the MoE router aux loss — experts "
            "would collapse silently; use the ep axis for MoE models "
            "(mesh='ep:N,dp:M')")
    if cfg.sliding_window is not None:
        # one global causal mask for every layer: gemma2-style alternating
        # local attention would silently widen the even layers' windows
        raise ValueError(
            "pipeline parallelism does not support sliding-window configs "
            "(gemma2) — shard with dp/tp instead")
    if cfg.num_layers % stages != 0:
        raise ValueError(f"pp={stages} stages must evenly divide "
                         f"num_layers={cfg.num_layers}")
    if batch % num_microbatches != 0:
        raise ValueError(f"num_microbatches={num_microbatches} must evenly "
                         f"divide batch={batch}")


def check_pipeline_zero(dims: Dict[str, int], zero_stage: int) -> None:
    """JAX Trainer's refusal: ZeRO-3 (which needs dp > 1) beside pp."""
    if dims.get("pp", 1) > 1 and zero_stage >= 3 and dims.get("dp", 1) > 1:
        raise ValueError(
            "zero_stage=3 with pipeline parallelism is not supported: pp "
            "already shards the layer stack; use zero_stage<=1 with pp, or "
            "dp-only fsdp")


def microbatch_rows_shard(batch: int, num_microbatches: int,
                          dp: int) -> bool:
    """Whether the microbatch rows (batch / M) shard over dp; when they
    do not, JAX's warning (every dp rank computes the whole microbatch)."""
    mb = batch // num_microbatches
    if dp <= 1 or mb % dp == 0:
        return dp > 1
    logger.warning(
        "pipeline: microbatch rows %d not divisible by %s=%d — data "
        "parallelism DISABLED, all dp ranks replicate the full microbatch "
        "(pick batch/num_microbatches divisible by dp)", mb, "dp", dp)
    return False


class _Schedule:
    """One pipelined forward of this rank's stage: the GPipe ticks, the
    graphs they recorded, and the reverse ticks of the backward."""

    def __init__(self, llm, groups, mask, positions, num_microbatches: int,
                 train: bool):
        cfg = llm.cfg
        self.stages = groups.pp
        self.stage = groups.pp_rank
        self.group = groups.pp_group
        self.M = num_microbatches
        self.layers = [llm.layers[i] for i in stage_layers(
            cfg.num_layers, self.stages, self.stage)]
        self.inv_freq = llm._inv_freq
        self.remat = cfg.remat
        self.train = train
        b, s = mask.shape
        mb = b // self.M
        self.mask = mask.reshape(self.M, mb, s)
        self.positions = positions.reshape(self.M, mb, s)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=mask.device).tril()
        self.bss = causal[None, None] & (self.mask[:, :, None, :] > 0)
        self.saved = {}

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def _run_stage(self, x, m: int):
        for layer in self.layers:
            args = (x, self.positions[m], self.inv_freq, self.bss[m],
                    self.mask[m], None, None, self.train)
            if self.remat and torch.is_grad_enabled():
                x, _ = checkpoint(layer, *args, use_reentrant=False)
            else:
                x, _ = layer(*args)
        return x

    def forward(self, x: torch.Tensor, record: bool) -> torch.Tensor:
        """x [b, S, H] (every rank's embeddings; stage 0 reads them) ->
        the last stage's outputs on every pp rank. record: keep each
        microbatch's graph for backward."""
        b, seq, h = x.shape
        xs = x.reshape(self.M, b // self.M, seq, h)
        outs = torch.zeros_like(xs)
        first, last = self.stage == 0, self.stage == self.stages - 1
        for t in range(self.M + self.stages - 1):
            m = t - self.stage               # this stage's microbatch
            if not 0 <= m < self.M:
                continue                     # a bubble tick
            if first:
                inp = xs[m].detach()
            else:
                inp = torch.empty_like(xs[m])
                dist.recv(inp, self._peer(self.stage - 1), group=self.group)
            if record:
                inp.requires_grad_(not first or x.requires_grad)
                with torch.enable_grad():
                    out = self._run_stage(inp, m)
                self.saved[m] = (inp, out)
            else:
                out = self._run_stage(inp, m)
            if last:
                outs[m] = out.detach()
            else:
                dist.send(out.detach().contiguous(),
                          self._peer(self.stage + 1), group=self.group)
        if self.stages > 1:
            # the last stage's archive replicated to every pp rank
            dist.broadcast(outs, self._peer(self.stages - 1),
                           group=self.group)
        return outs.reshape(b, seq, h)

    def backward(self, grad: torch.Tensor) -> torch.Tensor:
        """The reverse ticks: grad [b, S, H] of this rank's share ->
        the gradient of x (stage 0's; zeros elsewhere)."""
        b, seq, h = grad.shape
        g_all = grad.reshape(self.M, b // self.M, seq, h).contiguous()
        if self.stages > 1:
            # psum's transpose: the ranks' shares summed, for the last stage
            dist.all_reduce(g_all, group=self.group)
        gx = torch.zeros_like(g_all)
        first, last = self.stage == 0, self.stage == self.stages - 1
        for t in reversed(range(self.M + self.stages - 1)):
            m = t - self.stage
            if not 0 <= m < self.M:
                continue
            if last:
                g = g_all[m]
            else:
                g = torch.empty_like(g_all[m])
                dist.recv(g, self._peer(self.stage + 1), group=self.group)
            inp, out = self.saved.pop(m)
            if out.requires_grad:
                torch.autograd.backward(out, g)
            gi = inp.grad if inp.grad is not None else torch.zeros_like(g)
            if first:
                gx[m] = gi
            else:
                dist.send(gi.contiguous(), self._peer(self.stage - 1),
                          group=self.group)
        return gx.reshape(b, seq, h)


class _GPipe(torch.autograd.Function):
    """The schedule as one differentiable operation. `anchor` (an empty
    tensor that requires grad) makes every rank take part in the backward
    even where neither x nor its stage has a gradient to receive: the
    reverse ticks pass gradients between the stages."""

    @staticmethod
    def forward(ctx, x, anchor, sched):
        ctx.sched = sched
        return sched.forward(x, record=True)

    @staticmethod
    def backward(ctx, grad):
        sched, ctx.sched = ctx.sched, None
        return sched.backward(grad), None, None


def pipeline_decoder_forward(llm, x: torch.Tensor,
                             attention_mask: torch.Tensor,
                             positions: torch.Tensor, groups, *,
                             num_microbatches: int,
                             train: bool = False) -> torch.Tensor:
    """The layer stack through the GPipe schedule over groups' pp axis
    (parallel/mesh.py MeshGroups; pp 1 without the axis): x [B, S, H]
    embeddings of this rank's rows, attention_mask / positions [B, S] ->
    [B, S, H] pre-final-norm hidden states on every pp rank,
    differentiable in x and in this stage's parameters."""
    b = x.shape[0]
    check_pipeline(llm.cfg, groups.pp, b, num_microbatches, train)
    sched = _Schedule(llm, groups, attention_mask, positions,
                      num_microbatches, train)
    if not torch.is_grad_enabled():
        return sched.forward(x, record=False)
    anchor = torch.empty(0, device=x.device, requires_grad=True)
    return _GPipe.apply(x, anchor, sched)


def data_rows(rows: int, groups, num_microbatches: Optional[int] = None
              ) -> Tuple[int, int]:
    """(offset, count) of this rank's contiguous block of a batch's rows
    over the data axes (dcn, dp), the one split of Trainer.place_batch and
    pipeline_lm_loss: the rows shard when the data ranks divide them and,
    pipelined (num_microbatches given), when they divide each
    microbatch's rows too (else every rank takes them all, with JAX's
    warning)."""
    shard = (microbatch_rows_shard(rows, num_microbatches, groups.data)
             if num_microbatches else rows % groups.data == 0)
    per = rows // groups.data if shard else rows
    return (groups.data_rank * per if per < rows else 0), per


def pipeline_lm_loss(llm, groups, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, labels: torch.Tensor, *,
                     num_microbatches: int, train: bool = True
                     ) -> torch.Tensor:
    """The causal-LM loss of the whole batch (every rank passes all of
    it) with the layer stack pipelined over pp: this rank's share, the
    shares of the pp and data ranks summing to the loss (module
    docstring). The rows split over the data axes as data_rows says. The
    embedding and the head run on every pp rank."""
    from ..models.gllm.model import lm_loss
    b = input_ids.shape[0]
    check_pipeline(llm.cfg, groups.pp, b, num_microbatches, train)
    off, per = data_rows(b, groups, num_microbatches)
    count, scale = None, 1.0 / groups.pp
    if per < b:
        input_ids, attention_mask, labels = (
            t[off:off + per] for t in (input_ids, attention_mask, labels))

        def count(n):
            n = n.detach().clone()
            dist.all_reduce(n, group=groups.data_group)
            return n
    else:
        scale /= groups.data   # every data rank computes the whole batch
    positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
    x = llm.embed_tokens(input_ids)
    hidden = pipeline_decoder_forward(
        llm, x, attention_mask, positions, groups,
        num_microbatches=num_microbatches, train=train)
    logits, _ = llm.finalize_hidden(hidden)
    return lm_loss(logits, labels, IGNORE_INDEX, count) * scale


# -- placement of the stages ---------------------------------------------------

def _layer_tensors(layer):
    """A layer's parameters and buffers, in module order."""
    return list(layer.parameters()) + list(layer.buffers())


def place_stages(model, groups) -> None:
    """Trainer placement over pp: this rank holds and trains its stage's
    layers alone. The other stages' layers (their frozen base, adapter
    and buffers) give up their storage here, as FSDP frees what it does
    not own, and their trainable leaves stop requiring grad;
    gather_stages brings them back from their stages where the whole
    model is needed (generation after training). The embedding, the
    final norm, the head and the connectors stay on every pp rank."""
    from ..train.optimizers import local_data
    llm = model.llm
    cfg = llm.cfg
    own = set(stage_layers(cfg.num_layers, groups.pp, groups.pp_rank))
    foreign = [layer for i, layer in enumerate(llm.layers) if i not in own]
    gone = {id(t) for layer in foreign for t in _layer_tensors(layer)}
    kept = {local_data(t).untyped_storage().data_ptr()
            for t in list(model.parameters()) + list(model.buffers())
            if id(t) not in gone}
    storages = {}
    for layer in foreign:
        for t in _layer_tensors(layer):
            t.requires_grad_(False)
            st = local_data(t).untyped_storage()
            if st.data_ptr() not in kept:
                storages.setdefault(st.data_ptr(), (st, st.nbytes()))
    for st, _ in storages.values():
        st.resize_(0)
    model.pp_freed = list(storages.values())


@torch.no_grad()
def gather_stages(model, groups) -> None:
    """Every layer whole on every pp rank again after place_stages: the
    freed storage reallocated and each layer's tensors broadcast from
    its stage over the pp group (every pp rank calls it)."""
    from ..train.optimizers import local_data
    if not model.pp_freed:
        return
    for st, nbytes in model.pp_freed:
        st.resize_(nbytes)
    model.pp_freed = []
    cfg = model.llm.cfg
    for i, layer in enumerate(model.llm.layers):
        src = dist.get_global_rank(groups.pp_group,
                                   stage_of(i, cfg.num_layers, groups.pp))
        for t in _layer_tensors(layer):
            dist.broadcast(local_data(t), src, group=groups.pp_group)


def every_stage(obj, groups) -> list:
    """Each pp rank's picklable `obj`, in stage order (an object
    all-gather over the pp group)."""
    every = [None] * groups.pp
    dist.all_gather_object(every, obj, group=groups.pp_group)
    return every


def gather_stage_dicts(parts: Dict[str, torch.Tensor], groups
                       ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of this pp rank joined with every other pp rank's
    (a checkpoint's state), each stage's own leaves taken from it (leaves
    replicated over pp are equal on every stage)."""
    every = every_stage({n: t.detach().cpu() for n, t in parts.items()},
                        groups)
    dev = next(iter(parts.values())).device if parts else None
    out = {}
    for stage_parts in every:
        for n, t in stage_parts.items():
            out.setdefault(n, t.to(dev))
    return out
