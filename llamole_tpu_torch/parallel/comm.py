"""Collectives of mesh training, with the gradients they need.

The tensor-parallel LLM runs Megatron's two conjugate operators on each
rank's local shards (arXiv 1909.08053, section 3):

  to_tp     identity forward, all-reduce backward: a replicated tensor
            entering a product with sharded weights (its gradient comes
            back partial on each rank);
  from_tp   all-reduce forward, identity backward: partial products of
            row-sharded weights summed into the replicated activation.

The expert-parallel MoE (models/gllm/model.py moe_mlp) runs the same
pair over the ep axis: to_tp brings the tokens to this rank's experts,
from_tp sums the ranks' expert outputs. `all_reduce_sum` is the sum
over a group whose every rank goes on to its own loss (its backward
sums the ranks' gradients: the router's load-balancing statistics over
the data group), and `gather_counts` all-gathers a small integer vector
(the per-expert unit counts) in a given rank order. `ring_exchange` is
ring attention's rotation step (ops/ring_attention.py): each rank sends
its tensors to the next rank of the ring and receives the previous
rank's, point to point.

`gather_last` all-gathers the vocab-sharded logits (its backward takes
this rank's slice back); DoRA's row norm under row-parallel o / down
sums its squares in models/gllm/lora.py. `all_reduce_max` is W8A8's
per-token amax over a row-parallel projection's input shards (its
backward sends each row's gradient to the ranks that hold the row's
max, as the gradient of one max over the whole row does), and
`gathered_linear` is ZeRO-3's product with a frozen weight whose dp
chunks no FSDP2 unit gathers for this use (the tied head reading the
embedding): it all-gathers the weight in the forward and again in the
backward rather than keeping it. The other helpers are the
optimizer's and the loss's plain, gradient-free reductions; the
optimizer's go in buckets, one collective per bucket of tensors of one
dtype rather than one per parameter.

The inference legs run one process per rank, each executing the host
code: `broadcast_object` hands every rank the host decision of a group's
first rank (the planner's stop, a generator's state), `gather_rows`
joins each dp rank's per-row results (token rows, SMILES, template
proposals) in the global row order. Both pickle through
torch.distributed's object collectives, which NCCL carries as byte
tensors on the rank's card.
"""

from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _ToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad[..., ctx.rank * w:(ctx.rank + 1) * w], None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _max_over(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = _max_over(x, group)
        held = (x == out).to(x.dtype)
        count = held.clone()
        dist.all_reduce(count, group=group)
        ctx.save_for_backward(held / count)
        return out

    @staticmethod
    def backward(ctx, grad):
        share, = ctx.saved_tensors
        return grad * share, None


class _GatheredLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim, size, group):
        ctx.save_for_backward(shard)
        ctx.how = (dim, size, group)
        return F.linear(x, all_gather_dim(shard, dim, size, group))

    @staticmethod
    def backward(ctx, grad):
        shard, = ctx.saved_tensors
        return grad @ all_gather_dim(shard, *ctx.how), None, None, None, None


def to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ToTP.apply(x, group)


def from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _FromTP.apply(x, group)


def gather_last(x: torch.Tensor, group, size: int, rank: int
                ) -> torch.Tensor:
    return _GatherLast.apply(x, group, size, rank)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the group, on every rank. Its
    gradient goes to the ranks whose x equals the max (split evenly
    between ties), when every rank's result feeds the same replicated
    computation."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceMax.apply(x, group)
    return _max_over(x, group)


def gathered_linear(x: torch.Tensor, shard: torch.Tensor, dim: int,
                    size: int, group) -> torch.Tensor:
    """F.linear(x, w) where w is the frozen weight whose chunks along
    `dim` the group's ranks hold (this rank's: shard); w is all-gathered
    for the product and again for x's gradient, never kept."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatheredLinear.apply(x, shard, dim, size, group)
    return F.linear(x, all_gather_dim(shard, dim, size, group))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group on every rank, differentiable when
    each rank's result feeds a loss of its own: the gradient of x is the
    sum of the ranks' gradients of the result."""
    return _AllReduceSum.apply(x, group)


def gather_counts(counts: torch.Tensor, order: int, size: int,
                  group) -> torch.Tensor:
    """[size, n] of every rank's integer vector counts [n], row i being
    the rank whose `order` is i (a group's rank order need not be the
    mesh coordinate's)."""
    mine = torch.cat([counts.new_tensor([order]), counts])
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine, group=group)
    rows = torch.stack(parts)
    return rows[rows[:, 0].argsort()][:, 1:]


def ring_exchange(tensors: Sequence[torch.Tensor], group
                  ) -> List[torch.Tensor]:
    """One step of a ring: each tensor sent to the next rank of the group
    (group rank i to i + 1, the last to the first), the previous rank's
    received in its place, in one batch of point-to-point operations."""
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, in place (no gradient)."""
    dist.all_reduce(t, group=group)
    return t


# the bucketed collectives of the optimizer: one call per bucket of
# tensors of one dtype, up to this many bytes (a larger tensor alone)
BUCKET_BYTES = 1 << 28


def _buckets(tensors: Dict[str, torch.Tensor]) -> List[List[str]]:
    """The names of `tensors`, in order within each dtype, cut into
    buckets of at most BUCKET_BYTES."""
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(n)
    out = []
    for names in by_dtype.values():
        cur: List[str] = []
        nbytes = 0
        for n in names:
            b = tensors[n].numel() * tensors[n].element_size()
            if cur and nbytes + b > BUCKET_BYTES:
                out.append(cur)
                cur, nbytes = [], 0
            cur.append(n)
            nbytes += b
        if cur:
            out.append(cur)
    return out


def all_reduce_many(tensors: Dict[str, torch.Tensor],
                    group) -> Dict[str, torch.Tensor]:
    """Each tensor summed over the group (new tensors), one all-reduce
    per bucket."""
    out = {}
    for names in _buckets(tensors):
        flat = torch.cat([tensors[n].reshape(-1) for n in names])
        dist.all_reduce(flat, group=group)
        parts = flat.split([tensors[n].numel() for n in names])
        for n, part in zip(names, parts):
            out[n] = part.view(tensors[n].shape)
    return out


def reduce_scatter_many(tensors: Dict[str, torch.Tensor],
                        dims: Dict[str, int], size: int,
                        group) -> Dict[str, torch.Tensor]:
    """Each tensor summed over the group, of which this rank keeps its
    chunk along dims[name] (ZeRO-1's gradient reduction), one
    reduce-scatter per bucket: row r of the bucket holds every tensor's
    chunk r."""
    out = {}
    for names in _buckets(tensors):
        moved = {n: tensors[n].movedim(dims[n], 0) for n in names}
        flat = torch.cat([moved[n].reshape(size, -1) for n in names], dim=1)
        mine = torch.empty(flat.shape[1], dtype=flat.dtype,
                           device=flat.device)
        dist.reduce_scatter_tensor(mine, flat.reshape(-1), group=group)
        parts = mine.split([moved[n].numel() // size for n in names])
        for n, part in zip(names, parts):
            m = moved[n]
            out[n] = part.view(m.shape[0] // size,
                               *m.shape[1:]).movedim(0, dims[n])
    return out


def all_gather_many(chunks: Dict[str, torch.Tensor], dims: Dict[str, int],
                    size: int, group) -> Dict[str, torch.Tensor]:
    """The group's chunks of each tensor joined along dims[name] in rank
    order (reduce_scatter_many's layout), one all-gather per bucket."""
    out = {}
    for names in _buckets(chunks):
        moved = {n: chunks[n].movedim(dims[n], 0) for n in names}
        flat = torch.cat([moved[n].reshape(-1) for n in names])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        whole = torch.stack(parts)
        off = 0
        for n in names:
            m = moved[n]
            k = m.numel()
            out[n] = whole[:, off:off + k].reshape(
                size * m.shape[0], *m.shape[1:]).movedim(0, dims[n])
            off += k
    return out


def all_gather_dim(shard: torch.Tensor, dim: int, size: int,
                   group) -> torch.Tensor:
    """The chunks of the group's ranks along `dim`, in rank order."""
    parts: List[torch.Tensor] = [torch.empty_like(shard.contiguous())
                                 for _ in range(size)]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj: Any, group=None) -> Any:
    """The group's first rank's `obj` (picklable), on every rank of the
    group (the default group when None)."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_rows(rows: Sequence[Any], group, size: int) -> List[Any]:
    """Each rank's list of per-row results joined in rank order (rank r
    holds the r-th block of the global rows), on every rank."""
    parts: List[Any] = [None] * size
    dist.all_gather_object(parts, list(rows), group=group)
    return [r for part in parts for r in part]


