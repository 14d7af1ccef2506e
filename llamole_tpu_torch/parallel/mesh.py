"""The device mesh of mesh training (counterpart of
llamole_tpu/parallel/mesh.py) as a torch.distributed DeviceMesh.

Axes, outermost first, as in the JAX package: dcn (data parallel across
hosts: only the gradient reduction crosses the network), pp, dp, ep, sp,
tp (innermost: the highest-traffic collectives ride the nearest ranks).
dp and tp always exist; the others only when > 1.

One process per rank (multi-controller): the world size must equal the
mesh's product. JAX takes the first `need` of more devices; here a rank
with no place in the mesh would have no work, so a mismatch raises.
`init_distributed` starts the process group from torchrun's environment:
NCCL on the card, gloo on the CPU.
"""

import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dcn", "pp", "dp", "ep", "sp", "tp")


def parse_mesh(spec: str) -> Dict[str, int]:
    """'dp:2,tp:4', 'dcn:2,dp:4', ... -> {axis: size} over every axis
    (TrainingArguments.mesh); '' is the 1 x 1 mesh. An unknown axis
    raises as the JAX mesh_from_string does."""
    dims = {name: 1 for name in AXES}
    if spec:
        for part in spec.split(","):
            name, _, num = part.partition(":")
            name = name.strip()
            if name not in dims:
                raise ValueError(f"unknown mesh axis {name!r}")
            dims[name] = int(num)
    return dims


def mesh_layout(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
                ep: int = 1, dcn: int = 1) -> Tuple[Tuple[str, ...],
                                                    Tuple[int, ...]]:
    """(axis names, shape) of the mesh, as JAX's create_mesh lays it out."""
    sizes = {"dcn": dcn, "pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp}
    kept = [(n, sizes[n]) for n in AXES if sizes[n] > 1 or n in ("dp", "tp")]
    return tuple(n for n, _ in kept), tuple(d for _, d in kept)


def _dcn_grouped(hosts: Sequence[Optional[str]], dcn: int,
                 per_group: int) -> List[int]:
    """Ranks ordered so each consecutive `per_group` block (one dcn group)
    lies on ONE host, hosts[r] being rank r's host: otherwise the dp / tp
    collectives would cross the network. The contiguous order when the
    hosts cannot honour that (a rank without a host, fewer hosts than
    dcn groups, or blocks that would straddle two hosts)."""
    ranks = list(range(len(hosts)))
    if any(h is None for h in hosts) or len(set(hosts)) < dcn:
        return ranks
    ordered = sorted(ranks, key=lambda r: (hosts[r], r))
    used = ordered[:dcn * per_group]
    if len(used) < dcn * per_group:
        return ranks
    for g in range(dcn):
        block = used[g * per_group:(g + 1) * per_group]
        if len({hosts[r] for r in block}) != 1:
            return ranks
    return ordered


def _world_size() -> int:
    """The process group's size, or before it starts torchrun's
    WORLD_SIZE (1 without torchrun)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def check_world(dims: Dict[str, int]) -> None:
    """The world size must equal the mesh's product (module docstring)."""
    need, world = 1, _world_size()
    for n in dims.values():
        need *= n
    if world != need:
        shape = " ".join(f"{k}={v}" for k, v in dims.items())
        raise ValueError(
            f"mesh {shape} needs {need} ranks, the process group has "
            f"{world}: with one process per rank the world size must "
            "equal the mesh (JAX takes the first devices of more; a rank "
            "outside the mesh would have no work)")


def create_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
                ep: int = 1, dcn: int = 1, device_type: Optional[str] = None):
    """The dcn x pp x dp x ep x sp x tp DeviceMesh over the process group
    (`init_distributed` first). device_type: 'cuda' or 'cpu' (default:
    cuda when the group's backend is NCCL)."""
    from torch.distributed.device_mesh import DeviceMesh
    names, shape = mesh_layout(dp, tp, sp, pp, ep, dcn)
    need = dp * tp * sp * pp * ep * dcn
    check_world(dict(dcn=dcn, pp=pp, dp=dp, ep=ep, sp=sp, tp=tp))
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "init_distributed (torchrun) first")
    ranks = list(range(need))
    if dcn > 1:
        hosts: List[Optional[str]] = [None] * need
        dist.all_gather_object(hosts, socket.gethostname())
        ranks = _dcn_grouped(hosts, dcn, need // dcn)
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def mesh_from_string(spec: str, device_type: Optional[str] = None):
    """create_mesh from 'dp:2,tp:2', 'dcn:2,dp:2', ...; '' is 1 x 1."""
    d = parse_mesh(spec)
    return create_mesh(d["dp"], d["tp"], d["sp"], d["pp"], d["ep"], d["dcn"],
                       device_type)


def init_distributed(device: str = "cuda") -> Tuple[int, int]:
    """Start the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the
    card): NCCL for 'cuda', gloo for 'cpu'. Without torchrun's
    variables a one-rank group on localhost. Returns (rank, world size);
    an existing group is kept."""
    if not dist.is_initialized():
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("init_distributed('cuda') without a card")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        env = os.environ
        rank = int(env.get("RANK", 0))
        world = int(env.get("WORLD_SIZE", 1))
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init = None
        else:
            if world != 1:
                raise RuntimeError("WORLD_SIZE > 1 without MASTER_ADDR / "
                                   "MASTER_PORT: start the ranks with "
                                   "torchrun")
            init = f"tcp://127.0.0.1:{_free_port()}"
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method=init, rank=rank,
                                world_size=world)
    return dist.get_rank(), dist.get_world_size()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MeshGroups:
    """What the trainer, the optimizer, the loss and the inference legs
    need of a mesh: each axis's size, this rank's coordinate, the tp
    group, the pp, ep and sp groups (None without their axis), and the
    data group over (dcn, dp) together (the gradient reduction's).

    As in JAX, a batch's rows shard over (dcn, dp) only: ep shards the
    MoE experts (the ranks along it hold the same rows and sum their
    experts' outputs), and sp carries ring attention's sequence shards
    (ops/ring_attention.py); a training step holds no sp work of its own,
    so the ranks along sp repeat it and the loss's data group stays
    (dcn, dp)."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.size = dict(zip(names, mesh.mesh.shape))
        coord = mesh.get_coordinate()
        self.coord = dict(zip(names, coord))
        self.dp, self.tp = self.size["dp"], self.size["tp"]
        self.dcn = self.size.get("dcn", 1)
        self.pp = self.size.get("pp", 1)
        self.dp_rank, self.tp_rank = self.coord["dp"], self.coord["tp"]
        self.pp_rank = self.coord.get("pp", 0)
        self.pp_group = mesh.get_group("pp") if self.pp > 1 else None
        self.ep, self.sp = self.size.get("ep", 1), self.size.get("sp", 1)
        self.ep_rank = self.coord.get("ep", 0)
        self.sp_rank = self.coord.get("sp", 0)
        self.ep_group = mesh.get_group("ep") if self.ep > 1 else None
        self.sp_group = mesh.get_group("sp") if self.sp > 1 else None
        self.tp_group = mesh.get_group("tp")
        self.dp_group = mesh.get_group("dp")
        self.dcn_group = mesh.get_group("dcn") if self.dcn > 1 else None
        self.data = self.dcn * self.dp
        self.data_rank = self.coord.get("dcn", 0) * self.dp + self.dp_rank
        self.data_group = (self._flat_group(("dcn", "dp")) if self.dcn > 1
                           else self.dp_group)
        self.world = self.data * self.tp * self.pp * self.ep * self.sp

    def _flat_group(self, axes) -> "dist.ProcessGroup":
        """The process group over `axes` together that holds this rank
        (every rank creates every such group, in one order)."""
        names = list(self.mesh.mesh_dim_names)
        grid = self.mesh.mesh
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(grid.dim()) if i not in keep]
        flat = grid.permute(rest + keep).reshape(-1, int(
            torch.tensor([grid.shape[i] for i in keep]).prod()))
        mine = None
        me = dist.get_rank()
        for row in flat.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        return mine
