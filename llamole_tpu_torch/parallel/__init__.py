"""Mesh training (counterpart of llamole_tpu/parallel/, ROADMAP.md Queue 1
item 9a): the dp / tp / dcn DeviceMesh (mesh.py), the JAX package's
partition specs and their DTensor / FSDP2 placements (sharding.py), the
collectives the tensor-parallel LLM and the data-parallel loss call
(comm.py), and the multi-process CPU rehearsal (dryrun.py). The
pipeline schedule, ring attention, MoE expert parallelism and the
inference legs are item 9b: their axes raise."""

from .mesh import (ITEM_9B, MeshGroups, create_mesh, init_distributed,
                   mesh_from_string)
from .sharding import (fsdp_param_pspecs, llm_param_pspecs, replicate,
                       shard_params, zero1_opt_pspecs)
