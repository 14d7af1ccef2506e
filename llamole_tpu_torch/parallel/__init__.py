"""Mesh training and inference (counterpart of llamole_tpu/parallel/,
ROADMAP.md Queue 1 items 9a-9d): the dcn / pp / dp / ep / sp / tp
DeviceMesh (mesh.py), the JAX package's partition specs and their
DTensor / FSDP2 placements (sharding.py), the collectives the
tensor-parallel LLM, the expert-parallel MoE, ring attention, the
data-parallel loss and the inference legs call (comm.py), the GPipe
schedule over pp (pipeline.py), and the multi-process CPU rehearsal
(dryrun.py). Ring attention itself is ops/ring_attention.py."""

from .mesh import (MeshGroups, create_mesh, init_distributed,
                   mesh_from_string)
from .sharding import (fsdp_param_pspecs, llm_param_pspecs, replicate,
                       shard_params, zero1_opt_pspecs)
