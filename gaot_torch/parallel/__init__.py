"""Multi-GPU training over ``torch.distributed``: the process mesh, data
and tensor parallelism (``mesh.py``), the collectives (``comm.py``) and
spatial (query) sharding (``spatial.py``). Counterpart of
``gaot_tpu/parallel/``."""
from .mesh import (
    Mesh,
    full_state_dict,
    init_distributed,
    load_full_state,
    make_mesh,
    param_specs,
    shard_batch,
    shard_model,
)

__all__ = [
    "Mesh",
    "full_state_dict",
    "init_distributed",
    "load_full_state",
    "make_mesh",
    "param_specs",
    "shard_batch",
    "shard_model",
]
