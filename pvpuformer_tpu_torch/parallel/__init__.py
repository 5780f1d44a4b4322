"""Scale-out on torch.distributed (pvpuformer_tpu/parallel): the process
group helpers (`dist`) and the ("data", "model") mesh with its batch and
parameter placements (`mesh`)."""
from .dist import (get_rank, get_world_size, init, is_master,  # noqa: F401
                   reduce_metrics, synchronize)
from .mesh import make_mesh, shard_batch, shard_params  # noqa: F401
