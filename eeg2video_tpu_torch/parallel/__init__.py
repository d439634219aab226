"""Multi-GPU generation: the process group, the (dp, sp, tp) mesh and
parameter sharding (counterpart of ``eeg2video_tpu/parallel``). One process
per GPU; the collectives are explicit ``torch.distributed`` calls."""

from .distributed import init_distributed, local_batch_slice
from .mesh import (Mesh, gather_batch, is_host0, make_mesh, shard_batch,
                   shard_params)

__all__ = ["Mesh", "gather_batch", "init_distributed", "is_host0", "local_batch_slice",
           "make_mesh", "shard_batch", "shard_params"]
