"""Multi-GPU generation, serving and training: the process group, the (dp,
sp, tp) mesh, parameter sharding, the collectives that differentiate, fsdp's
choice of dimension and the GPipe schedule (counterpart of
``eeg2video_tpu/parallel``). One process per GPU; the collectives are
explicit ``torch.distributed`` calls."""

from .distributed import init_distributed, local_batch_slice
from .mesh import (Mesh, copy_to, fsdp_spec, gather_batch, is_host0, make_fold_mesh, make_mesh,
                   reduce_from, shard_batch, shard_params, shard_params_fsdp, tp_spec)
from .pipeline import gpipe_apply

__all__ = ["Mesh", "copy_to", "fsdp_spec", "gather_batch", "gpipe_apply",
           "init_distributed", "is_host0", "local_batch_slice", "make_fold_mesh", "make_mesh",
           "reduce_from", "shard_batch", "shard_params", "shard_params_fsdp", "tp_spec"]
