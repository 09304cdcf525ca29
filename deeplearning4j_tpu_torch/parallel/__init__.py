"""The data-parallel stack of the port (ROADMAP A11a): the counterpart of
`deeplearning4j_tpu/parallel/` minus its model-parallel half (tensor
parallelism, the pipeline trainers, ring attention, the elastic trainer and
the scaling bench: ROADMAP A11b).

One rank per device over `torch.distributed` (NCCL between GPUs, gloo
between CPU processes): `make_mesh` names the ranks' axes,
`ParallelTrainer` trains SYNC (REPLICATED, ZERO1, ZERO2, FSDP) or
AVERAGING with collectives issued by hand (`zero.py`), `checkpoint.py`
holds the sharded store and the coordinated two-phase-commit store, and
`distributed.py` the rendezvous and the evaluation plane's merges.

JAX's `parallel/compat.py` is a shim over `shard_map`'s two spellings; it
has no counterpart: the port's SPMD is `torch.distributed`'s one rank per
device, and its collectives are the calls in `zero.py` and `trainer.py`.
"""
from .checkpoint import (CoordinatedShardStore, ElasticWorkerLost,
                         ShardedCheckpoint, restore_sharded, save_sharded)
from .distributed import (allgather_rows, allreduce_evaluation, global_mesh,
                          initialize, is_multi_host, local_batch_slice,
                          process_index)
from .mesh import (Mesh, MeshAxes, make_hybrid_mesh, make_mesh,
                   surviving_mesh_shape)
from .sharding import (PartitionSpec, ShardingStrategy, param_specs,
                       shard_model)
from .stats import TrainingStats, profiler_trace
from .trainer import (ParallelTrainer, ParallelWrapper, TrainingMode,
                      configure_flash_attention)
from .zero import (ZeroConfig, assign_buckets, collective_overlap_fraction,
                   make_zero_accum_superstep, make_zero_step,
                   zero_grad_specs, zero_opt_shardings)

__all__ = [
    "Mesh", "MeshAxes", "make_hybrid_mesh", "make_mesh",
    "surviving_mesh_shape",
    "PartitionSpec", "ShardingStrategy", "param_specs", "shard_model",
    "ParallelTrainer", "ParallelWrapper", "TrainingMode",
    "configure_flash_attention",
    "TrainingStats", "profiler_trace",
    "global_mesh", "initialize", "is_multi_host", "local_batch_slice",
    "process_index", "allgather_rows", "allreduce_evaluation",
    "ShardedCheckpoint", "restore_sharded", "save_sharded",
    "CoordinatedShardStore", "ElasticWorkerLost",
    "ZeroConfig", "assign_buckets", "collective_overlap_fraction",
    "make_zero_accum_superstep", "make_zero_step", "zero_grad_specs",
    "zero_opt_shardings",
]
