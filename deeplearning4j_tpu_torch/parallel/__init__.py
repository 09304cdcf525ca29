"""The parallel stack of the port: the counterpart of
`deeplearning4j_tpu/parallel/`.

One rank per device over `torch.distributed` (NCCL between GPUs, gloo
between CPU processes and between processes sharing a card): `make_mesh`
names the ranks' axes and makes their groups, `ParallelTrainer` trains
SYNC (REPLICATED, ZERO1, ZERO2, FSDP, TENSOR_PARALLEL, ZERO1_TP, PP,
ZERO1_TP_PP, PIPELINE) or AVERAGING with collectives issued by hand
(`collectives.py`, `zero.py`, `tp.py`, `pipeline.py`), `ring_attention.py`
holds sequence parallelism, `elastic.py` the elastic trainer,
`checkpoint.py` the sharded store and the coordinated two-phase-commit
store, and `distributed.py` the rendezvous and the evaluation plane's
merges.

JAX's `parallel/compat.py` is a shim over `shard_map`'s two spellings; it
has no counterpart: the port's SPMD is `torch.distributed`'s one rank per
device. JAX's `scaling_bench.py` measures strong scaling over a pod's
devices; the card's machine has one card, so it is ported after the
zoo's benches (ROADMAP A12).
"""
from .checkpoint import (CoordinatedShardStore, ElasticWorkerLost,
                         ShardedCheckpoint, restore_sharded, save_sharded)
from .elastic import (CoordinatedCheckpoint, DrainSignal, ElasticTrainer,
                      HeartbeatLease)
from .distributed import (allgather_rows, allreduce_evaluation, global_mesh,
                          initialize, is_multi_host, local_batch_slice,
                          process_index)
from .mesh import (Mesh, MeshAxes, make_hybrid_mesh, make_mesh,
                   surviving_mesh_shape)
from .pipeline import (PipelinedDenseStack, PipelinedGraphTrainer,
                       PipelinedNetworkTrainer, PipelinePlan,
                       make_pp_accum_superstep, make_pp_step,
                       pipeline_forward)
from .ring_attention import (blockwise_attention, local_attention_reference,
                             ring_attention_sharded, ring_self_attention)
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
    "CoordinatedShardStore", "ElasticWorkerLost", "CoordinatedCheckpoint",
    "DrainSignal", "ElasticTrainer", "HeartbeatLease",
    "PipelinedDenseStack", "PipelinedGraphTrainer",
    "PipelinedNetworkTrainer", "PipelinePlan", "make_pp_accum_superstep",
    "make_pp_step", "pipeline_forward",
    "blockwise_attention", "local_attention_reference",
    "ring_attention_sharded", "ring_self_attention",
    "ZeroConfig", "assign_buckets", "collective_overlap_fraction",
    "make_zero_accum_superstep", "make_zero_step", "zero_grad_specs",
    "zero_opt_shardings",
]
