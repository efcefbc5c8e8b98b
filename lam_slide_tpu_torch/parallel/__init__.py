"""Data parallelism, FSDP2, tensor parallelism and ring attention over
``torch.distributed`` (counterpart of ``lam_slide_tpu/parallel``)."""

from lam_slide_tpu_torch.parallel.fsdp import (
    fsdp_spec,
    shard_model,
    shard_train_state_fsdp,
    sharded_share,
)
from lam_slide_tpu_torch.parallel.mesh import (
    LocalBatch,
    MeshSpec,
    batch_sharding,
    init_distributed,
    make_mesh,
    model_group,
    model_rank,
    model_size,
    replicated,
    run_ranks,
    shard_batch,
)
from lam_slide_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ring_attention_chunks,
    sequence_parallel_attention,
)
from lam_slide_tpu_torch.parallel.tp import (
    dit_tp_spec,
    gather_state_dict,
    gather_tree,
    shard_train_state,
)

__all__ = [
    "LocalBatch",
    "MeshSpec",
    "batch_sharding",
    "dit_tp_spec",
    "fsdp_spec",
    "gather_state_dict",
    "gather_tree",
    "init_distributed",
    "make_mesh",
    "model_group",
    "model_rank",
    "model_size",
    "reference_attention",
    "replicated",
    "ring_attention",
    "ring_attention_chunks",
    "run_ranks",
    "sequence_parallel_attention",
    "shard_batch",
    "shard_model",
    "shard_train_state",
    "shard_train_state_fsdp",
    "sharded_share",
]
