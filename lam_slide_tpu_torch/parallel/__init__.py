"""Data parallelism, FSDP2 and ring attention over ``torch.distributed``
(counterpart of ``lam_slide_tpu/parallel``; its tensor parallelism, tp.py,
is not ported)."""

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

__all__ = [
    "LocalBatch",
    "MeshSpec",
    "batch_sharding",
    "fsdp_spec",
    "init_distributed",
    "make_mesh",
    "reference_attention",
    "replicated",
    "ring_attention",
    "ring_attention_chunks",
    "run_ranks",
    "sequence_parallel_attention",
    "shard_batch",
    "shard_model",
    "shard_train_state_fsdp",
    "sharded_share",
]
