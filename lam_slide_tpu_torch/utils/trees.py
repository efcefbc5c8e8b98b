"""State-dict helpers (counterpart of ``lam_slide_tpu/utils/trees.py``)."""

from typing import Any, Mapping, Optional

import torch


def tree_to_f32(tree: Optional[Mapping[str, Any]]):
    """Cast every floating tensor of a (nested) state dict to float32; leave
    the rest, and None, as they are.

    The fp32 test/eval protocol (reference src/train.py:100-118,
    configs/eval_peptide.yaml:19-25): bf16-trained checkpoints are sampled
    and tested 32-true, so any bf16-stored tensors are cast up before the
    protocol model is loaded with them.
    """
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, Mapping):
        return {k: tree_to_f32(v) for k, v in tree.items()}
    return tree
