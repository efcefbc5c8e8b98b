"""Training (counterpart of ``lam_slide_tpu.train``): state, steps,
optimizer, the ``Trainer`` loop (``trainer.py``), checkpoints and the run
registry (``checkpoint.py``), metric sinks and the CLI (``cli.py``)."""

from lam_slide_tpu_torch.train.state import TrainState, create_train_state
from lam_slide_tpu_torch.train.steps import make_eval_step, make_train_step

__all__ = ["TrainState", "create_train_state", "make_eval_step", "make_train_step"]
