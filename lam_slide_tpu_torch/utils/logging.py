"""Process-aware logging (counterpart of ``lam_slide_tpu/utils/logging.py``;
the reference's RankedLogger, src/utils/pylogger.py). The port runs one
process, so process 0 is the only one; a multi-process launcher sets
``RANK`` and only rank 0 prints."""

import os

_seen = set()


def host0_print(*args, **kwargs):
    """Print only on process 0."""
    if int(os.environ.get("RANK", "0")) == 0:
        print(*args, **kwargs)


def log_once(msg: str):
    if msg not in _seen:
        _seen.add(msg)
        host0_print(msg)
