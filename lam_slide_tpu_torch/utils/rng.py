"""Stable seeds (``stable_seed`` of ``lam_slide_tpu/utils/rng.py``, copied;
the JAX key helpers there have no counterpart: the port draws from
``torch.Generator``s)."""

import zlib


def stable_seed(*parts) -> int:
    """Deterministic 32-bit seed from arbitrary values.

    Python's builtin ``hash`` of strings is randomized per process
    (PYTHONHASHSEED), so seeding numpy from it makes "deterministic"
    synthetic data differ between runs. CRC32 over the repr is stable
    across processes and platforms.
    """
    return zlib.crc32(repr(parts).encode()) & 0xFFFFFFFF
