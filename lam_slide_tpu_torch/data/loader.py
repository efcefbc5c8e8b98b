"""Host-side data loader: shuffle, batch, collate, prefetch (copied from
``lam_slide_tpu/data/loader.py``), and ``device_batch``, which moves a numpy
batch to the card.

One background thread builds the batches (the per-sample work is numpy
slicing and a 3x3 rotation; the expensive preprocessing happens once when a
dataset is built), so it keeps a step loop fed. A dataset may offer a
whole-batch path (``sample_batch``), which the loader takes for the
canonical padded collate: the same semantics as ``sample`` + collate, with
other (equally distributed) augmentation draws. ``process_shard`` feeds
one rank of a data-parallel run its slice of each global batch (JAX's
multi-host feeding, loader.py:57-110).
"""

import functools
import queue
import threading
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from lam_slide_tpu_torch.data import collate as _collate


class Dataset:
    """Minimal map-style dataset protocol: __len__ + sample(idx, rng)."""

    def __len__(self) -> int:  # pragma: no cover - protocol
        raise NotImplementedError

    def sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError  # pragma: no cover - protocol


def _is_canonical_collate(collate_fn, dataset) -> bool:
    """The whole-batch path is taken only for ``pad_collate_temporal`` itself,
    or ``functools.partial`` wrappers of it whose bound ``num_entities`` (if
    any) matches the dataset's own; any other collate goes per sample."""
    fn, bound_ne = collate_fn, None
    while isinstance(fn, functools.partial):
        # the outermost binding wins at call time
        if bound_ne is None and "num_entities" in fn.keywords:
            bound_ne = fn.keywords["num_entities"]
        fn = fn.func
    if fn is not _collate.pad_collate_temporal:
        return False
    ds_ne = getattr(dataset, "num_entities", None)
    return bound_ne is None or ds_ne is None or bound_ne == ds_ne


class Loader:
    # Multi-process default, set once by the entry point after the process
    # group starts (train/cli.py --multihost); every Loader built afterwards
    # feeds its process's slice of each global batch.
    default_process_shard: Optional[tuple] = None

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        collate_fn: Callable[[Sequence[Dict[str, np.ndarray]]], Dict[str, np.ndarray]],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_shard: Optional[tuple] = None,
    ):
        """process_shard=(index, count): multi-process data feeding — every
        process draws the SAME shuffled global order (same seed) and keeps
        the contiguous per-process slice of each batch, so the concatenation
        over processes is the single-process batch (the rows
        ``parallel.shard_batch`` gives rank ``index``). batch_size stays
        GLOBAL. Augmentation RNG streams differ per process (each draws only
        its slice): distributionally identical, not bit-reproducible across
        different process counts."""
        # full_batch_feed: the fallback for loaders that can't be
        # process-sharded (ragged final batch, non-divisible batch size):
        # every process draws identical full batches (same seed and order)
        # and shard_batch slices out each rank's rows. Correct but without
        # the per-process IO saving, which is why train loaders should use
        # drop_last=True under --multihost.
        self.full_batch_feed = False
        ambient = process_shard is None
        if ambient:
            process_shard = type(self).default_process_shard
        if process_shard is not None:
            pi, pc = process_shard
            if not 0 <= pi < pc:
                raise ValueError(f"bad process_shard {process_shard}")
            shardable = drop_last and batch_size % pc == 0
            if not shardable:
                if not ambient:
                    raise ValueError(
                        "process_shard requires drop_last=True and a "
                        "process-divisible batch_size (a ragged or uneven "
                        "batch would desynchronize hosts); drop "
                        "process_shard to use replicated full-batch feeding")
                process_shard = None
                self.full_batch_feed = True
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self, rng: np.random.Generator):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            if self.process_shard is not None:
                pi, pc = self.process_shard
                local = self.batch_size // pc
                idx = idx[pi * local : (pi + 1) * local]
            yield idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of batches; epoch e draws from np.random.default_rng((seed, e))."""
        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng((self.seed, epoch))
        batched = getattr(self.dataset, "sample_batch", None)
        if batched is not None and not _is_canonical_collate(self.collate_fn, self.dataset):
            batched = None
        stop = threading.Event()

        def produce(out_q: queue.Queue):
            try:
                for idx_batch in self._batch_indices(rng):
                    if stop.is_set():
                        return
                    if batched is not None:
                        batch = batched(idx_batch, rng)
                    else:
                        samples = [self.dataset.sample(int(i), rng) for i in idx_batch]
                        batch = self.collate_fn(samples)
                    out_q.put(batch)
            except BaseException as e:  # surface worker errors in the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early: let the producer finish its
            # current batch, see the flag, and end
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def device_batch(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: on a CUDA device each array is
    copied into pinned host memory and sent with ``non_blocking=True``, so the
    copy overlaps work already queued on the card; on the CPU the tensors
    share the arrays' memory."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out
