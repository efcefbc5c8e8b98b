"""Host-side data loader: shuffle, batch, collate, prefetch (copied from
``lam_slide_tpu/data/loader.py``), and ``device_batch``, which moves a numpy
batch to the card.

One background thread builds the batches (the per-sample work is numpy
slicing and a 3x3 rotation; the expensive preprocessing happens once when a
dataset is built), so it keeps a step loop fed. A dataset may offer a
whole-batch path (``sample_batch``), which the loader takes for the
canonical padded collate: the same semantics as ``sample`` + collate, with
other (equally distributed) augmentation draws. The multi-host sharding of
the JAX loader waits for the port's ``parallel/``.
"""

import functools
import queue
import threading
from typing import Callable, Dict, Iterator, Mapping, Sequence

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
    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        collate_fn: Callable[[Sequence[Dict[str, np.ndarray]]], Dict[str, np.ndarray]],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
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
            yield order[i * self.batch_size : (i + 1) * self.batch_size]

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
