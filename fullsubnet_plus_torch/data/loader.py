"""Threaded prefetching batch loader (in place of torch's DataLoader).

Counterpart of fullsubnet_plus_tpu/data/loader.py. Worker threads
synthesize examples (numpy and scipy release the interpreter lock in their
kernels), a producer thread stacks them into batches and keeps `prefetch`
batches ready ahead of the training step. The order of an epoch is a
shuffle seeded by SeedSequence([seed, epoch]), so it is the same in every
run and after a resume.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fullsubnet_plus_torch.utils import logger


class BatchLoader:
    """Iterate (noisy [B, L], clean [B, L]) numpy batches one epoch at a time."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4,
                 drop_last: bool = True, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self):
        n, rest = divmod(len(self.dataset), self.batch_size)
        return n + (1 if rest and not self.drop_last else 0)

    def epoch(self, epoch: int):
        """Generator of the epoch's batches. A worker's exception is raised
        here, in the consumer; leaving the generator early stops the
        producer."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).shuffle(indices)
        if self.drop_last:
            indices = indices[: len(indices) - len(indices) % self.batch_size]
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that left early no longer drains: never block on a
            # full queue past `stop`
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        items = list(ex.map(self.dataset.__getitem__, batch_idx))
                        arrays = tuple(np.stack([item[i] for item in items])
                                       for i in range(len(items[0]))
                                       if isinstance(items[0][i], np.ndarray))
                        if not put(arrays):
                            return
            except BaseException as exc:  # noqa: BLE001 - raised again by the consumer
                put(exc)
            else:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while (batch := q.get()) is not None:
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=5.0)
            if thread.is_alive():
                logger.log("[Loader] WARNING: the producer thread is still alive 5 s after "
                           "stop; a worker is finishing its item and it exits at its next "
                           "stop check")
