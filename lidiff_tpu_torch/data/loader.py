"""Minimal threaded data loader with prefetch (counterpart of
lidiff_tpu/data/loader.py): shuffling, batching via data/collation.collate,
and a background prefetch queue that overlaps host preprocessing (FPS, map
crops) with device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from lidiff_tpu_torch.data.collation import collate


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 part_key: str = "pcd_part", num_workers: int = 2,
                 seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.part_key = part_key
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        batches = list(self._index_batches())
        self.epoch += 1
        stop = threading.Event()

        work_q: queue.Queue = queue.Queue()
        results: dict[int, dict] = {}
        results_lock = threading.Lock()
        for i, b in enumerate(batches):
            work_q.put((i, b))

        # bounds materialized-ahead batches: a worker must hold a slot
        # before it starts building a batch; the consumer releases the slot
        # when it pops the result. At most prefetch + num_workers batches
        # ever exist ahead of the consumer (prefetch queued + one in
        # flight per worker), so host RAM stays bounded at the real
        # operating point (180k x 3 f32 full+part per item).
        slots = threading.Semaphore(self.prefetch + self.num_workers)

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    i, b = work_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    items = [self.dataset[int(j)] for j in b]
                    batch = collate(items, self.part_key)
                except Exception as e:            # surface in main thread
                    batch = e
                with results_lock:
                    results[i] = batch

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            for i in range(len(batches)):
                while True:
                    with results_lock:
                        if i in results:
                            batch = results.pop(i)
                            break
                    if not any(t.is_alive() for t in threads) \
                            and i not in results:
                        with results_lock:
                            if i in results:
                                continue
                        raise RuntimeError("data workers died")
                    stop.wait(0.005)
                slots.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
