"""Host-side prefetching loader (counterpart of
``chore_tpu/data/loader.py``: ``collate``, and the ordered thread prefetch
of its ``DataLoader`` that ``cli.recon`` uses).

A pool of worker threads maps the dataset's ``__getitem__`` over each
batch, in dataset order; batches are collated to numpy, and a small
prefetch queue overlaps that host work (decode, crop) with the consumer's
device work. The last batch may be partial. Shuffling, sharding and
process workers come with the training slice.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(items):
    """List of dicts -> dict of stacked arrays (non-array values listed)."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or (
            np.isscalar(vals[0]) and not isinstance(vals[0], str)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class DataLoader:
    def __init__(self, dataset, batch_size, num_workers=4, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __iter__(self):
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n))
                   for i in range(0, n, self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        END, ERR = object(), object()

        def put_or_stop(item):
            # a bounded put: a consumer that abandons the loop sets
            # ``stop``, and the producer must see it even on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # every exception reaches the consumer: a producer that died
            # without a sentinel would leave it blocked on q.get()
            try:
                with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        if not put_or_stop(collate(items)):
                            return
            except BaseException as e:  # noqa: BLE001 - raised at consumer
                put_or_stop((ERR, e))
                return
            put_or_stop(END)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is END:
                    return
                if isinstance(batch, tuple) and len(batch) == 2 \
                        and batch[0] is ERR:
                    raise batch[1]
                yield batch
        finally:
            stop.set()
