"""Host-side prefetching loader (counterpart of
``chore_tpu/data/loader.py``).

A pool of workers maps the dataset's ``__getitem__`` over each batch;
batches are collated to numpy, and a small prefetch queue overlaps that
host work (decode, crop, sampling) with the consumer's device work. The
defaults are ``cli.recon``'s (dataset order, 4 threads, the last batch
kept even if partial); training asks for per-epoch shuffling seeded by
``seed + epoch`` (``set_epoch``), its process's shard of a multi-process
job and ``drop_last``. Workers are threads (``worker_type="thread"``) or
spawned processes (``"process"``, for GIL-bound sampling), which import
only numpy code and never touch CUDA.

``prefetch_to_device`` stages the next batches on the card: pinned host
memory, ``non_blocking`` copies on a side stream, each batch ordered
before its use by a CUDA event.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(item):
    # the epoch travels with the index: the worker's copy of the dataset
    # was pickled when the pool started and never sees set_epoch
    i, epoch = item
    if hasattr(_WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(epoch)
    return _WORKER_DATASET[i]


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


def _queue_iter(produce, size):
    """Run ``produce(put)`` in a thread and yield what it puts, in order.
    ``put`` returns False once the consumer has gone (the producer then
    stops); an exception in the producer is raised at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    END, ERR = object(), object()

    def put(item):
        # a bounded put: a consumer that abandons the loop sets ``stop``,
        # and the producer must see it even on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        # every exception reaches the consumer: a producer that died
        # without a sentinel would leave it blocked on q.get()
        try:
            produce(put)
        except BaseException as e:  # noqa: BLE001 - raised at consumer
            put((ERR, e))
            return
        put(END)

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, num_workers=4,
                 drop_last=False, seed=0, prefetch=2, shard_index=0,
                 shard_count=1, worker_type="thread"):
        self._pool = None  # the process pool, spawned on first use
        if worker_type not in ("thread", "process"):
            raise ValueError(worker_type)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.worker_type = worker_type
        self.epoch = 0

    def _process_pool(self):
        if self._pool is None:
            # spawn, not fork: the parent holds threads and a CUDA context
            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_worker_init,
                initargs=(self.dataset,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        self.close()

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        # this process's shard, wrap-padded so every shard has the same
        # number of items: unequal shards would give the processes
        # different batch counts and hang the last step's all-reduce
        if self.shard_count > 1:
            total = -(-n // self.shard_count) * self.shard_count
            idx = np.resize(idx, total)[self.shard_index::self.shard_count]
        if self.drop_last:
            idx = idx[: len(idx) - len(idx) % self.batch_size]
        return idx

    def __len__(self):
        n = len(self._indices())
        return -(-n // self.batch_size)

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]

        def produce(put):
            if self.worker_type == "process" and self.num_workers > 0:
                pool = self._process_pool()
                for b in batches:
                    items = pool.map(_worker_get,
                                     [(i, self.epoch) for i in b])
                    if not put(collate(items)):
                        return
                return
            with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                for b in batches:
                    items = list(pool.map(self.dataset.__getitem__, b))
                    if not put(collate(items)):
                        return

        return _queue_iter(produce, self.prefetch)


def _to_device(batch, device, stream):
    """Host batch -> tensors on ``device``. On the card: each array pinned
    and copied ``non_blocking`` on ``stream``; an event recorded after the
    copies is returned with the batch."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = v
            continue
        t = torch.as_tensor(v)
        if device.type == "cuda":
            with torch.cuda.stream(stream):
                t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    if device.type != "cuda":
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def prefetch_to_device(iterator, device, size=2):
    """Stage the next ``size`` batches of ``iterator`` on ``device`` while
    the consumer computes. On the card the copies run on a side stream
    from pinned memory; before a batch is yielded the consumer's stream
    waits for its copies, and its tensors are marked as used on that
    stream (so their memory is not reused under it). Images travel as
    the loader's uint8. Exceptions of the source or the copy are raised at
    the consumer's next pull; an abandoned consumer stops the thread."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def produce(put):
        for batch in iterator:
            if not put(_to_device(batch, device, stream)):
                return

    for batch, event in _queue_iter(produce, size):
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        yield batch
