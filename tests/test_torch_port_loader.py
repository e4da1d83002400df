"""The port's ``data.loader.DataLoader`` (the ordered thread prefetch that
``cli.recon`` uses) against ``chore_tpu``'s with the arguments
``cli.recon`` gives it (no shuffle, the last batch kept): the same batches
in order; an empty dataset (a resumed sequence with every frame done); the
next batch prepared while the consumer works; error propagation; no
producer left behind an abandoned loop. ``cli.recon``'s use of it is held
by ``test_torch_port_cli.py`` (same outputs as the JAX package's CLI)."""
import threading
import time

import numpy as np
import pytest


class _Toy:
    def __init__(self, n=23):
        self.n = n
        self.asked = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.asked.append(i)
        return {"x": np.full((3,), i, np.float32), "idx": i, "path": f"p{i}"}


class _Broken(_Toy):
    def __getitem__(self, i):
        if i == 5:
            raise FileNotFoundError("mask missing")
        return super().__getitem__(i)


@pytest.mark.parametrize("batch_size", [1, 3, 4, 5, 23, 30])
def test_batches_equal_reference(batch_size):
    from chore_tpu.data.loader import DataLoader as JLoader
    from chore_tpu_torch.data.loader import DataLoader

    want = list(JLoader(_Toy(23), batch_size, shuffle=False, num_workers=2,
                        drop_last=False))
    got = list(DataLoader(_Toy(23), batch_size, num_workers=2))
    assert len(got) == len(want) == -(-23 // batch_size)
    for x, y in zip(got, want):
        assert sorted(x) == sorted(y)
        np.testing.assert_array_equal(x["x"], y["x"])
        np.testing.assert_array_equal(x["idx"], y["idx"])
        assert x["path"] == y["path"]


def test_empty_dataset():
    from chore_tpu_torch.data.loader import DataLoader

    assert list(DataLoader(_Toy(0), 2)) == []


def test_next_batch_prepared_while_consumer_works():
    from chore_tpu_torch.data.loader import DataLoader

    ds = _Toy(8)
    it = iter(DataLoader(ds, 2, num_workers=2, prefetch=1))
    first = next(it)
    assert list(first["idx"]) == [0, 1]
    deadline = time.time() + 10.0
    while len(ds.asked) < 4 and time.time() < deadline:
        time.sleep(0.01)  # the consumer "fits"; the producer runs ahead
    assert sorted(ds.asked[:4]) == [0, 1, 2, 3]
    assert [list(b["idx"]) for b in it] == [[2, 3], [4, 5], [6, 7]]


def test_dataset_error_reaches_consumer():
    from chore_tpu_torch.data.loader import DataLoader

    with pytest.raises(FileNotFoundError, match="mask missing"):
        list(DataLoader(_Broken(23), 4, num_workers=2))


def test_abandoned_consumer_frees_producer():
    from chore_tpu_torch.data.loader import DataLoader

    before = threading.active_count()
    it = iter(DataLoader(_Toy(64), 4, num_workers=1, prefetch=1))
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"
