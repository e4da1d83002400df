"""The port's training data path against ``chore_tpu``'s, on files the test
writes (JPEG photos and masks, preprocessed npz frames with ``_flip``
twins):

* ``BehaveTrainData`` items for the same (seed, epoch, idx): points,
  UDFs, parts, PCA, centres and uint8 images bitwise, flips included; with
  the blur augmentation the images within 1 LSB of ``cv2.GaussianBlur``;
  a failing item is replaced by the same retry in both;
* the blur alone against ``cv2.GaussianBlur`` (1 LSB);
* the training loader's batches equal to ``chore_tpu``'s for shuffle x
  shard x drop_last across epochs, and with spawned process workers;
* ``prefetch_to_device`` passes exceptions through and stops when
  abandoned;
* ``DataPaths.load_splits`` (pkl and npz) equal to ``chore_tpu``'s."""
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_port_util import write_train_frames

SMALL = dict(total_samplenum=300, image_size=(64, 64), crop_size=200)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return write_train_frames(tmp_path_factory.mktemp("frames"), n=4)


def _pair(paths, **kw):
    from chore_tpu.data.train_data import BehaveTrainData as JData
    from chore_tpu_torch.data.train_data import BehaveTrainData

    return (BehaveTrainData(paths, **{**SMALL, **kw}),
            JData(paths, **{**SMALL, **kw}))


@pytest.mark.parametrize("phase,flip", [("train", True), ("val", True),
                                        ("train", False)])
def test_items_equal_reference(frames, phase, flip):
    ds, ref = _pair(frames, phase=phase, random_flip=flip, seed=3)
    flips = 0
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(frames)):
            got, want = ds[i], ref[i]
            assert set(got) == set(want)
            assert got["path"] == want["path"]
            flips += got["path"].endswith("_flip.npz")
            for k, v in want.items():
                if k == "path":
                    continue
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (flips > 0) == (phase == "train" and flip)


def test_blurred_items_within_one_lsb(frames):
    ds, ref = _pair(frames, aug_blur=0.02, seed=1)
    for i in range(len(frames)):
        got, want = ds[i], ref[i]
        np.testing.assert_array_equal(got["points"], want["points"])
        d = np.abs(got["images"].astype(int) - want["images"].astype(int))
        assert d.max() <= 1


@pytest.mark.parametrize("sigma", [0.4, 1.0, 2.0, 3.3, 12.7, 40.0])
def test_gaussian_blur_within_one_lsb_of_cv2(sigma):
    import cv2

    from chore_tpu_torch.data.image_ops import gaussian_blur_u8

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (150, 203, 3)).astype(np.uint8)
    img[40:90, 20:120] = 255
    k = int(2 * round(3 * sigma) + 1)
    d = np.abs(gaussian_blur_u8(img, k, sigma).astype(int)
               - cv2.GaussianBlur(img, (k, k), sigma).astype(int))
    assert d.max() <= 1


def test_failing_item_retries_like_reference(frames, tmp_path):
    paths = list(frames) + [str(tmp_path / "missing.npz")]
    ds, ref = _pair(paths, seed=2)
    got, want = ds[len(paths) - 1], ref[len(paths) - 1]
    assert got["path"] == want["path"] != paths[-1]
    np.testing.assert_array_equal(got["points"], want["points"])


class _Toy:
    """Items that name their index (picklable: a class at module level)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i)}


@pytest.mark.parametrize("shard_count", [1, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_equals_reference(shuffle, shard_count, drop_last):
    from chore_tpu.data.loader import DataLoader as JLoader
    from chore_tpu_torch.data.loader import DataLoader

    for shard in range(shard_count):
        kw = dict(shuffle=shuffle, num_workers=2, drop_last=drop_last,
                  seed=5, shard_index=shard, shard_count=shard_count)
        got, want = DataLoader(_Toy(23), 4, **kw), JLoader(_Toy(23), 4, **kw)
        for epoch in (0, 1, 7):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a = [b["idx"].tolist() for b in got]
            b = [b["idx"].tolist() for b in want]
            assert a == b and len(got) == len(want) == len(a)
    if shard_count > 1:  # every shard the same size (wrap-padded)
        sizes = {len(DataLoader(_Toy(23), 1, shard_index=s,
                                shard_count=shard_count)._indices())
                 for s in range(shard_count)}
        assert sizes == {8}


def test_process_workers_match_threads(frames):
    from chore_tpu_torch.data.loader import DataLoader
    from chore_tpu_torch.data.train_data import BehaveTrainData

    ds = BehaveTrainData(frames, random_flip=True, **SMALL)
    procs = DataLoader(ds, 2, shuffle=True, num_workers=2, drop_last=True,
                       worker_type="process")
    threads = DataLoader(ds, 2, shuffle=True, num_workers=2, drop_last=True)
    try:
        for epoch in (0, 1):
            procs.set_epoch(epoch)
            threads.set_epoch(epoch)
            for a, b in zip(procs, threads, strict=True):
                assert a["path"] == b["path"]
                for k in ("images", "points", "df_h", "parts"):
                    np.testing.assert_array_equal(a[k], b[k])
    finally:
        procs.close()
    with pytest.raises(ValueError):
        DataLoader(ds, 2, worker_type="fork")


def test_prefetch_to_device_errors_and_abandon():
    from chore_tpu_torch.data.loader import prefetch_to_device

    def source():
        yield {"x": np.arange(3, dtype=np.uint8), "name": ["a"]}
        raise FileNotFoundError("frame 2 missing")

    it = prefetch_to_device(source(), "cpu")
    first = next(it)
    assert first["x"].dtype == torch.uint8 and first["name"] == ["a"]
    with pytest.raises(FileNotFoundError, match="frame 2"):
        next(it)

    before = threading.active_count()
    endless = ({"x": np.zeros(4)} for _ in iter(int, 1))
    it = prefetch_to_device(endless, "cpu", size=1)
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("kind", ["pkl", "npz"])
def test_load_splits_equals_reference(tmp_path, kind):
    from chore_tpu.data.paths import DataPaths as JPaths
    from chore_tpu_torch.data.paths import DataPaths

    split = {"train": ["a/x.npz", "b/y.npz"], "test": ["c/z.npz"]}
    path = str(tmp_path / f"split.{kind}")
    if kind == "pkl":
        with open(path, "wb") as f:
            pickle.dump(split, f)
    else:
        np.savez(path, **{k: np.array(v) for k, v in split.items()})
    for root in (None, str(tmp_path / "processed")):
        assert (DataPaths.load_splits(path, root)
                == JPaths.load_splits(path, root))
    assert DataPaths.load_splits(path, "/p")[1] == [os.path.join("/p",
                                                                 "c/z.npz")]
