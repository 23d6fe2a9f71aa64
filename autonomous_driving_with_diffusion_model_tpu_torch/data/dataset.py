"""Trajectory dataset and its loaders (counterpart of the JAX package's
``data/dataset.py``; reference: dataset/carla_dataset.py:11-58).

* ``{root}/front/*.png``, sorted: the front-camera frames (900x256 RGB);
* ``{root}/waypoints/{idx:06d}.txt``: line 0 the 2-d target point, then 16
  lines of 7-d transitions, clipped to [-1, 1].

Host threads decode PNGs (``data/png.py``, no OpenCV) and parse text,
returning uint8 images; augmentation and normalization run on the device
(``data/augment.py``). :class:`Loader` shuffles with
``np.random.default_rng(seed + epoch)``, takes its shard's stride of the
permutation and drops the last partial batch, so it yields the same batches
in the same order as the JAX package's. :class:`DeviceResidentLoader`
uploads the decoded dataset once and gathers each batch on the device.
"""

from __future__ import annotations

import glob
import os.path as osp
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .png import read_png

__all__ = ["TrajDataset", "Loader", "DeviceResidentLoader", "get_loader", "maybe_device_resident"]


class TrajDataset:
    # datasets up to this many samples keep their decoded frames in memory
    # (2048 frames of 900x256 are about 1.4 GB of uint8)
    CACHE_MAX_SAMPLES = 2048

    def __init__(self, root_path: str, cache_decoded: Optional[bool] = None):
        self.root_path = root_path
        self.front_image = sorted(glob.glob(osp.join(root_path, "front", "*.png")))
        if not self.front_image:
            raise FileNotFoundError(f"No front images under {root_path}/front")
        if cache_decoded is None:
            cache_decoded = len(self.front_image) <= self.CACHE_MAX_SAMPLES
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = {} if cache_decoded else None
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.front_image)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            with self._cache_lock:
                hit = self._cache.get(idx)
            if hit is not None:
                return hit
        item = self._load(idx)
        if self._cache is not None:
            with self._cache_lock:
                self._cache[idx] = item
        return item

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        img = read_png(self.front_image[idx])
        waypoint_name = osp.join(self.root_path, "waypoints", f"{idx:06d}.txt")
        with open(waypoint_name, "r") as f:
            lines = [ln.strip() for ln in f.readlines()]
        target = np.asarray([float(v) for v in lines[0].split()], np.float32)
        rows = [[float(v) for v in ln.split()] for ln in lines[1:] if len(ln) != 0]
        trajs = np.clip(np.asarray(rows, np.float32), -1.0, 1.0)
        if len(trajs) != 16:
            raise ValueError(f"waypoint file {waypoint_name} has {len(trajs)} rows, expected 16")
        return {"image": img, "trajs": trajs, "target": target}


class Loader:
    """Shuffling, drop-last batch iterator with threaded prefetch: dicts of
    stacked numpy arrays {image (B, H, W, 3) uint8, trajs (B, 16, 7),
    target (B, 2)}. ``shard_index``/``shard_count``: every shard shuffles
    with the same (seed, epoch) and takes a disjoint stride of the
    permutation."""

    def __init__(self, dataset: TrajDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0, prefetch: int = 4,
                 shard_index: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        if self.shard_count > 1:
            idx = idx[self.shard_index::self.shard_count]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        self._epoch += 1
        n_batches = len(self)
        jobs: "queue.Queue" = queue.Queue()
        for bi in range(n_batches):
            jobs.put((bi, indices[bi * self.batch_size:(bi + 1) * self.batch_size]))
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        results, lock = {}, threading.Lock()

        def worker():
            while True:
                try:
                    bi, rows = jobs.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[int(i)] for i in rows]
                    batch = {k: np.stack([it[k] for it in items]) for k in ("image", "trajs", "target")}
                except Exception as e:  # handed to the consumer, which raises it
                    done.put(e)
                    return
                with lock:
                    results[bi] = batch
                done.put(bi)

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()
        ready, next_bi = set(), 0
        while next_bi < n_batches:
            bi = done.get()
            if isinstance(bi, Exception):
                raise bi
            ready.add(bi)
            while next_bi in ready:
                ready.discard(next_bi)
                with lock:
                    batch = results.pop(next_bi)
                next_bi += 1
                yield batch


class DeviceResidentLoader:
    """The whole decoded dataset on the device, uploaded once; each batch
    gathered there with ``index_select``. Epochs, shuffling and shards are
    the wrapped :class:`Loader`'s, so the batches are the same. Yields dicts
    of tensors on ``device`` (image uint8, trajs and target float32)."""

    def __init__(self, loader: Loader, device):
        self.loader = loader
        self.device = torch.device(device)
        ds = loader.dataset
        items = [ds[i] for i in range(len(ds))]
        self.tensors = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(self.device)
                        for k in ("image", "trajs", "target")}
        del items
        if ds._cache:
            ds._cache.clear()  # the frames now live on the device

    @property
    def dataset(self):
        return self.loader.dataset

    def __len__(self) -> int:
        return len(self.loader)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())

    def __iter__(self):
        indices = self.loader._epoch_indices()
        self.loader._epoch += 1
        bs = self.loader.batch_size
        for i in range(len(self)):
            idx = torch.from_numpy(indices[i * bs:(i + 1) * bs].astype(np.int64)).to(self.device)
            yield {k: t.index_select(0, idx) for k, t in self.tensors.items()}


def get_loader(cfg, train: bool = True, seed: int = 0, shard_index: int = 0,
               shard_count: int = 1) -> Loader:
    """The reference's get_loader (dataset/carla_dataset.py:45-58); the loader
    only decodes, augmentation runs on the device."""
    return Loader(TrajDataset(cfg.TRAIN.ROOT), batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=train,
                  drop_last=True, num_workers=cfg.TRAIN.NUM_WORKERS, seed=seed,
                  shard_index=shard_index, shard_count=shard_count)


def maybe_device_resident(loader: Loader, cfg, device):
    """``TPU.DEVICE_DATA``: ``off`` keeps the host loader; ``on``/``true``
    always uploads; ``auto`` uploads when the decoded dataset (the PNGs'
    own size, not TRAIN.IMAGE_*) fits ``TPU.DEVICE_DATA_MAX_BYTES``."""
    device_data = str(cfg.TPU.DEVICE_DATA).lower()
    if device_data == "off":
        return loader
    ds_bytes = len(loader.dataset) * loader.dataset[0]["image"].nbytes
    if device_data in ("on", "true") or (device_data == "auto" and ds_bytes <= int(cfg.TPU.DEVICE_DATA_MAX_BYTES)):
        return DeviceResidentLoader(loader, device)
    return loader
