"""Trajectory dataset and its loaders (counterpart of the JAX package's
``data/dataset.py``; reference: dataset/carla_dataset.py:11-58).

* ``{root}/front/*.png``, sorted: the front-camera frames (900x256 RGB);
* ``{root}/waypoints/{idx:06d}.txt``: line 0 the 2-d target point, then 16
  lines of 7-d transitions, clipped to [-1, 1].

:class:`Loader` decodes PNGs (``data/png.py``, no OpenCV) and parses text in
worker processes, as the reference's ``DataLoader`` does (the decode is
numpy code that holds the interpreter lock, so threads would not overlap);
augmentation and normalization run on the device (``data/augment.py``). It
shuffles with ``np.random.default_rng(seed + epoch)``, takes its shard's
stride of the permutation and drops the last partial batch, so it yields
the same batches in the same order as the JAX package's.
:class:`DeviceResidentLoader` uploads the decoded dataset once and gathers
each batch on the device.
"""

from __future__ import annotations

import glob
import multiprocessing
import os
import os.path as osp
import pickle
import queue
import threading
import time
import traceback
import weakref
from multiprocessing import shared_memory
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .png import png_shape, read_png, read_pngs

__all__ = ["TrajDataset", "Loader", "DeviceResidentLoader", "get_loader", "maybe_device_resident"]


class TrajDataset:
    # datasets up to this many samples keep the frames ``dataset[i]``
    # decodes in memory (2048 frames of 900x256 are about 1.4 GB of uint8);
    # the Loader's decoder processes decode every epoch, as DataLoader's do
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
        return load_item(self.root_path, self.front_image[idx], idx)


def load_item(root_path: str, front_path: str, idx: int) -> Dict[str, np.ndarray]:
    """Sample ``idx``: its frame ``front_path`` decoded, its waypoint file read."""
    return {"image": read_png(front_path), **load_waypoints(root_path, idx)}


def load_waypoints(root_path: str, idx: int) -> Dict[str, np.ndarray]:
    """Sample ``idx``'s trajs (16, 7), clipped to [-1, 1], and target (2,)."""
    waypoint_name = osp.join(root_path, "waypoints", f"{idx:06d}.txt")
    with open(waypoint_name, "r") as f:
        lines = [ln.strip() for ln in f.readlines()]
    target = np.asarray([float(v) for v in lines[0].split()], np.float32)
    rows = [[float(v) for v in ln.split()] for ln in lines[1:] if len(ln) != 0]
    trajs = np.clip(np.asarray(rows, np.float32), -1.0, 1.0)
    if len(trajs) != 16:
        raise ValueError(f"waypoint file {waypoint_name} has {len(trajs)} rows, expected 16")
    return {"trajs": trajs, "target": target}


def _decode_worker(root_path: str, front_image: List[str], slot_names: List[str], slot_shape, jobs, results):
    """A decoder process: each job ``(run, batch, slot, rows)`` decodes its
    rows' frames together (``read_pngs``) into shared-memory slot ``slot``
    and sends back ``(run, batch, slot, trajs, target)``, or the exception
    it raised in place of ``trajs``; ``None`` ends it."""
    shms = [shared_memory.SharedMemory(name=n) for n in slot_names]
    slots = [np.ndarray(slot_shape, np.uint8, buffer=m.buf) for m in shms]
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            run, bi, slot, rows = job
            try:
                frames = read_pngs([front_image[i] for i in rows])
                if frames.shape[1:] != slot_shape[1:]:
                    raise ValueError(f"{front_image[rows[0]]}: frames of shape {frames.shape[1:]} in a dataset "
                                     f"whose first frame is {slot_shape[1:]}")
                slots[slot][:len(rows)] = frames
                items = [load_waypoints(root_path, i) for i in rows]
                results.put((run, bi, slot, np.stack([it["trajs"] for it in items]),
                             np.stack([it["target"] for it in items])))
            except Exception as e:  # handed to the consumer, which raises it
                e.add_note(f"in decode worker process {os.getpid()}:\n{traceback.format_exc()}")
                try:
                    pickle.dumps(e)
                except Exception:
                    e = RuntimeError(f"{type(e).__name__}: {e}\n{e.__notes__[-1]}")
                results.put((run, bi, slot, e, None))
    finally:
        del slots
        for m in shms:
            m.close()


def _shutdown(pool: "_Pool") -> None:
    """Stop the decoder processes and free their shared memory."""
    for p in pool.procs:
        if p.is_alive():
            pool.jobs.put(None)
    deadline = time.monotonic() + 5
    while any(p.is_alive() for p in pool.procs) and time.monotonic() < deadline:
        try:  # results no one reads, drained so that their writers can exit
            pool.results.get(timeout=0.1)
        except queue.Empty:
            pass
    for p in pool.procs:
        if p.is_alive():
            p.terminate()
        p.join()
    pool.jobs.cancel_join_thread()
    pool.slots = []  # the views, before their buffers close
    for m in pool.shms:
        m.close()
        m.unlink()


class _Pool:
    """The decoder processes, their queues and the shared-memory slots they
    decode batches into; ``free`` are the slots no job holds, ``run`` the
    number of the latest epoch's iteration."""

    def __init__(self, dataset, batch_size: int, num_workers: int, slots: int):
        shape = (batch_size, *png_shape(dataset.front_image[0]))
        ctx = multiprocessing.get_context("spawn")  # never fork a process that may hold CUDA
        self.shms = [shared_memory.SharedMemory(create=True, size=int(np.prod(shape))) for _ in range(slots)]
        self.slots = [np.ndarray(shape, np.uint8, buffer=m.buf) for m in self.shms]
        self.jobs, self.results = ctx.Queue(), ctx.Queue()
        self.procs = [ctx.Process(target=_decode_worker, daemon=True,
                                  args=(dataset.root_path, list(dataset.front_image), [m.name for m in self.shms],
                                        shape, self.jobs, self.results))
                      for _ in range(num_workers)]
        for p in self.procs:
            p.start()
        self.free = list(range(slots))
        self.run = 0

    def check(self) -> None:
        """Raise if a decoder process has died."""
        for p in self.procs:
            if not p.is_alive():
                raise RuntimeError(f"a decode worker process (pid {p.pid}) exited with code {p.exitcode}")

    def result(self):
        while True:
            try:
                return self.results.get(timeout=0.5)
            except queue.Empty:
                self.check()


class Loader:
    """Shuffling, drop-last batch iterator: dicts of stacked arrays {image
    (B, H, W, 3) uint8, trajs (B, 16, 7), target (B, 2)}, numpy arrays, or
    with ``pin_memory`` torch tensors in page-locked memory (so that
    ``.to(card, non_blocking=True)`` does not wait). ``num_workers`` decoder
    processes (``spawn``), started at the first epoch and kept until
    :meth:`close`, decode ``prefetch`` batches ahead into shared memory; a
    worker's exception is raised by the consumer, and a worker that dies
    makes the consumer raise. ``shard_index``/``shard_count``: every shard
    shuffles with the same (seed, epoch) and takes a disjoint stride of the
    permutation."""

    def __init__(self, dataset: TrajDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0, prefetch: int = 4,
                 shard_index: int = 0, shard_count: int = 1, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self.pin_memory = pin_memory
        self._epoch = 0
        self._pool: Optional[_Pool] = None

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

    def close(self) -> None:
        """Stop the decoder processes."""
        if self._pool is not None:
            self._finalizer()
            self._pool = None

    def _batch(self, pool: _Pool, slot: int, trajs: np.ndarray, target: np.ndarray) -> dict:
        """The batch in ``slot`` (as many rows as ``trajs``), copied out of it."""
        image = pool.slots[slot][:len(trajs)]
        if not self.pin_memory:
            return {"image": image.copy(), "trajs": trajs, "target": target}
        out = {"image": torch.empty(image.shape, dtype=torch.uint8, pin_memory=True)}
        out["image"].copy_(torch.from_numpy(image))
        return out | {k: torch.from_numpy(v).pin_memory() for k, v in (("trajs", trajs), ("target", target))}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        self._epoch += 1
        n_batches, bs = len(self), self.batch_size
        if self._pool is None:
            self._pool = pool = _Pool(self.dataset, bs, self.num_workers, self.prefetch)
            self._finalizer = weakref.finalize(self, _shutdown, pool)
        pool = self._pool
        pool.run += 1
        run, next_job, next_bi, done = pool.run, 0, 0, {}
        try:
            while next_bi < n_batches:
                while next_job < n_batches and pool.free:
                    rows = indices[next_job * bs:(next_job + 1) * bs]
                    pool.jobs.put((run, next_job, pool.free.pop(), [int(i) for i in rows]))
                    next_job += 1
                if next_bi in done:
                    slot, trajs, target = done.pop(next_bi)
                    batch = self._batch(pool, slot, trajs, target)
                    pool.free.append(slot)
                    next_bi += 1
                    pool.check()
                    yield batch
                    continue
                r, bi, slot, trajs, target = pool.result()
                if r != run:  # a job of an iteration that was left
                    pool.free.append(slot)
                elif isinstance(trajs, BaseException):
                    pool.free.append(slot)
                    raise trajs
                else:
                    done[bi] = (slot, trajs, target)
        finally:
            pool.free.extend(slot for slot, _, _ in done.values())


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
               shard_count: int = 1, pin_memory: bool = False) -> Loader:
    """The reference's get_loader (dataset/carla_dataset.py:45-58); the loader
    only decodes, augmentation runs on the device."""
    return Loader(TrajDataset(cfg.TRAIN.ROOT), batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=train,
                  drop_last=True, num_workers=cfg.TRAIN.NUM_WORKERS, seed=seed,
                  shard_index=shard_index, shard_count=shard_count, pin_memory=pin_memory)


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
