"""Prefetching batcher with on-device target completion.

Port of ``npp_tpu/data/loader.py:25-240``: an optional shuffle per epoch,
each process's strided shard of it (DistributedSampler semantics), a
thread pool that assembles fixed-shape numpy batches, a producer thread
that keeps ``prefetch`` of them ready, pinned host memory (on a CUDA
device) and ``non_blocking=True`` copies, and the renderer, which
completes the targets on the device. A process feeds only its own
device: npp_tpu's assembly of a global array from the processes' shards
has no job here (DDP and the criterion's collectives join the shards).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from npp_tpu_torch.data import targets as tgt
from npp_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.parallel.spatial import shard_batch_spatial


def collate(samples: list[dict]) -> dict:
    """Stack sample dicts into fixed-shape numpy arrays (+ name list)."""
    batch = {}
    for key in ("image", "par", "joints", "visibility", "scale",
                "crop_param"):
        batch[key] = np.stack([s[key] for s in samples])
    batch["names"] = [s["name"] for s in samples]
    return batch


def make_target_renderer(*, stride: int = 4, sigma: float = 3,
                         num_joints: int = 16, edge_width: int = 3,
                         ignore: int = 255, normalize_images: bool = False):
    """On-device target completion: joints -> heatmaps (+aux), parsing
    labels -> edge map, and with ``normalize_images=True`` uint8 NHWC
    images -> ImageNet-normalised float images.

    The returned ``render(image, par, joints, visibility)`` gives ``pose``
    and ``pose_aux`` (B, num_joints, H/stride, W/stride) without the
    background channel, ``edge`` (B, H, W) int64 (``ignore`` where the
    label is ignored), ``pose_weight`` and, when normalising, ``image``
    as NCHW float32 in ``channels_last`` memory format."""
    def render(image, par, joints, visibility):
        h, w = image.shape[1], image.shape[2]
        pose, pose_aux = tgt.gen_pose_target_device(
            joints, visibility, stride=stride, grid_x=w // stride,
            grid_y=h // stride, sigma=sigma)
        edge = tgt.generate_edge_device(par, edge_width=edge_width,
                                        ignore=ignore)
        edge = torch.where(par == ignore, ignore, edge.long())
        out = {"pose": pose[:, :num_joints],
               "pose_aux": pose_aux[:, :num_joints],
               "edge": edge, "pose_weight": visibility}
        if normalize_images:
            mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
            std = torch.as_tensor(IMAGENET_STD, device=image.device)
            img = (image.to(torch.float32) / 255.0 - mean) / std
            out["image"] = img.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        elif image.dtype == torch.uint8:
            raise ValueError(
                "loader received uint8 images but the renderer was built "
                "with normalize_images=False")
        return out

    return render


class DataLoader:
    """Iterates device-ready batches: per epoch an optional shuffle
    (``np.random.default_rng(seed + epoch)``, reseeded by ``set_epoch``,
    as the JAX loader's), thread-pool sample loading, a ``prefetch``-deep
    queue, pinned host memory and non-blocking copies to ``device``, then
    on-device target rendering. ``drop_last`` drops a short last batch.
    The defaults are the eval loader's (dataset order, every sample); the
    train loader passes ``shuffle=True, drop_last=True``, the JAX loader's
    defaults. Batches keep their dataset ``index`` (host side) beside the
    device tensors.

    ``batch_size`` is the per-process batch. With ``process_count`` > 1
    (by default the process group's rank and world size) each process
    takes a strided slice of the epoch's order, padded by wrapping to the
    same count on every process, as torch's DistributedSampler does. On a
    ``grid`` (``parallel/mesh.make_grid``) the shard is data index
    ``grid.d`` of ``grid.n_data`` and, after the renderer, each image,
    label, edge and heatmap keeps this rank's rows
    (``spatial.shard_batch_spatial``).

    npp_tpu's batch caches (``loader.py:97-131, 189-240``), valid only
    with ``shuffle=False`` (asserted): ``cache_batches`` keeps the first
    whole epoch's collated host batches and replays them in later epochs
    (the upload and the rendering still run each epoch);
    ``cache_on_device`` keeps the first whole epoch's device batches,
    targets rendered, and yields them again (no upload, no rendering).
    ``eval_lip --scanned`` reads the second. An epoch cut short fills
    neither."""

    prefetch = 2  # host batches kept ready ahead of the consumer

    def __init__(self, dataset, batch_size: int, *, device,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_workers: int = 8, renderer=None,
                 process_index: int | None = None,
                 process_count: int | None = None, grid=None,
                 cache_batches: bool = False,
                 cache_on_device: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = max(1, num_workers)
        self.renderer = renderer
        self.grid = grid
        if grid is not None:
            process_index, process_count = grid.d, grid.n_data
        self.process_index = (mesh.rank() if process_index is None
                              else process_index)
        self.process_count = (mesh.world_size() if process_count is None
                              else process_count)
        self.cache_batches = cache_batches
        self.cache_on_device = cache_on_device
        self._batch_cache: list | None = None
        self._device_cache: list | None = None
        assert not ((cache_batches or cache_on_device) and shuffle), \
            "batch caching requires shuffle=False (deterministic batches)"

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _local_count(self) -> int:
        """Samples per process (padded to be equal on every process)."""
        return -(-len(self.dataset) // self.process_count)

    def __len__(self):
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        """This process's batches of the epoch's sample order
        (``npp_tpu/data/loader.py:148-164``)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.process_count > 1:
            pad = self._local_count() * self.process_count - len(idx)
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.process_index::self.process_count]
        if self.drop_last:
            idx = idx[:len(idx) // self.batch_size * self.batch_size]
        return [idx[i:i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)]

    def _to_device(self, batch: dict) -> dict:
        names = batch.pop("names")
        index = batch.pop("index")
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=pin)
        if self.renderer is not None:
            out.update(self.renderer(out["image"], out["par"],
                                     out["joints"], out["visibility"]))
        if self.grid is not None:
            out = shard_batch_spatial(out, self.grid, data_sharded=True)
        out["names"] = names
        out["index"] = index
        return out

    def __iter__(self) -> Iterator[dict]:
        if self.cache_on_device and self._device_cache is not None:
            for dev_batch in self._device_cache:
                yield dict(dev_batch)
            return
        if self.cache_batches and self._batch_cache is not None:
            for host_batch in self._batch_cache:
                yield self._to_device(dict(host_batch))
            return
        cache: list = []
        dev_cache: list = []
        batches = self._indices()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for group in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__, group))
                    c = collate(samples)
                    c["index"] = np.asarray(group, np.int64)
                    q.put(c)
                q.put(None)
            except BaseException as exc:  # handed to the consumer
                q.put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                if self.cache_batches:
                    cache.append(dict(item))
                dev = self._to_device(item)
                if self.cache_on_device:
                    dev_cache.append(dict(dev))
                yield dev
            if self.cache_batches:
                self._batch_cache = cache
            if self.cache_on_device:
                self._device_cache = dev_cache
        finally:
            stop.set()
            while producer.is_alive():  # unblock a producer stuck on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                producer.join(timeout=0.05)
            pool.shutdown(wait=True)
