"""Host data pipeline: batching, shuffling, prefetch (copy of
p2p_bridge_tpu/data/dataloader.py on dict configurations; tests hold the
two equal).

Replaces torch DataLoader + DistributedSampler (reference:
dataloaders/dataloader.py:14-157) with a numpy loader:

  * deterministic per-epoch shuffling (seeded Generator),
  * sharding by slicing the index space per process,
  * background-thread prefetch so host item assembly overlaps device
    compute,
  * infinite ``save_iter`` that bumps the epoch on wrap
    (dataloader.py:14-32).

Only the PUNet object dataset is ported; the room datasets raise
NotImplementedError.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np


def _stack_batch(items) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    out = {}
    for k in keys:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(
            vals[0], (int, float, np.floating, np.integer)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # strings etc.
    return out


class NumpyLoader:
    """Iterable over shuffled, stacked batches of a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(n)
        # contiguous shard slice per process (DistributedSampler analogue)
        return idx[self.shard_index :: self.num_shards]

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _produce(self, indices, q: queue.Queue):
        try:
            for s in range(0, len(indices), self.batch_size):
                chunk = indices[s : s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                q.put(_stack_batch([self.dataset[int(i)] for i in chunk]))
        finally:
            q.put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        t = threading.Thread(target=self._produce, args=(indices, q), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item


class PooledLoader:
    """Background-refreshed sample pool (infinite batch iterator).

    Per-item assembly (KD-tree queries) would otherwise compete with the
    training loop's launches for the interpreter lock and leave the device
    waiting. The pool decouples them:

      * batches are drawn by array indexing from a pre-stacked pool of
        ``pool_size`` items (≈0.1 ms on the training thread),
      * one daemon thread regenerates pool slots round-robin with
        whatever CPU the device step leaves idle,
      * items are produced from a *virtual* index stream
        ``epoch * len(dataset) + perm[i]`` so the per-item RNG
        (seeded ``(seed, idx)``) yields fresh noise/patch draws every
        epoch — matching the reference's global-RNG freshness
        (dataloaders/punet.py:385-422) instead of round 2's
        deterministic-per-idx recycling.

    Statistical effect: a shuffle buffer sampled with replacement whose
    refresh rate is CPU-bound; ``stats()`` reports produced/consumed so
    reuse is measurable. Exact epoch iteration (NumpyLoader) remains the
    path for validation and reference-comparison runs
    (``data.loader: epoch``).
    """

    def __init__(self, dataset, batch_size: int, pool_size: int = 2048,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pool_size = max(pool_size, 2 * batch_size)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng((seed, 0xB00))
        self._produced = 0
        self._consumed = 0
        self._pool: Optional[Dict[str, np.ndarray]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- virtual index stream (per-shard slice of each epoch's permutation)
    def _index_stream(self):
        n = len(self.dataset)
        epoch = 0
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(n)[self.shard_index :: self.num_shards]
            for i in perm:
                yield int(epoch * n + i)
            epoch += 1

    def _make_item(self, virtual_idx: int) -> Dict[str, np.ndarray]:
        item = self.dataset[virtual_idx]
        return {k: np.asarray(v) for k, v in item.items()
                if not isinstance(v, str)}

    def _fill_initial(self):
        stream = self._index_stream()
        self._stream = stream
        first = self._make_item(next(stream))
        pool = {
            k: np.empty((self.pool_size,) + v.shape, v.dtype)
            for k, v in first.items()
        }
        for k, v in first.items():
            pool[k][0] = v
        for slot in range(1, self.pool_size):
            item = self._make_item(next(stream))
            for k, v in item.items():
                pool[k][slot] = v
        self._pool = pool
        self._produced = self.pool_size

    def _refresh_loop(self):
        slot = 0
        while not self._stop.is_set():
            # soft throttle: >=4 fresh items per consumed item is already
            # full freshness; beyond that, producing just burns the CPU
            # the training thread (or an eval) could use
            with self._lock:
                ahead = self._produced - self.pool_size - 4 * self._consumed
            if ahead > 0:
                time.sleep(0.005)
                continue
            item = self._make_item(next(self._stream))
            with self._lock:
                for k, v in item.items():
                    self._pool[k][slot] = v
                self._produced += 1
            slot = (slot + 1) % self.pool_size
            # yield the interpreter lock so the training thread never waits
            time.sleep(0)

    def start(self):
        if self._pool is None:
            self._fill_initial()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._refresh_loop, daemon=True
            )
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def stats(self) -> Dict[str, int]:
        return {"produced": self._produced, "consumed": self._consumed}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self.start()
        while True:
            sel = self._rng.choice(self.pool_size, self.batch_size,
                                   replace=False)
            with self._lock:
                batch = {k: v[sel].copy() for k, v in self._pool.items()}
                self._consumed += self.batch_size
            yield batch


def save_iter(loader: NumpyLoader) -> Iterator:
    """Infinite iterator with epoch bump on wrap (dataloader.py:14-32)."""
    it = iter(loader)
    while True:
        try:
            yield next(it)
        except StopIteration:
            loader.set_epoch(loader.epoch + 1)
            it = iter(loader)
            yield next(it)


def get_dataloader(cfg: dict, num_shards: int = 1, shard_index: int = 0):
    """Dataset dispatch + loader construction
    (reference: dataloaders/dataloader.py:57-157).

    Returns (train_loader, val_loader)."""
    data = cfg["data"]
    name = data["dataset"]
    training = cfg.get("training")
    seed = training.get("seed", 42) if training is not None else 42
    if name != "PUNet":
        raise NotImplementedError(f"dataset {name} is not ported yet (see ROADMAP.md)")
    from .punet import get_dataset

    # data.fast_patches chooses patch-first (fast, same distribution,
    # another RNG stream) or the literal full-cloud port
    train_ds = get_dataset(
        data["data_dir"],
        split="train",
        dataset="PUNet",
        patch_size=data["npoints"],
        aug_rotate=data.get("augment", True),
        seed=seed,
        fast=bool(data.get("fast_patches", True)),
    )
    val_ds = get_dataset(
        data["data_dir"],
        split="test",
        dataset="PUNet",
        patch_size=data["npoints"],
        aug_rotate=False,
        resolutions=["10000_poisson"],
        seed=seed + 1,
    )

    bs = training["bs"] if training is not None else cfg["sampling"]["bs"]
    # data.loader: "pool" (background-refreshed sample pool) or "epoch"
    # (exact shuffled epochs, reference DataLoader semantics)
    loader_kind = data.get("loader", "pool")
    if loader_kind == "pool":
        train_loader = PooledLoader(
            train_ds, bs, pool_size=int(data.get("pool_size", 2048)),
            seed=seed, num_shards=num_shards, shard_index=shard_index,
        )
    elif loader_kind == "epoch":
        train_loader = NumpyLoader(
            train_ds, bs, shuffle=True, drop_last=True, seed=seed,
            num_shards=num_shards, shard_index=shard_index,
        )
    else:
        raise NotImplementedError(f"data.loader {loader_kind}")
    sampling = cfg.get("sampling")
    val_loader = NumpyLoader(
        val_ds, sampling.get("bs", bs) if sampling is not None else bs,
        shuffle=False, drop_last=False, seed=seed,
    )
    return train_loader, val_loader
