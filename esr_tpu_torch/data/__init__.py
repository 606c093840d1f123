"""Dataset and loader factories (port of esr_tpu/data/__init__.py):
``create_dataset`` for the LRHR, LR, SYNTHETIC and PACKED modes,
``collate_samples``, a ``DataLoader`` that decodes in one background thread
(shuffled by seed + epoch and resumable mid-epoch for training),
``create_dataloader``, and ``create_worker_loader``, whose loader decodes
each batch's samples over ``n_workers`` threads."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from esr_tpu_torch.data.lrhr_dataset import LRDataset, LRHRDataset, SyntheticDataset
from esr_tpu_torch.data.packed import PackedDataset
from esr_tpu_torch.data.pipeline import draw_z, make_train_pipeline

__all__ = [
    "DataLoader",
    "LRDataset",
    "LRHRDataset",
    "PackedDataset",
    "SyntheticDataset",
    "collate_samples",
    "create_dataloader",
    "create_dataset",
    "create_worker_loader",
    "draw_z",
    "make_train_pipeline",
]


def create_dataset(dataset_opt: dict):
    mode = (dataset_opt.get("mode") or "LRHR").upper()
    if mode in ("LRHR", "LRHR_LMDB"):
        root = str(dataset_opt.get("dataroot_HR") or "")
        if mode == "LRHR_LMDB" or root.endswith(".lmdb"):
            raise NotImplementedError(
                "LMDB has no backend (the JAX package has none either); use mode='PACKED' "
                "(esr_tpu_torch.data.packed.write_packed) for the same fast random access")
        return LRHRDataset(dataset_opt)
    if mode == "LR":
        return LRDataset(dataset_opt)
    if mode == "SYNTHETIC":
        return SyntheticDataset(dataset_opt)
    if mode == "PACKED":
        return PackedDataset(dataset_opt)
    raise NotImplementedError(f"dataset mode {mode} not recognized")


def collate_samples(samples, collate_keys=("LR", "HR")) -> dict:
    """Stack per-sample dicts into a batch dict: array keys in
    ``collate_keys`` are np.stack'ed (None if any sample lacks them),
    everything else (paths, metadata) becomes a list."""
    batch = {}
    for key in collate_keys:
        vals = [s.get(key) for s in samples]
        batch[key] = None if any(v is None for v in vals) else np.stack(vals)
    for key in samples[0]:
        if key not in collate_keys:
            batch[key] = [s[key] for s in samples]
    return batch


class DataLoader:
    """Epoch batches, decoded and collated by one background thread up to
    ``prefetch`` batches ahead of the consumer.

    ``shuffle`` orders each epoch by ``np.random.default_rng(seed + epoch)``;
    ``drop_last`` drops a short last batch. Each ``__iter__`` is one epoch:
    it tells the dataset its epoch (``set_epoch``, for the crop draws) and
    starts where ``set_position`` put it. ``set_shard(i, n)`` (data
    parallelism) makes it load only rows i*B/n .. (i+1)*B/n - 1 of each
    batch of ``batch_size`` B: with the datasets' (seed, epoch, index) crops,
    the rows that one process loading the whole batch would hold there.
    ``n_workers`` > 0 decodes each batch's samples over that many threads
    (the background thread collates them in order); 0 decodes them on the
    background thread itself."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0, collate_keys=("LR", "HR"), n_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.collate_keys = collate_keys
        self.n_workers = n_workers
        self._epoch = 0
        self._skip = 0
        self._shard = (0, 1)

    def set_shard(self, index: int, n_shards: int) -> None:
        if self.batch_size % n_shards:
            raise ValueError(f"batch_size {self.batch_size} does not divide over {n_shards} data-parallel ranks "
                             "— use a divisible batch size")
        self._shard = (int(index), int(n_shards))

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def set_position(self, epoch: int, batches_consumed: int = 0) -> None:
        """Resume the data stream: the next ``__iter__`` is epoch ``epoch``'s
        order, ``batches_consumed`` batches in. With the datasets' (seed,
        epoch, index) crop draws a resumed run sees the batches the original
        run would have."""
        self._epoch = int(epoch)
        self._skip = max(0, int(batches_consumed))

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        idx = self._indices()
        self._epoch += 1
        first, self._skip = min(self._skip, len(self)), 0
        bs = self.batch_size
        i, n_shards = self._shard
        rows = slice(i * bs // n_shards, (i + 1) * bs // n_shards)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()  # set when the consumer abandons the iterator

        def put(item) -> bool:  # False: the consumer is gone, the worker exits
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            pool = ThreadPoolExecutor(self.n_workers, thread_name_prefix="loader") if self.n_workers else None
            decode = pool.map if pool else map
            try:
                for b in range(first, len(self)):
                    ids = [int(k) for k in idx[b * bs : (b + 1) * bs][rows]]
                    batch = collate_samples(list(decode(self.dataset.__getitem__, ids)), self.collate_keys)
                    if not put(batch):
                        return
            except Exception as e:  # surface loader errors in the consumer's thread
                if not put(e):
                    return
            finally:
                if pool:
                    pool.shutdown(wait=True, cancel_futures=True)
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # an abandoned iterator must not leave the worker blocked on a
            # full queue
            stop.set()


def create_dataloader(dataset, dataset_opt: dict):
    """Train phase: ``batch_size`` (16), shuffled unless ``use_shuffle`` is
    false, by ``seed``, last batch dropped. Otherwise: batches of one, in
    order."""
    if (dataset_opt.get("phase") or "test") == "train":
        return DataLoader(dataset, batch_size=int(dataset_opt.get("batch_size") or 16),
                          shuffle=bool(dataset_opt.get("use_shuffle", True)), drop_last=True,
                          seed=int(dataset_opt.get("seed") or 0))
    return DataLoader(dataset, batch_size=1)


def create_worker_loader(dataset, dataset_opt: dict, collate_keys=("LR", "HR")) -> DataLoader:
    """The port of the JAX package's ``create_grain_loader``: the train
    loader of :func:`create_dataloader` (``batch_size`` 16, shuffled unless
    ``use_shuffle`` is false, by ``seed``, last batch dropped, one epoch per
    iteration) whose batches ``n_workers`` threads decode. The train CLI
    does not use it, as the JAX package's does not use grain's."""
    return DataLoader(dataset, batch_size=int(dataset_opt.get("batch_size") or 16),
                      shuffle=bool(dataset_opt.get("use_shuffle", True)), drop_last=True,
                      seed=int(dataset_opt.get("seed") or 0), collate_keys=collate_keys,
                      n_workers=int(dataset_opt.get("n_workers") or 0))
