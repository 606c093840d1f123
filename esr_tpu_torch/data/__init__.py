"""Dataset and loader factories (port of the eval parts of
esr_tpu/data/__init__.py): ``create_dataset`` for the LRHR, LR and SYNTHETIC
modes, ``collate_samples``, a ``DataLoader`` that decodes in one background
thread, and ``create_dataloader``."""

from __future__ import annotations

import queue
import threading

import numpy as np

from esr_tpu_torch.data.lrhr_dataset import LRDataset, LRHRDataset, SyntheticDataset

__all__ = [
    "DataLoader",
    "LRDataset",
    "LRHRDataset",
    "SyntheticDataset",
    "collate_samples",
    "create_dataloader",
    "create_dataset",
]

_NOT_PORTED = ("dataset mode {} is not ported yet (ROADMAP.md Queue 1 item 6: the PACKED format "
               "comes with the training slice; LMDB has no backend in the JAX package either)")


def create_dataset(dataset_opt: dict):
    mode = (dataset_opt.get("mode") or "LRHR").upper()
    if mode in ("LRHR", "LRHR_LMDB"):
        root = str(dataset_opt.get("dataroot_HR") or "")
        if mode == "LRHR_LMDB" or root.endswith(".lmdb"):
            raise NotImplementedError(_NOT_PORTED.format("LMDB"))
        return LRHRDataset(dataset_opt)
    if mode == "LR":
        return LRDataset(dataset_opt)
    if mode == "SYNTHETIC":
        return SyntheticDataset(dataset_opt)
    if mode == "PACKED":
        raise NotImplementedError(_NOT_PORTED.format(mode))
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
    """Batches in dataset order (the last one may be short): one background
    thread decodes and collates up to ``prefetch`` batches ahead of the
    consumer."""

    def __init__(self, dataset, batch_size: int = 1, prefetch: int = 2, collate_keys=("LR", "HR")):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.collate_keys = collate_keys

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        bs = self.batch_size
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
            try:
                for b in range(len(self)):
                    chunk = range(b * bs, min((b + 1) * bs, len(self.dataset)))
                    batch = collate_samples([self.dataset[i] for i in chunk], self.collate_keys)
                    if not put(batch):
                        return
            except Exception as e:  # surface loader errors in the consumer's thread
                if not put(e):
                    return
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
    if (dataset_opt.get("phase") or "test") == "train":
        raise NotImplementedError(
            "the training loader is not ported yet (ROADMAP.md Queue 1 item 6)")
    return DataLoader(dataset, batch_size=1)
