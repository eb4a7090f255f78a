"""Batch loader: seeded shuffling, per-host sharding, threaded prefetch.

Replaces the reference's torch DataLoader + DistributedGroupSampler +
collate_kitti stack (SURVEY §2 P13-P15). Because every example is already a
fixed-capacity dict of numpy arrays, collation is a plain ``np.stack`` — the
reference's ragged concat/pad logic (collate.py:154-230) disappears.

Sharding follows the JAX multi-host model: each host iterates only its
``process_index``-th slice of the epoch permutation; the device mesh sees
[local_batch, ...] arrays (SURVEY §2.3 TPU-native equivalents).
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Iterator, Optional

import numpy as np


_WORKER_DATASET = None


def _process_worker_init(payload: bytes):
    """Runs once in each spawned loader worker: materialize the dataset."""
    global _WORKER_DATASET
    import pickle

    _WORKER_DATASET = pickle.loads(payload)


def _process_worker_load(idx: int, rng_seed: int):
    rng = np.random.RandomState(rng_seed)
    return _WORKER_DATASET.get_sensor_data(int(idx), rng=rng)


def _stack_examples(examples) -> dict:
    out = {}
    for k, v in examples[0].items():
        if k in ("metadata", "calib"):
            out[k] = [e[k] for e in examples]
        elif isinstance(v, dict):
            out[k] = _stack_examples([e[k] for e in examples])
        else:
            out[k] = np.stack([np.asarray(e[k]) for e in examples])
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        group_flags: Optional[np.ndarray] = None,
        batch_transform=None,
        worker_type: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        # optional whole-batch post-processing run in the prefetch path
        # (e.g. data.rulebooks.make_train_rulebook_transform: host C++
        # sparse-conv rulebooks, so the device step does no construction)
        self.batch_transform = batch_transform
        # "thread": GIL-shared workers — fine when the per-sample work is
        # numpy/BLAS/native (releases the GIL), the 1-core fallback, and the
        # only choice for unpicklable datasets. "process": spawned workers
        # each holding a dataset replica — the reference's DataLoader model
        # (build_loader.py:23-57); ~145 ms/sample of the augmentation is
        # small-op pure python that threads cannot parallelize.
        self.worker_type = worker_type
        self._pool = None       # persistent across epochs (spawn is slow)
        self._assemble_pool = None
        self.epoch = 0
        # group-aware batching (GroupSampler / DistributedGroupSampler,
        # det3d/datasets/loader/sampler.py:98-222): every batch is composed
        # of samples from one group (KITTI: image aspect-ratio flag); flags
        # default to the dataset's group_flags attribute when present
        if group_flags is None:
            group_flags = getattr(dataset, "group_flags", None)
        self.group_flags = (np.asarray(group_flags)
                            if group_flags is not None else None)

    def set_epoch(self, epoch: int):
        """Epoch-seeded reshuffle (the DistSamplerSeedHook equivalent)."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.group_flags is not None and self.shuffle:
            # per-group shuffle; each group padded (wrapping) to a multiple
            # of batch_size so batches never mix groups; batch order is then
            # globally permuted — exact GroupSampler epoch semantics with a
            # deterministic epoch seed
            bs = self.batch_size
            chunks = []
            for g in np.unique(self.group_flags):
                gi = np.flatnonzero(self.group_flags == g)
                gi = gi[rng.permutation(len(gi))]
                extra = -len(gi) % bs
                if extra:
                    gi = np.concatenate([gi, gi[:extra]])
                chunks.extend(gi[i * bs:(i + 1) * bs]
                              for i in range(len(gi) // bs))
            order = rng.permutation(len(chunks))
            idx = np.concatenate([chunks[i] for i in order])
        elif self.shuffle:
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.num_shards > 1:
            if self.group_flags is not None and self.shuffle:
                # shard whole batches (round-robin, padded by wrapping) so
                # every shard keeps group-pure batches
                bs = self.batch_size
                nb = len(idx) // bs
                bi = np.arange(nb)
                extra = -nb % self.num_shards
                if extra:
                    bi = np.concatenate([bi, bi[:extra]])
                bi = bi[self.shard_index::self.num_shards]
                idx = np.concatenate(
                    [idx[b * bs:(b + 1) * bs] for b in bi])
            else:
                # pad so every shard sees the same number of samples
                per_shard = -(-len(idx) // self.num_shards)
                pad = per_shard * self.num_shards - len(idx)
                if pad:
                    idx = np.concatenate([idx, idx[:pad]])
                idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _sample_seed(self, idx: int) -> int:
        # deterministic per-(epoch, sample) rng — identical for thread and
        # process workers, so the two paths produce identical batches
        return (self.seed * 1_000_003 + self.epoch * 131_071 + int(idx)) % (2 ** 31)

    def _ensure_process_pool(self):
        if self._pool is not None:
            return True
        import multiprocessing
        import pickle

        try:
            payload = pickle.dumps(self.dataset)
        except Exception:  # unpicklable dataset: stay on threads
            self.worker_type = "thread"
            return False
        # spawn (never fork): forked children deadlock against JAX/XLA
        # runtime threads
        ctx = multiprocessing.get_context("spawn")
        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=self.num_workers, mp_context=ctx,
            initializer=_process_worker_init, initargs=(payload,))
        # assembly (np.stack + batch_transform, e.g. host C++ rulebooks)
        # overlaps the device step in threads of the parent; the native
        # calls release the GIL
        self._assemble_pool = concurrent.futures.ThreadPoolExecutor(2)
        return True

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._assemble_pool is not None:
            self._assemble_pool.shutdown(wait=False, cancel_futures=True)
            self._assemble_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[dict]:
        if self.worker_type == "process" and self._ensure_process_pool():
            yield from self._iter_process()
            return
        yield from self._iter_thread()

    def _iter_thread(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        nb = len(self)
        batches = [indices[i * self.batch_size : (i + 1) * self.batch_size]
                   for i in range(nb)]

        def load_one(args):
            pos, idx = args
            rng = np.random.RandomState(self._sample_seed(idx))
            return self.dataset.get_sensor_data(int(idx), rng=rng)

        def assemble(futs):
            batch = _stack_examples([f.result() for f in futs])
            if self.batch_transform is not None:
                batch = self.batch_transform(batch)
            return batch

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return False
                futs = [ex.submit(load_one, (i, idx)) for i, idx in enumerate(b)]
                # assembly (stack + batch_transform) also runs in the pool so
                # it overlaps the device step; FIFO scheduling guarantees its
                # dependencies are never queued behind it
                pending.append(ex.submit(assemble, futs))
                return True

            for _ in range(self.prefetch + 1):
                if not submit_next():
                    break
            while pending:
                fut = pending.pop(0)
                submit_next()
                yield fut.result()

    def _iter_process(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        nb = len(self)
        batches = [indices[i * self.batch_size : (i + 1) * self.batch_size]
                   for i in range(nb)]

        def assemble(futs):
            batch = _stack_examples([f.result() for f in futs])
            if self.batch_transform is not None:
                batch = self.batch_transform(batch)
            return batch

        pending = []
        it = iter(batches)

        def submit_next():
            try:
                b = next(it)
            except StopIteration:
                return False
            futs = [self._pool.submit(_process_worker_load, int(idx),
                                      self._sample_seed(idx)) for idx in b]
            pending.append(self._assemble_pool.submit(assemble, futs))
            return True

        for _ in range(self.prefetch + 1):
            if not submit_next():
                break
        while pending:
            fut = pending.pop(0)
            submit_next()
            yield fut.result()
