"""Loader-side (host C++) rulebook construction for TRAINING batches.

The sparse backbone's rulebook chain (permutation, per-stage voxel ids,
subm/down gather maps) is a pure function of the batch's voxel coords —
the reference leaves this work to spconv's on-GPU hash tables per forward
(det3d/models/backbones/scn.py:92-189 via spconv), where sorts and
hash-table lookups run serially inside every forward. Building it in the
data path with native/rulebook.cpp removes every
device-side sort/LUT lookup from the jitted train step; the arrays ride
into the batch dict and shard over the data mesh axis like any other leaf.

Sharding layout: every rulebook leaf is stacked with a leading
``num_shards`` axis. `shard_map` splits that axis over the mesh, so each
device sees a [1, ...] view of the chain built for ITS local sub-batch
(grid (local_b, D, H, W), capacities scaled by local_b);
train_step squeezes the unit axis before handing it to the model.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

# strided-transition geometry of SpMiddleFHD (models/backbone.py stage plan)
DOWNS = [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
]


def _tree_stack(dicts):
    """Stack a list of rulebook dicts leaf-wise along a new leading axis."""
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, (list, tuple)):
            out[k] = [np.stack([d[k][i] for d in dicts]) for i in range(len(v))]
        else:
            out[k] = np.stack([d[k] for d in dicts])
    return out


def build_batch_rulebooks(coords, mask, sparse_shape, stage_capacity,
                          native=None, out_dtype=None, downs=None,
                          scratch=None):
    """One chain over the batched (B, D, H, W) grid from stacked loader
    arrays: coords [B, V, 3] zyx + mask [B, V]. Returns None without the
    native library. out_dtype default: int16 when the batched capacities
    fit, else int32 (the backbone upcasts in-graph either way)."""
    if native is None:
        from ..utils.native import get_native

        native = get_native()
        if native is None:
            return None
    coords = np.asarray(coords)
    mask = np.asarray(mask)
    b, v, _ = coords.shape
    caps = [int(c) * b for c in stage_capacity]
    if out_dtype is None:
        out_dtype = np.int16 if max(caps) < 2 ** 15 else np.int32
    bidx = np.repeat(np.arange(b, dtype=np.int32), v)[:, None]
    bzyx = np.concatenate([bidx, coords.reshape(-1, 3).astype(np.int32)],
                          axis=1)
    return native.build_rulebooks(bzyx, mask.reshape(-1),
                                  (b,) + tuple(sparse_shape), caps,
                                  list(downs if downs is not None else DOWNS),
                                  out_dtype=out_dtype, scratch=scratch)


def make_train_rulebook_transform(
    sparse_shape: Tuple[int, int, int],
    stage_capacity: Sequence[int],
    num_shards: int = 1,
    downs=tuple(DOWNS),
    suffixes: Sequence[str] = ("", "_raw"),
) -> Optional[Callable[[dict], dict]]:
    """Returns a batch->batch transform adding ``rulebooks``/``rulebooks_raw``
    (one chain per student/teacher input set), or None when the native
    library is unavailable (the device falls back to in-graph construction).
    """
    from ..utils.native import get_native

    native = get_native()
    if native is None:
        return None
    caps = [int(c) for c in stage_capacity]
    # scratch free-list: build_batch_rulebooks returns VIEWS into its
    # scratch set (alive until _tree_stack copies them), and the loader's
    # prefetch pool can run this transform for SEVERAL in-flight batches
    # CONCURRENTLY — so scratch sets are acquired per build and released
    # only after the copy, behind a lock (a fixed per-shard ring raced:
    # one thread's C++ wrote a set while another still read it, corrupting
    # perm/maps). Reuse avoids the THP-stalling fresh mmaps
    # (see utils/native.rulebook_scratch).
    import threading

    pools: dict = {}
    pools_lock = threading.Lock()

    def _acquire(caps_b, out_dtype):
        key = (tuple(caps_b), np.dtype(out_dtype))
        with pools_lock:
            free = pools.setdefault(key, [])
            if free:
                return key, free.pop()
        return key, native.rulebook_scratch(caps_b, downs, out_dtype)

    def _release(key, scratch):
        with pools_lock:
            pools[key].append(scratch)

    def transform(batch: dict) -> dict:
        out = dict(batch)
        for suffix in suffixes:
            coords = np.asarray(batch["coords" + suffix])      # [B, V, 3] zyx
            mask = np.asarray(batch["voxel_mask" + suffix])    # [B, V]
            b, v, _ = coords.shape
            assert b % num_shards == 0, (b, num_shards)
            lb = b // num_shards
            caps_b = [c * lb for c in caps]
            out_dtype = np.int16 if max(caps_b) < 2 ** 15 else np.int32
            taken = []
            try:
                shards = []
                for s in range(num_shards):
                    key, scr = _acquire(caps_b, out_dtype)
                    taken.append((key, scr))
                    shards.append(build_batch_rulebooks(
                        coords[s * lb:(s + 1) * lb],
                        mask[s * lb:(s + 1) * lb],
                        sparse_shape, caps, native=native, downs=downs,
                        out_dtype=out_dtype, scratch=scr))
                out["rulebooks" + suffix] = _tree_stack(shards)
            finally:
                for key, scr in taken:
                    _release(key, scr)
        return out

    return transform


def make_chain_inputs_transform(
    sparse_shape: Tuple[int, int, int],
    stage_capacity: Sequence[int],
    suffixes: Sequence[str] = ("",),
) -> Callable[[dict], dict]:
    """VoxelNet's host inputs as a batch transform: per suffix, the batch's
    rulebook chain (one shard, no shard axis) under ``inputs<sfx>``, and
    the stages whose id table is full under ``saturated<sfx>`` as (stage,
    rows, rows cap). A full table means truncated voxels, or an exactly
    filled stage: the chain reports no overflow count."""
    chains = make_train_rulebook_transform(sparse_shape, stage_capacity,
                                           suffixes=suffixes)
    if chains is None:
        raise RuntimeError("host rulebooks need native/rulebook.cpp")
    sentinel = np.iinfo(np.int32).max

    def transform(batch: dict) -> dict:
        out = chains(batch)
        for suffix in suffixes:
            rb = {k: ([a[0] for a in v] if isinstance(v, list) else v[0])
                  for k, v in out.pop("rulebooks" + suffix).items()}
            b = np.asarray(batch["coords" + suffix]).shape[0]
            rows = [int((np.asarray(rb["ids"][i]) < sentinel).sum())
                    for i in range(len(stage_capacity))]
            out["inputs" + suffix] = rb
            out["saturated" + suffix] = [
                (i, r, c * b) for i, (r, c) in enumerate(
                    zip(rows, stage_capacity)) if r >= c * b]
        return out

    return transform


def build_sharded_batch_rulebooks(coords, mask, sparse_shape, stage_capacity,
                                  num_shards, native=None, downs=None):
    """Per-shard chains with a leading [num_shards] axis for shard_map
    consumers (the eval twin of make_train_rulebook_transform's layout).
    Returns None without the native library."""
    coords = np.asarray(coords)
    mask = np.asarray(mask)
    b = coords.shape[0]
    assert b % num_shards == 0, (b, num_shards)
    lb = b // num_shards
    shards = []
    for s in range(num_shards):
        rb = build_batch_rulebooks(
            coords[s * lb:(s + 1) * lb], mask[s * lb:(s + 1) * lb],
            sparse_shape, stage_capacity, native=native, downs=downs)
        if rb is None:
            return None
        shards.append(rb)
    return _tree_stack(shards)
