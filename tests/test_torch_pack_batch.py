"""Packed train batches: ``sessd_torch.train.train_step.pack_batch`` /
``unpack_batch`` against ``sessd_tpu.train.train_step.pack_batch`` (the
cases of tests/test_pack_batch.py), and one f32 training step of the port
on a packed batch against the same step on the batch unpacked.

Exactness: every packed field bit-equal to JAX's; ``unpack(pack(b))``
equal to ``b`` exactly but for the voxels, which come back rounded
through float16 (the one lossy field, as in JAX); the step on a packed
batch whose voxels are float16 values already equal to the unpacked step
bit for bit (the same tensors reach the same CPU arithmetic).
"""
import copy

import numpy as np
import pytest
import torch

from sessd_tpu.train import train_step as jts
from sessd_torch.models.detector import VoxelNet
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import (TrainState, make_train_step,
                                          pack_batch, unpack_batch)
from tests.test_torch_common import SPARSE_SHAPE
from tests.test_torch_train_step import (OCFG, _loss_cfgs, as_torch,
                                         make_batch, port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


def fake_batch(seed=0, b=2, v=64, a=512, with_raw=True):
    """Loader-layout fields of a train batch: labels with positives,
    negatives and don't-cares, reg_targets nonzero at the positives only
    (the target assigner's rule), voxels at lidar scale."""
    rng = np.random.RandomState(seed)
    out = {}
    for sfx in [""] + (["_raw"] if with_raw else []):
        labels = np.zeros((b, a), np.int32)
        for i in range(b):
            pos = rng.choice(a, 5 + i, replace=False)
            labels[i, pos] = 1 + i
            labels[i, (pos + 7) % a] = -1
        rt = np.zeros((b, a, 7), np.float32)
        rt[labels > 0] = rng.randn((labels > 0).sum(), 7)
        out.update({
            f"labels{sfx}": labels,
            f"reg_targets{sfx}": rt,
            f"voxels{sfx}": (rng.randn(b, v, 5, 4) * 30).astype(np.float32),
            f"coords{sfx}": rng.randint(0, 1500, (b, v, 3)).astype(np.int32),
            f"num_points{sfx}": rng.randint(1, 6, (b, v)).astype(np.int32),
            f"voxel_mask{sfx}": np.ones((b, v), bool),
        })
    return out


def assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("with_raw", [True, False], ids=["ssl", "supervised"])
def test_packed_fields_equal_jax(with_raw):
    batch = fake_batch(with_raw=with_raw)
    got = pack_batch(batch)
    assert_same_arrays(got, jts.pack_batch(batch))
    assert "reg_targets_idx" in got and got["labels"].dtype == np.int8
    assert got["voxels"].dtype == np.float16
    # the input is left as it was
    assert batch["labels"].dtype == np.int32 and "reg_targets" in batch


def test_unpack_of_pack_is_the_batch():
    batch = fake_batch()
    got = unpack_batch(as_torch(pack_batch(batch)))
    want = dict(batch)
    for sfx in ("", "_raw"):
        want["voxels" + sfx] = batch["voxels" + sfx].astype(
            np.float16).astype(np.float32)
    assert_same_arrays({k: v.numpy() for k, v in got.items()}, want)
    assert got["reg_targets"].is_contiguous()


def test_unpack_is_a_noop_on_an_unpacked_batch():
    batch = as_torch(fake_batch())
    got = unpack_batch(batch)
    assert set(got) == set(batch)
    assert all(got[k] is batch[k] for k in batch)


def test_over_cap_chain_stays_dense():
    """tests/test_pack_batch.py:67-71: a chain with more positives than
    ``pos_cap`` keeps dense reg_targets; the other fields still shrink."""
    batch = fake_batch(with_raw=False)
    batch["labels"][0, :] = 1  # 512 positives > the cap of 16
    got = pack_batch(batch, pos_cap=16)
    assert_same_arrays(got, jts.pack_batch(batch, pos_cap=16))
    assert "reg_targets" in got and "reg_targets_idx" not in got
    assert got["labels"].dtype == np.int8
    back = unpack_batch(as_torch(got))
    np.testing.assert_array_equal(back["reg_targets"].numpy(),
                                  batch["reg_targets"])
    assert back["labels"].dtype == torch.int32


def test_positive_at_anchor_zero_survives():
    """The unused slots are marked by A, not 0, so anchor 0 keeps its
    targets and no other row gets any."""
    batch = fake_batch(with_raw=False)
    batch["labels"][:] = 0
    batch["labels"][0, 0] = 1
    batch["reg_targets"][:] = 0
    batch["reg_targets"][0, 0] = np.arange(7, dtype=np.float32) + 1
    got = unpack_batch(as_torch(pack_batch(batch)))["reg_targets"].numpy()
    np.testing.assert_array_equal(got[0, 0], np.arange(7) + 1)
    assert not got[0, 1:].any() and not got[1].any()


def _step(batch):
    """One f32 SE-SSD step of the port from a fixed seeded state; returns
    (metrics, the student's state dict, the teacher's)."""
    student = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=3)
    student.reset_parameters(torch.Generator().manual_seed(3))
    teacher = copy.deepcopy(student)
    teacher.dense_from_stage = 5
    ocfg = to.OneCycleConfig(**OCFG)
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    state = TrainState(2, student, teacher, opt)
    metrics = make_train_step(_loss_cfgs()[1])(state, batch, 0.7)
    return metrics, student.state_dict(), teacher.state_dict()


def test_step_on_packed_batch_equals_unpacked_step():
    batch = make_batch()
    for sfx in ("", "_raw"):
        batch["voxels" + sfx] = batch["voxels" + sfx].astype(
            np.float16).astype(np.float32)
        batch["reg_targets" + sfx] = np.where(
            batch["labels" + sfx][..., None] > 0, batch["reg_targets" + sfx],
            0.0).astype(np.float32)
    packed = pack_batch(batch)
    assert "reg_targets_raw_idx" in packed
    plain = _step(port_batch(batch))
    got = _step(port_batch(packed))
    assert plain[0]["loss"] > 0
    for want, have in zip(plain, got):
        assert set(want) == set(have)
        for k in want:
            assert torch.equal(want[k], have[k]), k
