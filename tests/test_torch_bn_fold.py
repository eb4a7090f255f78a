"""The serving path's dense conv + BatchNorm fold and channels-last layout
(``sessd_torch/models/layers.py``: ``fold_conv_bn``, ``Sequential``).

On the CPU, in f32: each pair shape (3x3, 1x1, strided, transposed, a
1x1 and a 2x2 deblock, no ReLU, a conv with bias, SSFA's padded first
conv), the whole SSFA, PointPillars' and CenterPoint's ``RPN``, the
multi-group head and ``CenterHead``, folded on channels-last maps against
the unfolded NCHW path within 1e-5 of the largest output; the fold made
again after ``load_state_dict``, a running-statistic update and an
EMA-style ``copy_``; training mode and autograd bit-equal to the
unfolded path, forward and backward; the state-dict keys of the reference
trees; head outputs as views of channels-last conv outputs.

On the card (``-m cuda``, skipped without one): one bf16 serving batch of
SE-SSD through ``make_infer_fn``, folded NHWC against the unfolded NCHW
path and an f32 reference of its neck and head, and a profile of the
batch with no cuDNN layout transpose (but one around a one-channel
output) and each pair's BatchNorm passes gone.

    python -m pytest tests/test_torch_bn_fold.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_bn_fold.py
"""
import collections
import contextlib
import copy
import os

import numpy as np
import pytest
import torch
from torch import nn

from sessd_torch import builder
from sessd_torch.models import backbone as bb
from sessd_torch.models import layers
from sessd_torch.models.head import CenterHead, MultiGroupHead
from sessd_torch.models.layers import (BatchNorm, Conv2d, ConvTranspose2d,
                                       Sequential, conv_bn_relu)
from sessd_torch.models.pillars import RPN
from sessd_torch.models.ssfa import SSFA
from portbench.reference import centerpoint as ref
from sessd_torch.utils import profiling
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CL = torch.channels_last
# the repo's bf16 bound (tests/test_torch_kernels_cuda.py), here on the
# relative L2 distance of a head output
BF16_GAP = 2e-2


def _bev_nchw(dense):
    b, d, h, w, c = dense.shape
    return dense.permute(0, 4, 1, 2, 3).reshape(b, c * d, h, w)


@contextlib.contextmanager
def unfolded_path():
    """The serving path as it ran before the fold: every ``Sequential`` as
    ``nn.Sequential`` (each BatchNorm its own passes), eval conv weights
    in their NCHW layout, the backbone's BEV map NCHW."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.Sequential, "forward", nn.Sequential.forward)
        mp.setattr(layers, "_eval_layout", lambda module: False)
        mp.setattr(bb, "bev_nhwc", _bev_nchw)
        yield


def randomize(model: nn.Module, seed: int) -> nn.Module:
    """Every parameter and BatchNorm statistic drawn from ``seed``: conv
    weights at unit fan-in variance, biases and BN shifts ~0.1-0.2, BN
    scales and variances in [0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dim() >= 2:
                fan = t[0].numel() if t.dim() != 5 else t.shape[-2] * 27
                t.copy_(torch.randn(t.shape, generator=gen) / fan ** 0.5)
            elif name.endswith("running_var") or (name.endswith("weight")
                                                  and t.dim() == 1):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    return model


def rel_max(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _outputs(out):
    """A module's output as a flat {name: tensor}."""
    if isinstance(out, torch.Tensor):
        return {"out": out}
    if isinstance(out, list):
        return {f"{i}.{k}": v for i, d in enumerate(out) for k, v in d.items()}
    return dict(out)


def _folded_count(fn):
    """(fn()'s output, the ``conv_bn_folded`` count of the call)."""
    profiling.reset()
    profiling.enable()
    try:
        with profiling.span("call"):
            out = fn()
        _, counts = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    return out, sum(v for _, n, v in counts if n == "conv_bn_folded")


def _compare(module, x, pairs):
    """``module`` in eval, folded on the channels-last ``x`` against the
    unfolded path on NCHW ``x``: within 1e-5 of the largest output, each
    output channels-last, ``pairs`` folds counted."""
    module.eval()
    with torch.no_grad():
        got, n = _folded_count(lambda: module(x.contiguous(memory_format=CL)))
        with unfolded_path():
            want = module(x.contiguous())
    assert n == pairs
    got, want = _outputs(got), _outputs(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert rel_max(got[k], v) < 1e-5, (k, rel_max(got[k], v))
    return got


PAIRS = {
    "3x3": lambda: conv_bn_relu(16, 24, 3),
    "1x1": lambda: conv_bn_relu(16, 24, 1),
    "strided": lambda: conv_bn_relu(16, 24, 3, stride=2),
    "transposed": lambda: conv_bn_relu(16, 24, 3, stride=2, transpose=True),
    "deblock_2x2": lambda: [ConvTranspose2d(16, 24, 2, stride=2, bias=False),
                            BatchNorm(24), nn.ReLU()],
    "deblock_1x1": lambda: [ConvTranspose2d(16, 24, 1, stride=1, bias=False),
                            BatchNorm(24), nn.ReLU()],
    "no_relu": lambda: conv_bn_relu(16, 1, 1, relu=False),
    "bias": lambda: [Conv2d(16, 24, 3, padding=1, bias=True),
                     BatchNorm(24, eps=1e-5), nn.ReLU()],
    "padded": lambda: [nn.ZeroPad2d(1), *conv_bn_relu(16, 24, 3, padding=0)],
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_pair_folds_to_one_conv(name):
    seq = randomize(Sequential(*PAIRS[name]()), seed=1)
    x = torch.randn(2, 16, 9, 11, generator=torch.Generator().manual_seed(2))
    got = _compare(seq, x, pairs=1)["out"]
    assert got.is_contiguous(memory_format=CL)


def _rpn_center():
    return RPN(256, (5, 5), (1, 2), (128, 256), (1, 2), (256, 256))


MODULES = {
    # (module, input [B, C, H, W], folded pairs)
    "ssfa": (lambda: SSFA(128), (1, 128, 7, 9), 14),
    "rpn_pillars": (lambda: RPN(), (1, 64, 16, 16), 19),
    "rpn_centerpoint": (_rpn_center, (2, 256, 8, 8), 14),
    "multi_group_head": (lambda: MultiGroupHead([dict(num_class=1)]),
                         (1, 128, 7, 9), 0),
    "center_head": (lambda: CenterHead([dict(num_class=3)], 512, 64,
                                       dict(reg=(2, 2), height=(1, 2),
                                            dim=(3, 2), rot=(2, 2))),
                    (2, 512, 8, 8), 6),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_folded_matches_unfolded(name):
    make, shape, pairs = MODULES[name]
    module = randomize(make(), seed=3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    _compare(module, x, pairs)


def _pair():
    return randomize(Sequential(Conv2d(8, 12, 3, padding=1, bias=True),
                                BatchNorm(12), nn.ReLU()), seed=5).eval()


X8 = torch.randn(2, 8, 6, 7, generator=torch.Generator().manual_seed(6))


def _both(seq):
    with torch.no_grad():
        got = seq(X8.contiguous(memory_format=CL))
        with unfolded_path():
            want = seq(X8)
    return got, want


@pytest.mark.parametrize("change", ["load_state_dict", "running_stats",
                                    "ema_copy", "none"])
def test_fold_is_made_again_when_a_source_changes(change):
    seq = _pair()
    before, _ = _both(seq)
    kept = seq[0]._derived[("fold", torch.float32)][1]
    other = randomize(_pair(), seed=7)
    with torch.no_grad():
        if change == "load_state_dict":
            seq.load_state_dict(other.state_dict())
        elif change == "running_stats":
            seq[1].running_var.mul_(3.0)
            seq[1].running_mean.add_(0.5)
        elif change == "ema_copy":
            for e, p in zip(seq.parameters(), other.parameters()):
                e.copy_(0.5 * e + 0.5 * p)
    got, want = _both(seq)
    assert rel_max(got, want) < 1e-5
    again = seq[0]._derived[("fold", torch.float32)][1]
    if change == "none":
        assert again is kept and torch.equal(got, before)
    else:
        assert again is not kept and rel_max(got, before) > 1e-3


def _grads(module, x, train: bool, grad: bool):
    module.train(train)
    with torch.set_grad_enabled(grad):
        out = _outputs(module(x))
    if not grad:
        return out, None
    total = sum(v.float().square().sum() for v in out.values())
    return out, torch.autograd.grad(total, list(module.parameters()))


@pytest.mark.parametrize("train,grad", [(True, True), (False, True),
                                        (True, False)],
                         ids=["train_grad", "eval_grad", "teacher"])
def test_training_and_autograd_take_the_unfolded_path(train, grad):
    """Bit for bit the unfolded path's forward (and backward): the student
    (training mode, autograd), eval under autograd, and the teacher
    (training mode under no_grad), whose running statistics move alike."""
    make = MODULES["rpn_centerpoint"][0]
    a = randomize(make(), seed=8)
    b = copy.deepcopy(a)
    x = torch.randn(2, 256, 8, 8, generator=torch.Generator().manual_seed(9))
    got, ggot = _grads(a, x, train, grad)
    with unfolded_path():
        want, gwant = _grads(b, x, train, grad)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if grad:
        assert all(torch.equal(g, w) for g, w in zip(ggot, gwant))
    for (k, s), (_, t) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(s, t), k


def test_state_dict_keys_are_the_reference_trees():
    """CenterPoint's neck and head keys equal the plain reference's, and
    SE-SSD's whole tree the det3d golden names."""
    cfg = builder.load_config("centerpoint_waymo.py")
    model = builder.build_detector(cfg)
    r = ref.CenterPoint((41, 64, 64))
    for part in ("neck", "bbox_head"):
        assert (sorted(getattr(model, part).state_dict())
                == sorted(getattr(r, part).state_dict())), part
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "ref_full_model.npz"))
    sessd = builder.build_detector(builder.load_config("se_ssd_kitti_car.py"))
    assert sorted(sessd.state_dict()) == sorted(golden["sd_names"].tolist())


@pytest.mark.parametrize("name", ["multi_group_head", "center_head"])
def test_head_outputs_are_views_on_channels_last_maps(name):
    make, shape, _ = MODULES[name]
    head = randomize(make(), seed=10).eval()
    x = torch.randn(shape).contiguous(memory_format=CL)
    with torch.no_grad():
        out = _outputs(head(x))
    for k, v in out.items():
        assert v.is_contiguous() and v._is_view(), k


def test_backbone_bev_is_channels_last_in_the_reference_order():
    dense = torch.randn(2, 3, 5, 4, 6)  # [B, D, H, W, C]
    got = bb.bev_nhwc(dense)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, _bev_nchw(dense))


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def bias_passes(model) -> int:
    """The folded convs whose bias cuDNN does not take in its epilogue:
    transposed convs other than 1x1 stride 1, and convs with no ReLU."""
    n = 0
    for seq in model.modules():
        if not isinstance(seq, Sequential):
            continue
        mods = list(seq)
        for i, m in enumerate(mods[:-1]):
            if isinstance(m, (Conv2d, ConvTranspose2d)) and isinstance(
                    mods[i + 1], BatchNorm):
                relu = i + 2 < len(mods) and isinstance(mods[i + 2], nn.ReLU)
                plain = (isinstance(m, Conv2d)
                         or layers._pointwise(m))
                n += not (relu and plain)
    return n


def kernels_per_call(fn, calls: int = 2) -> collections.Counter:
    """Device kernel launches by name per ``fn()`` call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter(e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA)
    return collections.Counter({k: v / calls for k, v in out.items()})


def one_channel_convs(model) -> int:
    """Convs with one output channel and a window wider than 1x1 (the
    center head's ``height``): cuDNN writes such an output through one
    nhwcToNchw transpose of it, on either path (a 1x1 one runs as a
    GEMM)."""
    return sum(isinstance(m, Conv2d) and m.out_channels == 1
               and m.kernel_size != (1, 1) for m in model.modules())


def broadcast_passes(kernels) -> float:
    """Launches of TensorIterator's non-vectorized elementwise kernel, the
    one a [1, C, 1, 1] operand takes."""
    return sum(v for k, v in kernels.items()
               if "at::native::elementwise_kernel<" in k)


def transposes(kernels) -> float:
    return sum(v for k, v in kernels.items()
               if "nchwToNhwc" in k or "nhwcToNchw" in k)


def check_serving(model, infer, inputs, pairs):
    """One bf16 serving batch folded NHWC against the unfolded NCHW path:
    each head output within ``BF16_GAP`` of the f32 unfolded neck and head
    on the same BEV map and of the unfolded path's; a view, contiguous in [B,
    H*W*A, c]; ``pairs`` folds a batch; no cuDNN transpose but those of
    one-channel outputs (``one_channel_convs``), and each pair's two
    BatchNorm passes gone from the profile."""
    seen = {}
    hooks = [model.neck.register_forward_hook(
                 lambda m, i, o: seen.update(bev=i[0], neck=o)),
             model.bbox_head.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("head", o[0]))]
    try:
        _, n = _folded_count(lambda: infer(*inputs))
        folded, bev, neck = seen["head"], seen["bev"], seen["neck"]
        assert bev.is_contiguous(memory_format=CL)
        with unfolded_path():
            infer(*inputs)
            plain = seen["head"]
            unfolded_kernels = kernels_per_call(lambda: infer(*inputs))
        kernels = kernels_per_call(lambda: infer(*inputs))
    finally:
        for h in hooks:
            h.remove()
    assert n == pairs
    m32 = copy.deepcopy(model).float()
    with torch.no_grad(), unfolded_path():
        want = m32.bbox_head(m32.neck(bev.float().contiguous()))[0]
    for k, w in want.items():
        assert folded[k].is_contiguous() and folded[k].shape == w.shape, k
        assert gap(folded[k], w) < BF16_GAP, (k, gap(folded[k], w))
        assert gap(folded[k], plain[k]) < BF16_GAP, k
    with torch.no_grad():
        views = model.bbox_head(neck)[0]
    assert all(v._is_view() and v.is_contiguous() for v in views.values())
    assert transposes(unfolded_kernels) > one_channel_convs(model)
    assert transposes(kernels) == one_channel_convs(model), [
        k for k in kernels if "To" in k]
    removed = broadcast_passes(unfolded_kernels) - broadcast_passes(kernels)
    assert removed >= 2 * pairs - bias_passes(model), (
        removed, pairs, bias_passes(model))
    return kernels, unfolded_kernels


@pytest.mark.cuda
def test_card_sessd_serving_batch_folds_in_nhwc(cuda):
    from sessd_torch.serve import (SERVING_CAPS, HostPreprocessor,
                                   make_infer_fn, make_scene)

    cfg = builder.load_config("se_ssd_kitti_car_bf16.py")
    model = randomize(builder.build_detector(cfg), seed=11).to(cuda).eval()
    builder.set_cls_prior(model)
    prep = HostPreprocessor(builder.build_voxelizer(cfg.voxel_generator),
                            SERVING_CAPS)
    batch = prep.batch([make_scene(seed=s)[0] for s in range(2)])
    infer = make_infer_fn(model, builder.build_anchors(cfg),
                          builder.build_predict_config(cfg), SERVING_CAPS, 2,
                          cuda)
    check_serving(model, infer, (batch["feats"], batch["rulebooks"]),
                  pairs=14)
