"""Detection heads: the multi-group anchor head (port of
``sessd_tpu/models/head.py``; reference mg_head_sessd.py:196-230, 425-461)
and CenterPoint's center head (``CenterHead``; det3d/models/bbox_heads/
center_head.py of tianweiy/CenterPoint).

Per task, 1x1 convs over the [B, 128, H, W] BEV map. Each output goes back to
[B, H*W*num_anchors, c] through permute(0, 2, 3, 1), the anchor-grid order
(y, x, rot) of the flattened anchors, as the JAX head's NHWC reshape gives;
on a channels-last map (serving) that is a view.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .layers import BatchNorm, Conv2d, Sequential


class TaskHead(nn.Module):
    def __init__(self, in_channels: int = 128, num_anchor_per_loc: int = 2,
                 num_class: int = 1, box_code_size: int = 7,
                 use_dir: bool = True):
        super().__init__()
        na = num_anchor_per_loc
        self.na = na
        self.conv_box = Conv2d(in_channels, na * box_code_size, 1)
        self.conv_cls = Conv2d(in_channels, na * num_class, 1)
        self.conv_iou = Conv2d(in_channels, na, 1)
        # (output name, conv attribute, channels per anchor)
        self.heads = [("box_preds", "conv_box", box_code_size),
                      ("cls_preds", "conv_cls", num_class),
                      ("iou_preds", "conv_iou", 1)]
        if use_dir:
            self.conv_dir = Conv2d(in_channels, na * 2, 1)
            self.heads.append(("dir_cls_preds", "conv_dir", 2))

    def forward(self, x: torch.Tensor) -> dict:
        b, _, h, w = x.shape
        return {name: getattr(self, conv)(x).permute(0, 2, 3, 1).reshape(
                    b, h * w * self.na, c)
                for name, conv, c in self.heads}


class MultiGroupHead(nn.Module):
    """List of task heads (SE-SSD runs a single Car task)."""

    def __init__(self, tasks: Sequence[dict], in_channels: int = 128,
                 box_code_size: int = 7, use_dir: bool = True):
        super().__init__()
        self.tasks = nn.ModuleList(
            TaskHead(in_channels, num_anchor_per_loc=2 * t["num_class"],
                     num_class=t["num_class"], box_code_size=box_code_size,
                     use_dir=use_dir)
            for t in tasks)

    def forward(self, x: torch.Tensor) -> list:
        return [task(x) for task in self.tasks]


class SepHead(nn.Module):
    """One task of CenterPoint's head (det3d/models/bbox_heads/
    center_head.py: ``SepHead``): per output, ``num_conv - 1`` 3x3 convs
    (bias) at ``head_conv`` channels, each with BatchNorm (torch's default
    eps 1e-5, as ``nn.BatchNorm2d``) and ReLU, then a 3x3 conv (bias) to
    the output's channels. ``heads`` maps each output's name to (channels,
    num_conv); the module of output ``name`` is ``self.<name>``."""

    def __init__(self, in_channels: int, heads: dict, head_conv: int = 64,
                 init_bias: float = -2.19):
        super().__init__()
        self.names = list(heads)
        for name, (classes, num_conv) in heads.items():
            layers: List[nn.Module] = []
            c = in_channels
            for _ in range(num_conv - 1):
                layers += [Conv2d(c, head_conv, 3, padding=1, bias=True),
                           BatchNorm(head_conv, eps=1e-5), nn.ReLU()]
                c = head_conv
            layers.append(Conv2d(c, classes, 3, padding=1, bias=True))
            setattr(self, name, Sequential(*layers))
        self.init_bias = init_bias

    def reset_hm_bias(self):
        with torch.no_grad():
            self.hm[-1].bias.fill_(self.init_bias)

    def forward(self, x: torch.Tensor) -> dict:
        b, _, h, w = x.shape
        out = {}
        for name in self.names:
            y = getattr(self, name)(x)
            out[name] = y.permute(0, 2, 3, 1).reshape(b, h * w, y.shape[1])
        return out


class CenterHead(nn.Module):
    """CenterPoint's head: a shared 3x3 conv (bias) + BatchNorm (torch's
    default eps 1e-5, as ``nn.BatchNorm2d``) + ReLU to
    ``share_conv_channel``, then one ``SepHead`` per task with
    ``common_heads`` plus ``hm`` (the task's classes, ``num_hm_conv``
    convs). Each output goes to [B, H*W, c] in (y, x) order, as the
    anchor heads' do; decoding is ``predict.predict_center_batch``'s."""

    def __init__(self, tasks: Sequence[dict], in_channels: int = 512,
                 share_conv_channel: int = 64,
                 common_heads: Optional[dict] = None, num_hm_conv: int = 2,
                 init_bias: float = -2.19):
        super().__init__()
        common = dict(common_heads or dict(reg=(2, 2), height=(1, 2),
                                           dim=(3, 2), rot=(2, 2)))
        self.shared_conv = Sequential(
            Conv2d(in_channels, share_conv_channel, 3, padding=1, bias=True),
            BatchNorm(share_conv_channel, eps=1e-5), nn.ReLU())
        self.tasks = nn.ModuleList(
            SepHead(share_conv_channel,
                    {**{k: tuple(v) for k, v in common.items()},
                     "hm": (t["num_class"], num_hm_conv)},
                    init_bias=init_bias)
            for t in tasks)

    def reset_hm_bias(self):
        for task in self.tasks:
            task.reset_hm_bias()

    def forward(self, x: torch.Tensor) -> list:
        x = self.shared_conv(x)
        return [task(x) for task in self.tasks]
