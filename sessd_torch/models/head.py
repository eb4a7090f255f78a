"""Multi-group detection head (port of ``sessd_tpu/models/head.py``;
reference mg_head_sessd.py:196-230, 425-461).

Per task, 1x1 convs over the [B, 128, H, W] BEV map. Each output goes back to
[B, H*W*num_anchors, c] through permute(0, 2, 3, 1), the anchor-grid order
(y, x, rot) of the flattened anchors, as the JAX head's NHWC reshape gives.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import Conv2d


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
