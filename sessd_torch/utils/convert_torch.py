"""Reference (det3d) SE-SSD checkpoints -> the port's ``VoxelNet`` (the
counterpart of ``sessd_tpu/utils/convert_torch.py``).

The reference ships ``.pth`` checkpoints saved as {state_dict, meta,
optimizer} (trainer/checkpoint.py:189-220). The port keeps det3d's module
names and parameter layouts, so every mapping of the JAX converter
(convert_torch.py:1-20) is the identity here:

- spconv SubMConv3d/SparseConv3d weight [kd, kh, kw, cin, cout]: the
  port's ``SparseConv3d.weight`` has the same 5-D layout (the JAX package
  reshapes it to [K, cin, cout]; the port does that per call);
- torch Conv2d [out, in, kh, kw] and ConvTranspose2d [in, out, kh, kw]:
  the port's ``Conv2d`` and ``ConvTranspose2d``, with no spatial flip (the
  JAX converter flips the transposed kernel for ``lax.conv_transpose``;
  torch to torch mirrors nothing);
- BatchNorm{1d,2d} weight/bias and running_mean/running_var: the port's
  ``BatchNorm`` under the same names. det3d's ``num_batches_tracked``
  buffers have no counterpart (the port's momentum is fixed at 0.01, as
  the reference's) and are the only entries passed over;
- the backbone's dense reshape keeps the reference's channel order c*D + d
  (models/backbone.py), so the neck's first conv loads unpermuted.

``load_torch_checkpoint`` loads with ``strict=True``: a key the model lacks
or the checkpoint lacks, and a tensor of another shape, raise
``load_state_dict``'s ``RuntimeError``, which names them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PASSED_OVER = "num_batches_tracked"


def convert_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """det3d VoxelNet ``state_dict`` (numpy arrays or tensors; keys with or
    without DDP's leading ``module.``, trainer/checkpoint.py:117-129) ->
    the state dict of ``sessd_torch.models.detector.VoxelNet``: float32
    CPU tensors under the same names, ``num_batches_tracked`` dropped."""
    return {k[7:] if k.startswith("module.") else k: torch.tensor(
                np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                           else v, dtype=np.float32))
            for k, v in sd.items() if not k.endswith("." + _PASSED_OVER)}


def load_torch_checkpoint(path: str, cfg="se_ssd_kitti_car.py",
                          device="cuda"):
    """Read a reference ``.pth`` ({state_dict, meta, optimizer}, or a bare
    state dict) and load it into a ``VoxelNet`` built from ``cfg`` (a
    ``Config`` or a shipped config's file name). Returns (model in eval
    mode on ``device``, meta); CUDA unless the caller asks for the CPU.
    The optimizer state is not read. The file is unpickled with
    ``weights_only=True``: tensors and plain Python values only."""
    from .. import builder

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_torch_checkpoint: CUDA is not available; "
                           "pass device='cpu' to load on the CPU")
    if isinstance(cfg, str):
        cfg = builder.load_config(cfg)
    if cfg.model["type"] != "VoxelNet":
        raise ValueError(f"det3d checkpoints load into VoxelNet, not "
                         f"{cfg.model['type']}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    model = builder.build_detector(cfg)
    model.load_state_dict(convert_state_dict(sd), strict=True)
    return model.to(device).eval(), ckpt.get("meta", {})
