"""K1's device time per backbone conv at batch 1, 2, 4 and 8, with the
cluster size S of each launch and the body each conv takes, on one CUDA
device.

    python -m sessd_torch.scripts.bench_k1
    PYTHONPATH=OTHER_TREE python sessd_torch/scripts/bench_k1.py

The SE-SSD Car VoxelNet (bf16 config, seeded random weights) on
``make_scene`` seeds 0..B-1, batched at SERVING_CAPS x B: each of the 14
backbone convs through ``fused_sparse_conv`` (K1) as serving launches it,
its device time (``queued_device_ms``, the median of 30). S > 1 (a tile's
taps dealt over a cluster) comes where a launch's tiles fill less than a
wave: batch 1 and 2, some convs at batch 4. The second form times another tree's
kernels with this script (imports are absolute), so two trees compare in
turns on one card. The last line is one JSON object with every number and
the card.
"""
from __future__ import annotations

import json

import torch

from sessd_torch import builder
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.serve import (SERVING_CAPS, HostPreprocessor, make_scene,
                               stage_inputs)
from sessd_torch.utils.profiling import card_line, queued_device_ms

CONFIG = "se_ssd_kitti_car_bf16.py"
BATCHES = (1, 2, 4, 8)
SEED = 0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1 needs a CUDA device")
    cfg = builder.load_config(CONFIG)
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.cuda().eval()
    prep = HostPreprocessor(builder.build_voxelizer(cfg.voxel_generator),
                            SERVING_CAPS)
    dtype = torch.bfloat16
    card = card_line()
    result = {"card": card}
    for batch in BATCHES:
        convs = []

        def conv(x, rbk, w2, bias, n_in):
            args = (x, rbk, w2, bias, n_in)
            rows, cin, cout = rbk.shape[0], x.shape[1], w2.shape[2]
            convs.append({
                "cin": cin, "cout": cout, "rows": rows,
                "body": sc.conv_instance("fused_sparse_conv", dtype, cin,
                                         cout),
                "S": sc.launch_split(rows, cin, cout, dtype)
                if cin > 4 else 1,
                "ms": queued_device_ms(lambda: sc.fused_sparse_conv(*args),
                                       30)})
            return sc.fused_sparse_conv(*args)

        feats, rb = stage_inputs(**prep.batch(
            [make_scene(seed=s)[0] for s in range(batch)]), device="cuda")
        with torch.inference_mode():
            model.backbone(feats, rb, batch, model.sparse_shape, dtype,
                           conv=conv)
        torch.cuda.synchronize()
        total = sum(c["ms"] for c in convs)
        for i, c in enumerate(convs):
            print(f"batch {batch} conv {i:2d} {c['cin']:2d}->{c['cout']:2d} "
                  f"rows {c['rows']:6d} [{c['body']}] S={c['S']}: "
                  f"{c['ms']:.4f} ms")
        first = convs[0]
        print(f"K1 bf16 batch {batch}, {len(convs)} convs: {total:.4f} ms "
              f"(conv 0 [{first['body']}] {first['ms']:.4f} ms; the other "
              f"{len(convs) - 1} {total - first['ms']:.4f} ms) [{card}]")
        result[f"b{batch}"] = {"ms_sum": total,
                               "ms": [c["ms"] for c in convs],
                               "S": [c["S"] for c in convs],
                               "body": [c["body"] for c in convs]}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
