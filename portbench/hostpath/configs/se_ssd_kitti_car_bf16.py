"""SE-SSD KITTI-Car with bfloat16 compute (the reference's fp16 training
equivalent, det3d/core/fp16/hooks.py): bf16 needs no loss scaling, halves
the activation memory and the bytes every sparse conv gathers, so the
full-scale batch-4 step needs no backbone rematerialization.

Parameters, optimizer state and losses stay float32; only compute is bf16.
"""
import pathlib

_base = pathlib.Path(__file__).with_name("se_ssd_kitti_car.py")
exec(compile(_base.read_text(), str(_base), "exec"))

precision = "bfloat16"
work_dir = "work_dirs/se_ssd_bf16"
