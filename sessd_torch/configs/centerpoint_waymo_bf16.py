"""CenterPoint-Voxel (Waymo) with bfloat16 compute, as
``se_ssd_kitti_car_bf16.py`` sits on its base: parameters stay float32,
the sparse convs, RPN and head compute in bf16, the decode and NMS in
float32.
"""
import pathlib

_base = pathlib.Path(__file__).with_name("centerpoint_waymo.py")
exec(compile(_base.read_text(), str(_base), "exec"))

precision = "bfloat16"
work_dir = "work_dirs/waymo_centerpoint_voxelnet_3x_bf16"
