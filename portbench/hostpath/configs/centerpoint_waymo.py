"""CenterPoint-Voxel on Waymo Open, as published: the keys and values of
tianweiy/CenterPoint configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py
(Yin, Zhou and Kraehenbuehl, "Center-based 3D Object Detection and
Tracking", CVPR 2021, arXiv:2006.11275), plain-dict only, in the f32 the
source computes in. The port serves it (``serve.make_infer_fn`` with no
anchors); its training (heatmap targets, focal loss) is not ported, so
the sections below stop at what serving reads.
"""
tasks = [dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"])]
class_names = [n for t in tasks for n in t["class_names"]]

model = dict(
    type="VoxelNet",
    pretrained=None,
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=5),
    backbone=dict(type="SpMiddleResNetFHD", num_input_features=5,
                  ds_factor=8),
    neck=dict(
        type="RPN",
        layer_nums=[5, 5],
        ds_layer_strides=[1, 2],
        ds_num_filters=[128, 256],
        us_layer_strides=[1, 2],
        us_num_filters=[256, 256],
        num_input_features=256,
    ),
    bbox_head=dict(
        type="CenterHead",
        in_channels=sum([256, 256]),
        tasks=tasks,
        dataset="waymo",
        weight=2,
        code_weights=[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                      "rot": (2, 2)},
        share_conv_channel=64,
        num_hm_conv=2,
        init_bias=-2.19,
    ),
)

test_cfg = dict(
    post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0],
    nms=dict(
        use_rotate_nms=True,
        use_multi_class_nms=False,
        nms_pre_max_size=4096,
        nms_post_max_size=500,
        nms_iou_threshold=0.7,
    ),
    score_threshold=0.1,
    pc_range=[-75.2, -75.2],
    out_size_factor=8,  # the backbone's ds_factor
    voxel_size=[0.1, 0.1],
)

# max_voxel_num: (training, test); serving runs at the test cap
voxel_generator = dict(
    range=[-75.2, -75.2, -2, 75.2, 75.2, 4],
    voxel_size=[0.1, 0.1, 0.15],
    max_points_in_voxel=5,
    max_voxel_num=[150000, 200000],
)

# the port's per-sample sparse-stage row capacities (stage 0 is the
# voxel cap): every scan of the benchmark's pool fits each stage with
# room (portbench/configs/centerpoint_waymo_bf16.json)
stage_capacity = (200000, 150000, 70000, 30000, 20000)

dataset_type = "WaymoDataset"
data_root = "data/Waymo"
data = dict(samples_per_gpu=4, workers_per_gpu=8)

precision = "float32"  # or "bfloat16" for the compute dtype
work_dir = "work_dirs/waymo_centerpoint_voxelnet_3x"
