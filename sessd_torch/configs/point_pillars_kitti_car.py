"""PointPillars KITTI Car config (examples/point_pillars equivalent)."""
import itertools

tasks = [dict(num_class=1, class_names=["Car"])]
class_names = ["Car"]
box_coder = dict(type="ground_box3d_coder", n_dim=7)
my_paras = dict(batch_size=2, enable_ssl=False)

model = dict(
    type="PointPillars",
    reader=dict(type="PillarFeatureNet", num_input_features=4, num_filters=[64]),
    backbone=dict(type="PointPillarsScatter", num_input_features=64),
    neck=dict(type="RPN", layer_nums=[3, 5, 5], ds_layer_strides=[2, 2, 2],
              ds_num_filters=[64, 128, 256], us_layer_strides=[1, 2, 4],
              us_num_filters=[128, 128, 128]),
    bbox_head=dict(
        type="MultiGroupHead", mode="3d", in_channels=384, tasks=tasks,
        box_coder=box_coder, encode_background_as_zeros=True,
        loss_norm=dict(type="NormByNumPositives"),
        loss_cls=dict(type="SigmoidFocalLoss", alpha=0.25, gamma=2.0, loss_weight=1.0),
        use_sigmoid_score=True,
        loss_bbox=dict(type="WeightedSmoothL1Loss", sigma=3.0, codewise=True,
                       loss_weight=2.0),
        encode_rad_error_by_sin=True,
        loss_aux=dict(type="WeightedSoftmaxClassificationLoss", loss_weight=0.2),
        direction_offset=0.0,
    ),
)

target_assigner = dict(
    type="iou",
    anchor_generators=[dict(
        type="anchor_generator_range", sizes=[1.6, 3.9, 1.56],
        anchor_ranges=[0, -39.68, -1.0, 69.12, 39.68, -1.0], rotations=[0, 1.57],
        matched_threshold=0.6, unmatched_threshold=0.45, class_name="Car")],
    sample_positive_fraction=-1, sample_size=512,
    region_similarity_calculator=dict(type="nearest_iou_similarity"),
    tasks=tasks,
)
assigner = dict(box_coder=box_coder, target_assigner=target_assigner,
                out_size_factor=2, enable_similar_type=True)
train_cfg = dict(assigner=assigner)

test_cfg = dict(
    nms=dict(use_rotate_nms=True, nms_pre_max_size=1000, nms_post_max_size=100,
             nms_iou_threshold=0.01),
    score_threshold=0.3,
    post_center_limit_range=[0, -39.68, -5.0, 69.12, 39.68, 5.0],
    max_per_img=100,
)

voxel_generator = dict(
    range=[0, -39.68, -3.0, 69.12, 39.68, 1.0],
    voxel_size=[0.16, 0.16, 4.0],
    max_points_in_voxel=100,
    max_voxel_num=12000,
)

data_root = "data/kitti"
db_sampler = dict(type="GT-AUG", enable=True,
                  db_info_path=data_root + "/dbinfos_train.pkl",
                  sample_groups=[dict(Car=15)],
                  db_prep_steps=[dict(filter_by_min_num_points=dict(Car=5)),
                                 dict(filter_by_difficulty=[-1])],
                  rate=1.0)
train_preprocessor = dict(mode="train", shuffle_points=True,
                          gt_loc_noise=[0.25, 0.25, 0.25], gt_rot_noise=[-0.157, 0.157],
                          global_rot_noise=[-0.785, 0.785],
                          global_scale_noise=[0.95, 1.05],
                          remove_points_after_sample=True, db_sampler=db_sampler,
                          class_names=class_names, enable_similar_type=True,
                          sa_dropout=None, sa_sparsity=[0.0, 50], sa_swap=[0.0, 50])
data = dict(
    samples_per_gpu=2, workers_per_gpu=4,
    train=dict(type="KittiDataset", root_path=data_root,
               info_path=data_root + "/kitti_infos_train.pkl", class_names=class_names),
    val=dict(type="KittiDataset", root_path=data_root,
             info_path=data_root + "/kitti_infos_val.pkl", class_names=class_names),
)

optimizer = dict(type="adam", wd=0.01, fixed_wd=True)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)
checkpoint_config = dict(interval=1)
log_config = dict(interval=10)
total_epochs = 160
work_dir = "work_dirs/point_pillars_v1"
load_from = None
resume_from = None
workflow = [("train", 160), ("val", 1)]
