"""SE-SSD KITTI Car config — same schema/keys as the reference config
(examples/second/configs/config.py), plain-dict only."""
import itertools

tasks = [dict(num_class=1, class_names=["Car"])]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))

box_coder = dict(type="ground_box3d_coder", n_dim=7, linear_dim=False,
                 encode_angle_vector=False)

my_paras = dict(
    batch_size=4,
    data_mode="train",
    enable_ssl=True,
    eval_training_set=False,
)

model = dict(
    type="VoxelNet",
    pretrained=None,
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=4),
    backbone=dict(type="SpMiddleFHD", num_input_features=4, ds_factor=8),
    neck=dict(
        type="SSFA",
        layer_nums=[5],
        ds_layer_strides=[1],
        ds_num_filters=[128],
        us_layer_strides=[1],
        us_num_filters=[128],
        num_input_features=128,
    ),
    bbox_head=dict(
        type="MultiGroupHead",
        mode="3d",
        in_channels=128,
        tasks=tasks,
        weights=[1],
        box_coder=box_coder,
        encode_background_as_zeros=True,
        loss_norm=dict(type="NormByNumPositives", pos_cls_weight=1.0, neg_cls_weight=1.0),
        loss_cls=dict(type="SigmoidFocalLoss", alpha=0.25, gamma=2.0, loss_weight=1.0),
        use_sigmoid_score=True,
        loss_bbox=dict(type="WeightedSmoothL1Loss", sigma=3.0,
                       code_weights=[1.0] * 7, codewise=True, loss_weight=2.0),
        encode_rad_error_by_sin=True,
        loss_aux=dict(type="WeightedSoftmaxClassificationLoss",
                      name="direction_classifier", loss_weight=0.2),
        direction_offset=0.0,
    ),
)

target_assigner = dict(
    type="iou",
    anchor_generators=[
        dict(
            type="anchor_generator_range",
            sizes=[1.6, 3.9, 1.56],
            anchor_ranges=[0, -40.0, -1.0, 70.4, 40.0, -1.0],
            rotations=[0, 1.57],
            matched_threshold=0.6,
            unmatched_threshold=0.45,
            class_name="Car",
        ),
    ],
    sample_positive_fraction=-1,
    sample_size=512,
    region_similarity_calculator=dict(type="nearest_iou_similarity"),
    pos_area_threshold=-1,
    tasks=tasks,
)

assigner = dict(
    box_coder=box_coder,
    target_assigner=target_assigner,
    out_size_factor=8,
    debug=False,
    enable_similar_type=True,
)

train_cfg = dict(assigner=assigner)

test_cfg = dict(
    nms=dict(
        use_rotate_nms=True,
        use_multi_class_nms=False,
        nms_pre_max_size=1000,
        nms_post_max_size=100,
        nms_iou_threshold=0.01,
    ),
    score_threshold=0.3,
    post_center_limit_range=[0, -40.0, -5.0, 70.4, 40.0, 5.0],
    max_per_img=100,
)

dataset_type = "KittiDataset"
data_root = "data/kitti"

db_sampler = dict(
    type="GT-AUG",
    enable=True,
    db_info_path=data_root + "/dbinfos_train.pkl",
    sample_groups=[dict(Car=15)],
    db_prep_steps=[
        dict(filter_by_min_num_points=dict(Car=5)),
        dict(filter_by_difficulty=[-1]),
    ],
    global_random_rotation_range_per_object=[0, 0],
    rate=1.0,
)

train_preprocessor = dict(
    mode="train",
    shuffle_points=True,
    gt_loc_noise=[1.0, 1.0, 0.5],
    gt_rot_noise=[-0.785, 0.785],
    global_rot_noise=[-0.785, 0.785],
    global_scale_noise=[0.95, 1.05],
    global_rot_per_obj_range=[0, 0],
    global_trans_noise=[0.0, 0.0, 0.0],
    remove_points_after_sample=True,
    remove_environment=False,
    db_sampler=db_sampler,
    class_names=class_names,
    enable_similar_type=True,
    # shape-aware augmentation (sa_da_v2.pyramid_augment_v0 defaults)
    sa_dropout=0.25,
    sa_sparsity=[0.05, 50],
    sa_swap=[0.1, 50],
)

val_preprocessor = dict(
    mode="val",
    shuffle_points=False,
    remove_environment=False,
)

voxel_generator = dict(
    range=[0, -40.0, -3.0, 70.4, 40.0, 1.0],
    voxel_size=[0.05, 0.05, 0.1],
    max_points_in_voxel=5,
    max_voxel_num=20000,
)

train_anno = data_root + "/kitti_infos_train.pkl"
val_anno = data_root + "/kitti_infos_val.pkl"
test_anno = data_root + "/kitti_infos_test.pkl"

data = dict(
    samples_per_gpu=my_paras["batch_size"],
    workers_per_gpu=4,
    train=dict(type=dataset_type, root_path=data_root, info_path=train_anno,
               class_names=class_names),
    val=dict(type=dataset_type, root_path=data_root, info_path=val_anno,
             class_names=class_names),
    test=dict(type=dataset_type, root_path=data_root, info_path=test_anno,
              class_names=class_names),
)

optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True,
                 moving_average=False)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)

checkpoint_config = dict(interval=1)
log_config = dict(interval=10)

total_epochs = 60
ema_decay_cap = 0.999
# the teacher forward is inference-shaped (no grads), so it runs the
# all-sparse serving plan, which keeps no dense activations for a backward,
# while the student keeps dense_from_stage=3 (plan equivalence guarded by
# tests/test_teacher_plan.py — the param tree is plan-invariant)
teacher_dense_from_stage = 5
consistency_rampup_epochs = 15.0
precision = "float32"  # or "bfloat16" for the compute dtype
work_dir = "work_dirs/se_ssd_v1"
load_from = None
resume_from = None
workflow = [("train", 60), ("val", 1)]
