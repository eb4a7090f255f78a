"""3-class (Car / Pedestrian / Cyclist) config — pins the framework's
multi-class capability surface (the reference's multi-class SECOND-style
configs: one anchor generator per class, a single head task with
num_class=3, class-agnostic NMS). Supervised-only: the SE-SSD consistency
recipe is Car-specific (its score term reads class channel 0)."""

_base = __file__.replace("se_ssd_kitti_3class.py", "se_ssd_kitti_car.py")
with open(_base) as _f:
    exec(_f.read())

import itertools

tasks = [dict(num_class=3, class_names=["Car", "Pedestrian", "Cyclist"])]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))

model = dict(model, bbox_head=dict(model["bbox_head"], tasks=tasks))

target_assigner = dict(
    target_assigner,
    anchor_generators=[
        dict(type="anchor_generator_range",
             sizes=[1.6, 3.9, 1.56],
             anchor_ranges=[0, -40.0, -1.0, 70.4, 40.0, -1.0],
             rotations=[0, 1.57],
             matched_threshold=0.6, unmatched_threshold=0.45,
             class_name="Car"),
        dict(type="anchor_generator_range",
             sizes=[0.6, 0.8, 1.73],
             anchor_ranges=[0, -40.0, -0.6, 70.4, 40.0, -0.6],
             rotations=[0, 1.57],
             matched_threshold=0.35, unmatched_threshold=0.2,
             class_name="Pedestrian"),
        dict(type="anchor_generator_range",
             sizes=[0.6, 1.76, 1.73],
             anchor_ranges=[0, -40.0, -0.6, 70.4, 40.0, -0.6],
             rotations=[0, 1.57],
             matched_threshold=0.35, unmatched_threshold=0.2,
             class_name="Cyclist"),
    ],
    tasks=tasks,
)
assigner = dict(assigner, target_assigner=target_assigner,
                enable_similar_type=False)
train_cfg = dict(assigner=assigner)

my_paras = dict(my_paras, enable_ssl=False)

db_sampler = dict(
    db_sampler,
    sample_groups=[dict(Car=12, Pedestrian=6, Cyclist=6)],
    db_prep_steps=[
        dict(filter_by_min_num_points=dict(Car=5, Pedestrian=5, Cyclist=5)),
        dict(filter_by_difficulty=[-1]),
    ],
)
train_preprocessor = dict(train_preprocessor, db_sampler=db_sampler,
                          class_names=class_names,
                          enable_similar_type=False)
data = dict(
    data,
    train=dict(data["train"], class_names=class_names),
    val=dict(data["val"], class_names=class_names),
    test=dict(data["test"], class_names=class_names),
)
work_dir = "work_dirs/se_ssd_3class_v1"
TAG = "se_ssd_3class"
