"""CIA-SSD-style supervised-only training (enable_ssl=False): same network,
no teacher/consistency — the reference's trainer.py / mg_head_ciassd path.
Used as the warm-start producer for SE-SSD (config.py load_from)."""

_base = __file__.replace("cia_ssd_kitti_car.py", "se_ssd_kitti_car.py")
with open(_base) as _f:
    exec(_f.read())

my_paras = dict(my_paras, enable_ssl=False)
# CIA-SSD trains the classic sin-encoded SmoothL1 regression (the plain
# head's total, mg_head.py:616-627); ODIoU is SE-SSD's replacement and is
# only ever optimized from a CIA warm start (losses.LossConfig.reg_loss)
model = dict(model, bbox_head=dict(model["bbox_head"], reg_loss="smooth_l1"))
work_dir = "work_dirs/cia_ssd_v1"
TAG = "cia_ssd"
