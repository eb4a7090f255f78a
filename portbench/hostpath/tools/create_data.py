"""Info files, reduced clouds and the GT-AUG database of a KITTI root
(the steps of ``tools/create_data.py``), through the port's host code
(``sessd_torch.data.kitti_common``).

    python -m sessd_torch.tools.create_data ROOT --train 0-99 --val 100-119
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Sequence

from ..data import kitti_common as kc


def create_kitti_data(root: str, splits: Dict[str, Sequence[int]],
                      num_workers: int = 2) -> Dict[str, str]:
    """Writes ``kitti_infos_<split>.pkl`` and the reduced clouds for each
    split, and ``dbinfos_train.pkl`` (Car) from the train split, the file
    names the shipped configs read. Returns {split: info path}."""
    paths = {}
    for split, ids in splits.items():
        path = os.path.join(root, f"kitti_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(kc.create_kitti_info(root, list(ids),
                                             num_workers=num_workers), f)
        kc.create_reduced_point_cloud(root, path)
        paths[split] = path
    if "train" in paths:
        kc.create_groundtruth_database(
            root, paths["train"],
            dbinfo_path=os.path.join(root, "dbinfos_train.pkl"),
            used_classes=("Car",))
    return paths


def _ids(span: str):
    lo, hi = span.split("-")
    return range(int(lo), int(hi) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--train", type=_ids, required=True, help="e.g. 0-99")
    ap.add_argument("--val", type=_ids, default=None)
    args = ap.parse_args(argv)
    splits = {"train": args.train}
    if args.val is not None:
        splits["val"] = args.val
    for split, path in create_kitti_data(args.root, splits).items():
        print(f"{split}: {path}")


if __name__ == "__main__":
    main()
