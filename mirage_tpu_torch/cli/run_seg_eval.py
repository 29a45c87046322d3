"""Volume-level evaluation of exported segmentation predictions.

Counterpart of ``mirage_tpu/cli/run_seg_eval.py`` (reference
run_seg_eval.py): the prediction PNGs that ``run_seg_tuning --test`` wrote
into ``{model_path}/preds`` (or ``preds_{external}``) are grouped into
volumes by their ``{scan}_{slice}`` stems against the test split's label
PNGs, resized nearest to the labels' size where they differ, and scored per
volume and foreground class: Dice, IoU and HD95 (``metrics/volume.py``).
INFO.json's "invalid" classes are copied from the labels into the
predictions; background classes are left out unless ``--no_ignore_bg``. An
AROI model tested on Duke iAMD has its classes translated first. Results
go to ``results_layers{suffix}.csv`` and ``results_lesions{suffix}.csv``
for Duke_DME and AROI, else ``results{suffix}.csv``.

Host numpy and scipy only; the CSVs are written with ``csv`` (the JAX CLI
uses pandas, which the card's machine lacks), in pandas' format: a header,
no index, floats as ``repr``, NaN as an empty cell.

Usage:
  python -m mirage_tpu_torch.cli.run_seg_eval -d <datasets root> \\
      -m <run dir with preds/> [-e Duke_iAMD]
"""

import argparse
import csv
import json
import math
from pathlib import Path

import numpy as np

FIELDS = ("ID", "Class", "Dice", "IoU", "HD95")
LESIONS = ("Fluid", "Cyst", "PED", "SRF")


def get_args(argv=None):
    p = argparse.ArgumentParser("Evaluate segmentation results")
    p.add_argument("-d", "--datasets_path", type=str,
                   default="./__datasets/Segmentation/")
    p.add_argument("-m", "--model_path", type=str, required=True,
                   help='Trained model dir containing a "preds" subdirectory')
    p.add_argument("-e", "--external", type=str, default=None)
    p.add_argument("--ignore_bg", action="store_true", default=True)
    p.add_argument("--no_ignore_bg", dest="ignore_bg", action="store_false")
    p.add_argument("--empty_sets_nan", action="store_true", default=True)
    p.add_argument("--no_empty_sets_nan", dest="empty_sets_nan",
                   action="store_false")
    return p.parse_args(argv)


AROI_TO_DUKEIAMD = {0: 51, 23: 102, 46: 102, 69: 153, 92: 204,
                    115: 0, 138: 0, 161: 0}


def translate_to_dukeiamd_from_aroi(y_pred, y_true):
    """AROI layer classes -> Duke iAMD classes; the lesion classes map to
    the invalid class 0, and the ground truth's pixels there are
    invalidated too (run_seg_eval.py:109-148)."""
    lut = np.zeros(max(AROI_TO_DUKEIAMD) + 1, y_pred.dtype)
    for k, v in AROI_TO_DUKEIAMD.items():
        lut[k] = v
    y_pred_t = lut[np.clip(y_pred, 0, len(lut) - 1)]
    y_true_t = y_true.copy()
    y_true_t[y_pred_t == 0] = 0
    return y_pred_t, y_true_t


def group_volumes(gt_dir: Path):
    """{scan_id: [slice stems in slice order]} of '{scan}_{slice}' names."""
    volumes = {}
    for fn in gt_dir.iterdir():
        stem = fn.stem
        cut = stem.rfind("_")
        volumes.setdefault(stem[:cut], {})[int(stem[cut + 1:])] = stem
    return {sid: [sl[i] for i in sorted(sl)] for sid, sl in volumes.items()}


def read_png(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def nan_mean(values) -> float:
    """The mean over the values that are not NaN (pandas' ``mean``); NaN
    when none is left."""
    kept = [float(v) for v in values if not math.isnan(float(v))]
    return sum(kept) / len(kept) if kept else float("nan")


def write_csv(path: Path, rows):
    """``rows`` as pandas' ``to_csv(index=False)`` writes them."""
    def cell(v):
        if isinstance(v, str):
            return v
        return "" if math.isnan(float(v)) else repr(float(v))

    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(FIELDS)
        for row in rows:
            out.writerow([cell(row[k]) for k in FIELDS])


def main(argv=None):
    from mirage_tpu_torch.data.augment import resize_np
    from mirage_tpu_torch.metrics.volume import (dice_score, iou_score,
                                                 volume_hausdorff_distance)

    args = get_args(argv)
    model_path = Path(args.model_path)
    datasets_path = Path(args.datasets_path)
    if args.external is not None:
        preds_path = model_path / f"preds_{args.external}"
        dataset = args.external
        suffix = f"_{args.external}"
        test_dir = datasets_path / dataset / "test"
        gt_dir = (test_dir / "semseg") if test_dir.exists() \
            else (datasets_path / dataset / "semseg")
        source_dataset = model_path.parent.name
    else:
        preds_path = model_path / "preds"
        dataset = model_path.parent.name
        suffix = ""
        gt_dir = datasets_path / dataset / "test" / "semseg"
        source_dataset = dataset
    if dataset.startswith("Duke_iAMD") and source_dataset == "AROI":
        translator = translate_to_dukeiamd_from_aroi
    else:
        def translator(p, g):
            return p, g
    for path in (preds_path, gt_dir):
        if not path.exists():
            raise FileNotFoundError(path)

    with open(datasets_path / dataset / "INFO.json") as f:
        info = json.load(f)
    sem_classes = {v["value"]: v["label"] for v in info.values()}
    fg_classes, invalid_classes = [], []
    for value, label in sem_classes.items():
        low = label.lower()
        if "invalid" in low:
            invalid_classes.append(value)
        elif not (args.ignore_bg and ("bg" in low or "background" in low
                                      or "above ilm" in low)):
            fg_classes.append(value)
    print("Foreground classes:", fg_classes)

    rows = []
    for scan_id, slices in group_volumes(gt_dir).items():
        gt = np.stack([read_png(gt_dir / f"{s}.png") for s in slices])
        preds = []
        for s in slices:
            for cand in (f"{s}.png", f"{s}_pred.png"):
                if (preds_path / cand).exists():
                    preds.append(read_png(preds_path / cand))
                    break
            else:
                raise FileNotFoundError(f"No prediction for slice {s}")
        pred = np.stack(preds)
        if gt.shape != pred.shape:
            pred = np.stack([resize_np(p, gt.shape[1:], mode="nearest")
                             for p in pred])
        pred, gt = translator(pred, gt)
        for sc in invalid_classes:
            pred[gt == sc] = sc
        for sc in fg_classes:
            sc_gt, sc_pred = gt == sc, pred == sc
            rows.append({
                "ID": scan_id, "Class": sem_classes[sc],
                "Dice": dice_score(sc_pred, sc_gt),
                "IoU": iou_score(sc_pred, sc_gt),
                "HD95": volume_hausdorff_distance(sc_pred, sc_gt, 95,
                                                  args.empty_sets_nan)})

    def show(part):
        print(f"  Dice: {nan_mean(r['Dice'] for r in part) * 100:.2f}  "
              f"IoU: {nan_mean(r['IoU'] for r in part) * 100:.2f}  "
              f"HD95: {nan_mean(r['HD95'] for r in part):.2f}")

    print("\nAverage results:")
    show(rows)
    if dataset in ("Duke_DME", "AROI"):
        layers = [r for r in rows if r["Class"] not in LESIONS]
        lesions = [r for r in rows if r["Class"] in LESIONS]
        print("Layers:")
        show(layers)
        print("Lesions:")
        show(lesions)
        write_csv(model_path / f"results_layers{suffix}.csv", layers)
        write_csv(model_path / f"results_lesions{suffix}.csv", lesions)
    else:
        write_csv(model_path / f"results{suffix}.csv", rows)
    print(f'Results saved to "{model_path}"')
    return rows


if __name__ == "__main__":
    main()
