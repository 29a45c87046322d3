"""Volume-level segmentation metrics: Dice, IoU, 95% Hausdorff distance.

A numpy/scipy fork of ``mirage_tpu/metrics/volume.py`` (reference
run_seg_eval.py:51-100), so the port imports nothing of the JAX package:
per-class volume Dice and IoU with a 1e-6 smooth, and HD95 with the
reference's empty-set policy (both empty -> 0; one empty -> NaN, or the
image diagonal when empty_sets_nan=False), the nanmean over slices. HD95
is MONAI's definition computed here: each slice's surface by one binary
erosion, the directed distances by scipy's exact euclidean distance
transform, max(P95(pred -> gt), P95(gt -> pred)).
"""

import numpy as np


def dice_score(y_pred, y_true):
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    intersection = np.sum(y_true * y_pred)
    return 2.0 * intersection / (np.sum(y_true) + np.sum(y_pred) + 1e-6)


def iou_score(y_pred, y_true):
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    intersection = np.sum(y_true * y_pred)
    union = np.sum(y_true) + np.sum(y_pred) - intersection
    return intersection / (union + 1e-6)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (mask minus its erosion)."""
    from scipy.ndimage import binary_erosion

    mask = mask.astype(bool)
    if not mask.any():
        return mask
    eroded = binary_erosion(mask, iterations=1, border_value=0)
    return mask & ~eroded


def _directed_percentile(src_surface, dst_surface, percentile):
    """Percentile of distances from src surface points to the dst surface."""
    from scipy.ndimage import distance_transform_edt

    dt = distance_transform_edt(~dst_surface)
    d = dt[src_surface]
    return np.percentile(d, percentile)


def hausdorff_distance_95(y_pred, y_true, percentile: float = 95.0):
    """Symmetric percentile Hausdorff distance between two binary masks."""
    sp = _surface(np.asarray(y_pred) > 0)
    st = _surface(np.asarray(y_true) > 0)
    fwd = _directed_percentile(sp, st, percentile)
    bwd = _directed_percentile(st, sp, percentile)
    return max(fwd, bwd)


def volume_hausdorff_distance(y_pred, y_true, percentile: float = 95.0,
                              empty_sets_nan: bool = True):
    """y_pred/y_true: (S, H, W) stacks of binary slice masks; nanmean of
    per-slice HD95 with the reference's empty-set policy."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    hd95s = []
    for i in range(y_pred.shape[0]):
        pred_empty = np.unique(y_pred[i]).size == 1
        true_empty = np.unique(y_true[i]).size == 1
        if pred_empty and true_empty:
            hd95 = 0.0
        elif pred_empty or true_empty:
            if empty_sets_nan:
                hd95 = np.nan
            else:
                hd95 = float(np.sqrt(y_true[i].shape[0] ** 2
                                     + y_true[i].shape[1] ** 2))
        else:
            hd95 = float(hausdorff_distance_95(y_pred[i], y_true[i],
                                               percentile))
        hd95s.append(hd95)
    return np.nanmean(hd95s)
