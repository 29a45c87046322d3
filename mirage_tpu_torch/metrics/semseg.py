"""Histogram semantic-segmentation metrics (mIoU, mDice, accuracy).

A numpy fork of ``mirage_tpu/metrics/semseg.py`` (mmseg-style histograms
with ignore_index masking, an optional label map and reduce_zero_label), so
the port imports nothing of the JAX package. ``SegMetricAccumulator``
streams batches instead of keeping every prediction; the functional forms
(``total_intersect_and_union``, ``eval_metrics``, ``mean_iou``,
``mean_dice``) take lists of label maps over it.
"""

from typing import Dict, Optional, Sequence

import numpy as np


def _prepare(label, label_map, reduce_zero_label):
    label = np.asarray(label)
    if label_map:
        out = label.copy()
        for old_id, new_id in label_map.items():
            out[label == old_id] = new_id
        label = out
    if reduce_zero_label:
        label = label.astype(np.int64)
        label = np.where(label == 0, 255, label - 1)
        label = np.where(label == 254, 255, label)
    return label


def intersect_and_union(pred_label, label, num_classes, ignore_index,
                        label_map: Optional[Dict[int, int]] = None,
                        reduce_zero_label: bool = False):
    """Per-image class histograms: (intersect, union, pred_area, label_area)."""
    pred_label = np.asarray(pred_label)
    label = _prepare(label, label_map or {}, reduce_zero_label)
    mask = label != ignore_index
    pred_label = pred_label[mask].astype(np.int64)
    label = label[mask].astype(np.int64)
    area_pred = np.bincount(pred_label, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    correct = pred_label[pred_label == label]
    area_intersect = np.bincount(correct, minlength=num_classes)[:num_classes]
    return (area_intersect, area_pred + area_label - area_intersect,
            area_pred, area_label)


class SegMetricAccumulator:
    """Streaming accumulator over batches of (pred, gt) label maps."""

    def __init__(self, num_classes: int, ignore_index: int,
                 label_map: Optional[Dict[int, int]] = None,
                 reduce_zero_label: bool = False):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.label_map = label_map
        self.reduce_zero_label = reduce_zero_label
        self.intersect = np.zeros(num_classes, dtype=np.float64)
        self.union = np.zeros(num_classes, dtype=np.float64)
        self.pred = np.zeros(num_classes, dtype=np.float64)
        self.label = np.zeros(num_classes, dtype=np.float64)

    def update(self, pred_label, label):
        i, u, p, l = intersect_and_union(
            pred_label, label, self.num_classes, self.ignore_index,
            self.label_map, self.reduce_zero_label)
        self.intersect += i
        self.union += u
        self.pred += p
        self.label += l

    def compute(self, metrics: Sequence[str] = ("mIoU",), nan_to_num=None):
        """[overall accuracy, per-class accuracy, then per metric]."""
        with np.errstate(divide="ignore", invalid="ignore"):
            ret = [self.intersect.sum() / self.label.sum(),
                   self.intersect / self.label]
            for metric in metrics:
                if metric == "mIoU":
                    ret.append(self.intersect / self.union)
                elif metric == "mDice":
                    ret.append(2 * self.intersect / (self.pred + self.label))
                else:
                    raise KeyError(f"metric {metric} is not supported")
        if nan_to_num is not None:
            ret = [np.nan_to_num(m, nan=nan_to_num) for m in ret]
        return ret


def total_intersect_and_union(results, gt_seg_maps, num_classes, ignore_index,
                              label_map=None, reduce_zero_label=False):
    """The class histograms summed over pairs of label maps: (intersect,
    union, pred_area, label_area)."""
    if len(results) != len(gt_seg_maps):
        raise ValueError(f"{len(results)} predictions for "
                         f"{len(gt_seg_maps)} ground truths")
    acc = SegMetricAccumulator(num_classes, ignore_index, label_map,
                               reduce_zero_label)
    for pred, gt in zip(results, gt_seg_maps):
        acc.update(pred, gt)
    return acc.intersect, acc.union, acc.pred, acc.label


def eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                 metrics=("mIoU",), nan_to_num=None, label_map=None,
                 reduce_zero_label=False):
    """[overall accuracy, per-class accuracy, then each of ``metrics``]
    over pairs of label maps."""
    if isinstance(metrics, str):
        metrics = [metrics]
    acc = SegMetricAccumulator(num_classes, ignore_index, label_map,
                               reduce_zero_label)
    for pred, gt in zip(results, gt_seg_maps):
        acc.update(pred, gt)
    return acc.compute(metrics, nan_to_num)


def mean_iou(results, gt_seg_maps, num_classes, ignore_index, nan_to_num=None,
             label_map=None, reduce_zero_label=False):
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        ["mIoU"], nan_to_num, label_map, reduce_zero_label)


def mean_dice(results, gt_seg_maps, num_classes, ignore_index, nan_to_num=None,
              label_map=None, reduce_zero_label=False):
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        ["mDice"], nan_to_num, label_map, reduce_zero_label)
