"""Filesystem datasets: parallel per-task folders and class folders.

A fork of ``mirage_tpu/data/folder.py`` (reference mutils/dataset_folder.py:
the sorted recursive walk, the semseg value -> index mapping, min-max
normalisation of the images, MultiTaskImageFolder; the torchvision-style
ImageFolder of classification tuning). Samples are numpy;
transforms take an explicit ``np.random.Generator``. ``.npy``/``.npz`` are
read with numpy; other image files need PIL and raise without it.
"""

import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mirage_tpu_torch.data.constants import IMG_EXTENSIONS


def read_image(path: str) -> np.ndarray:
    """An image file as numpy: np.load for .npy/.npz (the first array),
    PIL for the rest."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return data[data.files[0]]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow); store the "
                          f"dataset as .npy or .npz where it is missing"
                          ) from e
    with Image.open(path) as im:
        return np.asarray(im)


def normalize_to_0_1(sample: np.ndarray) -> np.ndarray:
    sample = sample.astype(np.float32)
    lo, hi = np.min(sample), np.max(sample)
    return (sample - lo) / max(hi - lo, 1e-12)


def make_nonclass_dataset(directory: str,
                          extensions: Optional[Tuple[str, ...]] = None
                          ) -> List[str]:
    """Sorted recursive walk collecting files with allowed extensions."""
    extensions = extensions or IMG_EXTENSIONS
    directory = os.path.expanduser(directory)
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    out = []
    for root, _, fnames in sorted(os.walk(directory, followlinks=True)):
        for fname in sorted(fnames):
            if fname.lower().endswith(extensions):
                out.append(os.path.join(root, fname))
    return out


def make_class_dataset(directory: str,
                       extensions: Optional[Tuple[str, ...]] = None):
    """(paths, targets, classes) of the layout directory/class_x/xxx.png:
    classes sorted by name, each class's files by the sorted walk."""
    extensions = extensions or IMG_EXTENSIONS
    classes = sorted(d.name for d in os.scandir(directory) if d.is_dir())
    paths, targets = [], []
    for i, c in enumerate(classes):
        for p in make_nonclass_dataset(os.path.join(directory, c),
                                       extensions):
            paths.append(p)
            targets.append(i)
    return paths, np.asarray(targets, np.int64), classes


class MultiTaskImageFolder:
    """Parallel per-task folders with matching file names:
    root/task_a/.../xxx.npy, root/task_b/.../xxx.npy.

    transform(sample_dict, rng) -> sample_dict. Tasks named 'semseg' get
    the value -> index ``mapping``; the others are min-max normalised.
    Items are (sample_dict, None, id)."""

    def __init__(self, root: str, tasks: Sequence[str], *,
                 mapping: Optional[Dict[int, int]] = None,
                 extensions: Optional[Tuple[str, ...]] = None,
                 transform: Optional[Callable] = None,
                 max_images: Optional[int] = None):
        self.root = root
        self.tasks = list(tasks)
        self.mapping = mapping
        self.transform = transform
        self.samples = {task: make_nonclass_dataset(os.path.join(root, task),
                                                    extensions)
                        for task in self.tasks}
        for task, files in self.samples.items():
            if not files:
                raise RuntimeError(
                    f"Found 0 files under {os.path.join(root, task)}")
        if isinstance(max_images, int):
            total = len(self.samples[self.tasks[0]])
            perm = np.random.default_rng(0).permutation(total)
            for task in self.tasks:
                self.samples[task] = [self.samples[task][i]
                                      for i in perm][:max_images]

    def _apply_mapping(self, sample: np.ndarray) -> np.ndarray:
        lut = np.zeros(int(max(self.mapping)) + 1, np.int64)
        for k, v in self.mapping.items():
            lut[k] = v
        return lut[np.clip(sample.astype(np.int64), 0, len(lut) - 1)]

    def load_raw(self, index: int):
        sample_dict, sid = {}, None
        for task in self.tasks:
            path = self.samples[task][index]
            sample = read_image(path)
            if "semseg" in task:
                if self.mapping is not None:
                    sample = self._apply_mapping(sample)
            else:
                sample = normalize_to_0_1(sample)
            sample_dict[task] = sample
            if sid is None:
                sid = Path(path).stem
        return sample_dict, sid

    def __getitem__(self, item):
        index, rng = item if isinstance(item, tuple) \
            else (item, np.random.default_rng(0))
        sample_dict, sid = self.load_raw(index)
        if self.transform is not None:
            sample_dict = self.transform(sample_dict, rng)
        return sample_dict, None, sid

    def __len__(self):
        return len(self.samples[self.tasks[0]])


class ImageFolder:
    """Classification dataset: root/class_x/xxx.npy -> (image, target, id),
    with transform(img, rng) -> (C, H, W) float32."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 extensions: Optional[Tuple[str, ...]] = None):
        self.paths, self.targets, self.classes = make_class_dataset(
            root, extensions)
        if not self.paths:
            raise RuntimeError(f"Found 0 files under {root}")
        self.transform = transform

    @property
    def num_classes(self):
        return len(self.classes)

    def __getitem__(self, item):
        index, rng = item if isinstance(item, tuple) \
            else (item, np.random.default_rng(0))
        img = read_image(self.paths[index])
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, int(self.targets[index]), Path(self.paths[index]).stem

    def __len__(self):
        return len(self.paths)
