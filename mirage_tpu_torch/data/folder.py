"""Filesystem datasets: parallel per-task folders and class folders.

A fork of ``mirage_tpu/data/folder.py`` (reference mutils/dataset_folder.py:
the sorted recursive walk, the semseg value -> index mapping, min-max
normalisation of the images, MultiTaskDatasetFolder and its segmentation
(MultiTaskImageFolder) and pretraining (MultiTaskPretDatasetFolder, reference
mutils/datasets_pretrain.py) forms; the torchvision-style ImageFolder of
classification tuning). Samples are numpy;
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


class MultiTaskDatasetFolder:
    """Parallel per-task folders with matching file names:
    root/{prefix}task_a/.../xxx.npy, root/{prefix}task_b/.../xxx.npy.

    transform(sample_dict, rng) -> sample_dict. Tasks named 'semseg' get
    the value -> index ``mapping``; the others are min-max normalised.
    ``max_images`` keeps that many samples of a seeded permutation. Items
    are (sample_dict, None, id)."""

    def __init__(self, root: str, tasks: Sequence[str], *,
                 mapping: Optional[Dict[int, int]] = None,
                 extensions: Optional[Tuple[str, ...]] = None,
                 transform: Optional[Callable] = None,
                 prefixes: Optional[Dict[str, str]] = None,
                 max_images: Optional[int] = None):
        self.root = root
        self.tasks = list(tasks)
        self.mapping = mapping
        self.transform = transform
        prefixes = {task: "" for task in self.tasks} | dict(prefixes or {})
        self.samples = {task: make_nonclass_dataset(
                            os.path.join(root, f"{prefixes[task]}{task}"),
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


class MultiTaskImageFolder(MultiTaskDatasetFolder):
    """The per-task folders of segmentation tuning."""


class MultiTaskPretDatasetFolder(MultiTaskDatasetFolder):
    """The pretraining folders (mirage_tpu/data/folder.py:149-184,
    reference datasets_pretrain.py:86-207): ``.npy``/``.npz`` as they are
    (``layermaps``: the ``layer_maps`` array of an .npz; ``bscanlayermap``
    and ``semseg`` as int64; images as float32 / 255), other files through
    :func:`read_image` as float32 / 255; ``use_cache`` keeps every sample
    read in RAM and hands back copies."""

    def __init__(self, root, tasks, *, transform=None, use_cache=False,
                 extensions=None):
        super().__init__(root, tasks, transform=transform,
                         extensions=extensions)
        self.use_cache = use_cache
        self.cache: Dict[int, tuple] = {}

    def load_raw(self, index: int):
        if self.use_cache and index in self.cache:
            sample_dict, sid = self.cache[index]
            return {k: v.copy() for k, v in sample_dict.items()}, sid
        sample_dict, sid = {}, None
        for task in self.tasks:
            path = self.samples[task][index]
            if not path.endswith((".npy", ".npz")):
                sample = read_image(path).astype(np.float32) / 255.0
            elif task == "layermaps":
                with np.load(path) as data:
                    sample = data["layer_maps"].astype(np.int64)
            elif task in ("bscanlayermap", "semseg"):
                sample = np.load(path).astype(np.int64)
            else:
                sample = np.load(path).astype(np.float32) / 255.0
            sample_dict[task] = sample
            if sid is None:
                sid = Path(path).stem
        if self.use_cache:
            self.cache[index] = ({k: v.copy() for k, v in
                                  sample_dict.items()}, sid)
        return sample_dict, sid


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
