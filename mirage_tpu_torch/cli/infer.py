"""Inference CLI over a folder of example subjects, on the PyTorch/CUDA port.

Counterpart of ``mirage_tpu/cli/infer.py`` (the reference
``python mirage_wrapper.py``): loads ``{image_path}/*/{modality}.npy``,
resizes as the reference does (512² anti-aliased bilinear / 255, the layer
map 128² nearest), runs the wrapper with the present modalities and saves
``__out_{task}.png`` reconstructions (the layer map as argmax / 12) or, with
``--features``, ``__out_features.npy`` encoder tokens.

Usage:
  python -m mirage_tpu_torch.cli.infer --weights ./MIRAGE-Base.pth \\
      [--features] [--modalities bscan,slo] [--image_path ./_example_images] \\
      [--device cuda]
"""

import argparse
from pathlib import Path

import numpy as np


def to_array(fn):
    """A .npy (or image) file -> float [0, 1] (1, 1, 512, 512), or the int32
    layer map (1, 128, 128) for a file name holding "layermap"; the
    reference's skimage resize (anti-aliased order 1 for images, order 0
    for layer maps)."""
    from mirage_tpu_torch.data.augment import skimage_resize
    from mirage_tpu_torch.data.folder import read_image

    fn = str(fn)
    img = read_image(fn)
    if img.ndim == 3:
        img = img[..., 0]
    if "layermap" in fn:
        img = skimage_resize(img, (128, 128), order=0, anti_aliasing=False)
        return img[None].astype(np.int32)
    img = skimage_resize(img, (512, 512), order=1, anti_aliasing=True) / 255.0
    return img[None, None].astype(np.float32)


def save_image01(arr, path):
    """(C, H, W) or (H, W) float in [0, 1] -> PNG with torchvision
    save_image's quantisation (·255, + 0.5, clamp, floor)."""
    from PIL import Image

    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3:
        arr = arr[0]
    u8 = np.clip(arr * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    Image.fromarray(u8).save(path)


def main(argv=None):
    parser = argparse.ArgumentParser("MIRAGE inference (PyTorch/CUDA)")
    parser.add_argument("--features", action="store_true")
    parser.add_argument("--model_size", default="base",
                        choices=["base", "large"])
    parser.add_argument("--weights", default=None, type=str,
                        help="defaults to ./__weights/MIRAGE-{Base,Large}.pth")
    parser.add_argument("--image_path", default="./_example_images", type=str)
    parser.add_argument("--modalities", default="bscan", type=str,
                        help="comma-separated subset present at inference")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper

    weights = args.weights or \
        f"./__weights/MIRAGE-{args.model_size.capitalize()}.pth"
    model = MIRAGEWrapper(weights=weights, output_adapters=not args.features,
                          device=args.device)
    present = args.modalities.split(",")

    for fsid in sorted(Path(args.image_path).iterdir()):
        if not fsid.is_dir():
            continue
        data = {}
        for mod in present:
            data[mod] = to_array(fsid / f"{mod}.npy")
            print("Input:", mod, data[mod].shape, data[mod].min(),
                  data[mod].max())
        if args.features:
            out = model.features(data).float().cpu().numpy()
            print("Features:", out.shape)
            np.save(fsid / "__out_features.npy", out)
        else:
            out = model(data)
            print("Outputs:")
            for k, v in out.items():
                v = v.float().cpu().numpy()
                print("\t", k, v.shape, v.min(), v.max())
                if "layermap" in k:
                    v = v.argmax(1) / 12.0
                save_image01(v[0], fsid / f"__out_{k}.png")


if __name__ == "__main__":
    main()
