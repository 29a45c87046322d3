"""MIRAGE model server on the PyTorch/CUDA port: dynamic-batched
reconstruction and feature serving.

Usage:
  python -m mirage_tpu_torch.cli.serve --weights ./MIRAGE-Base.pth \
      [--device cuda] [--bf16] [--port 8473] [--max_batch 16] \
      [--max_wait_ms 5] [--warmup]

Client (stdlib):
  import io, urllib.request, numpy as np
  buf = io.BytesIO(); np.savez(buf, bscan=img)              # (H, W) in [0,1]
  r = urllib.request.urlopen("http://localhost:8473/v1/reconstruct",
                             buf.getvalue())
  out = dict(np.load(io.BytesIO(r.read())))                  # task -> array
"""

import argparse

import numpy as np
import torch


def make_model_fns(wrapper, in_domains):
    """Adapt MIRAGEWrapper to the batched numpy interface of serve.py."""

    def prep(batch):
        x = {}
        for k, arr in batch.items():
            if k not in in_domains:
                raise ValueError(f"unknown modality {k!r} (have {in_domains})")
            arr = np.asarray(arr)
            if k != "bscanlayermap" and arr.ndim == 3:  # (B, H, W) -> (B, 1, H, W)
                arr = arr[:, None]
            x[k] = arr
        return x

    def reconstruct(batch):
        preds = wrapper(prep(batch))
        return {k: v.float().cpu().numpy() for k, v in preds.items()}

    def features(batch):
        return {"features": wrapper.features(prep(batch)).float().cpu().numpy()}

    return reconstruct, features


def warmup(wrapper, model_fns, max_batch: int, *, pow2: bool = True):
    """Run every batch size the dispatcher can emit once before traffic
    (largest first): builds the kernels and settles the allocator. With
    power-of-two padding that is log2(max_batch)+1 sizes; without, all of
    1..max_batch. The request holds the first modality only (the B-scan);
    requests with more modalities run flash attention (B8) above 512
    tokens."""
    if pow2:
        sizes = [1]
        while sizes[-1] < max_batch:
            sizes.append(sizes[-1] * 2)
    else:
        sizes = list(range(1, max_batch + 1))
    for b in reversed(sizes):
        d = wrapper.in_domains[0]
        h, w = wrapper.input_size[d]
        zeros = {d: np.zeros((b, h, w), np.int32) if d == "bscanlayermap"
                 else np.zeros((b, 1, h, w), np.float32)}
        print(f"warmup: batch={b} ...", flush=True)
        for fn in model_fns:
            fn(zeros)
    print("warmup: done", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--modalities", default="bscan-slo-bscanlayermap")
    ap.add_argument("--input_size", type=int, default=512)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8473)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--request_timeout_s", type=float, default=600.0,
                    help="per-request wait bound; must cover the first call, "
                         "which builds the CUDA kernels, when starting "
                         "without --warmup")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute and bf16 weights")
    ap.add_argument("--no_pad_pow2", action="store_true",
                    help="disable padding batches to the power-of-two ladder")
    ap.add_argument("--warmup", action="store_true",
                    help="run the full batch-size ladder before accepting "
                         "traffic")
    args = ap.parse_args(argv)

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.serve import MIRAGEServer, pow2_padded

    wrapper = MIRAGEWrapper(
        input_size=args.input_size, patch_size=args.patch_size,
        modalities=args.modalities, weights=args.weights,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device)
    reconstruct, features = make_model_fns(wrapper, wrapper.in_domains)
    if not args.no_pad_pow2:
        reconstruct, features = pow2_padded(reconstruct), pow2_padded(features)
    if args.warmup:
        warmup(wrapper, [reconstruct, features], args.max_batch,
               pow2=not args.no_pad_pow2)

    device = (torch.cuda.get_device_name(wrapper.device)
              if wrapper.device.type == "cuda" else str(wrapper.device))
    server = MIRAGEServer(
        reconstruct_fn=reconstruct, features_fn=features,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        request_timeout_s=args.request_timeout_s, device=device,
        n_params=wrapper.n_params)
    print(f"serving {args.modalities} on http://{args.host}:{args.port} "
          f"(device={device}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms)", flush=True)
    try:
        server.serve(host=args.host, port=args.port)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
