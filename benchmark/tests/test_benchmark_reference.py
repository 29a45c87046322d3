"""The plain reference against the port at the dev widths on the CPU, both
in float32: the forward, the pretraining loss and gradients, and the
segmentation forward with stochastic depth. (The reference itself imports
nothing of the port; this test does.)"""

import torch

from benchmark.drivers import pretrain
from benchmark.reference import mirage, seg, weights
from benchmark.reference import train as ref_train
from benchmark.reference.numerics import Numerics

NUM = Numerics("float32")


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _port_model(cfg):
    from mirage_tpu_torch.api.wrapper import build_model

    args = {"out_domains": list(cfg["domains"]), "dim_tokens":
            cfg["dim_tokens"], "depth": cfg["depth"], "num_heads":
            cfg["num_heads"], "decoder_dim": cfg["decoder"]["dim"],
            "decoder_depth": cfg["decoder"]["depth"],
            "decoder_num_heads": cfg["decoder"]["num_heads"]}
    geo = {t: ((d["image"],) * 2, (d["patch"],) * 2)
           for t, d in cfg["domains"].items()}
    model = build_model(cfg["model"], args, list(cfg["domains"]),
                        geometry=geo)
    sd = weights.make(cfg, 11, torch.float32, "cpu")
    model.load_state_dict(sd, strict=True)
    return model, sd


def test_reconstruction_matches_the_port(tiny):
    cfg, _ = tiny["infer"]
    model, sd = _port_model(cfg)
    x = {"bscan": torch.rand(2, 1, 512, 512,
                             generator=torch.Generator().manual_seed(3))}
    full = {"bscan": x["bscan"], "slo": torch.zeros(2, 1, 512, 512),
            "bscanlayermap": torch.zeros(2, 128, 128, dtype=torch.long)}
    with torch.no_grad():
        got = model(full, absent_tasks=("slo", "bscanlayermap"))
        want = mirage.reconstruct(NUM, cfg, sd, x)
    for t in want:
        assert rel(got[t], want[t]) < 1e-5, t


def test_pretraining_loss_and_gradients_match_the_port(tiny):
    from mirage_tpu_torch.train.steps import make_pretrain_loss

    cfg, traffic = tiny["train"]
    model, sd = _port_model(cfg)
    pool = pretrain.batches(cfg, traffic, 5, "cpu", 4, 16, 1.0)
    batch, masks = pool[0]
    conf = {t: {"loss": c["loss"], "patch_size": cfg["domains"][t]["patch"],
                "norm_pix": True}
            for t, c in pretrain.loss_conf(
                cfg, type("A", (), {"norm_pix_loss": True})).items()}
    loss_fn = make_pretrain_loss(model, conf, num_encoded_tokens=16)
    loss, _ = loss_fn(batch, task_masks=masks, num_visible=16)
    names = [n for n, p in model.named_parameters() if "pos_emb" not in n]
    grads = torch.autograd.grad(loss, [dict(model.named_parameters())[n]
                                       for n in names])
    params = ref_train.leaf_params(sd)
    want, ref_grads = ref_train.loss_and_grads(NUM, cfg, conf, params, batch,
                                               masks, rows=3)
    assert abs(float(loss.detach()) - want) < 1e-5 * abs(want)
    for n, g in zip(names, grads):
        assert rel(g, ref_grads[n]) < 1e-4, n


def test_segmentation_forward_matches_the_port(tiny):
    from mirage_tpu_torch.cli import run_seg_tuning as rs

    cfg, traffic = tiny["tune"]
    args = type("A", (), {})()
    args.in_domains, args.patch_size = ["bscan"], {"bscan": (32, 32)}
    args.input_size = {"bscan": (256, 256)}
    args.model_override, args.output_adapter = cfg["seg"]["model"], \
        "convnext"
    args.decoder_main_tasks, args.decoder_interpolate_mode = "bscan", \
        "bilinear"
    args.num_classes, args.num_global_tokens = 8, 1
    args.drop_path_encoder, args.remat = 0.1, False
    from mirage_tpu_torch.api.fm_configs import MIRAGEBaseSegFM

    model = rs.build_model(args, MIRAGEBaseSegFM(), torch.float32, None)
    sd = weights.make(cfg, 7, torch.float32, "cpu",
                      specs=seg.param_specs(cfg))
    model.load_state_dict(sd, strict=True)
    x = torch.rand(2, 1, 256, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.forward_light(
            {"bscan": x}, deterministic=False,
            generator=torch.Generator().manual_seed(99))["semseg"]
        want = seg.logits(NUM, cfg, sd, x, torch.Generator().manual_seed(99),
                          0.1)
        # other draws give another result: the draws are matched, not
        # absent
        other = seg.logits(NUM, cfg, sd, x, torch.Generator().manual_seed(98),
                           0.1)
    assert rel(got, want) < 1e-5
    assert rel(other, want) > 1e-3
