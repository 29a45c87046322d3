"""The work counts against counts by hand."""

import json

import pytest

from benchmark import peaks, work
from benchmark.tests.conftest import ROOT


def cfg(name):
    with open(ROOT / f"benchmark/configs/{name}.json") as f:
        return json.load(f)


def test_headline_forward_is_167_26_gflop_an_image():
    # the port's bench headline: MIRAGE-Large, the B-scan given, 257 tokens
    assert work.reconstruct(cfg("mirage_large"), 1, ["bscan"]).flops() \
        == 167_263_698_944


def _pretrain_by_hand(D, depth, heads):
    n, d, q = 99, 256, 256  # 98 visible + 1 global; decoder width, queries
    enc = depth * (24 * n * D * D + 4 * n * n * D)
    embed_img = 2 * 256 * 1024 * D
    embed_map = 2 * 256 * (64 * 64) * D
    dec = 0
    for out in (1024, 1024, 13 * 64):
        dec += (2 * n * D * d + 2 * q * d * d + 2 * n * d * 2 * d
                + 4 * q * n * d + 2 * q * d * d + 2 * 2 * q * d * 4 * d
                + 2 * (24 * q * d * d + 4 * q * q * d) + 2 * q * d * out)
    # forward, input gradient and weight gradient of every product (the
    # attention cores' backward is twice their forward), except the
    # images' patch projections, whose input takes no gradient
    return 3 * (enc + 2 * embed_img + embed_map + dec) - 2 * embed_img


@pytest.mark.parametrize("name,dims", [("mirage_base", (768, 12, 12)),
                                       ("mirage_large", (1024, 24, 16))])
def test_pretraining_flops_an_image(name, dims):
    ops = work.pretrain_step(cfg(name), 1, 98, 0)
    assert ops.flops() == _pretrain_by_hand(*dims)


def test_segtune_forward_share():
    c = cfg("mirage_base")
    ops = work.segtune_step(c, 1, 0)
    D, n = 768, 1025
    # the frozen encoder: the products' forward and input gradients only,
    # the attention cores' forward and backward
    assert sum(f for name, f, _ in ops.ops if name.startswith("enc")) \
        == 12 * (2 * 24 * n * D * D + 3 * 4 * n * n * D)


def test_least_time_is_the_larger_bound():
    ms, by = peaks.bound(989e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = peaks.bound(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ops = work.Ops()
    ops.gemm("g", 1024, 1024, 1024)
    assert ops.least_ms() == pytest.approx(
        max(2 * 1024 ** 3 / 989e12, 3 * 1024 ** 2 * 2 / 3.35e12) * 1e3)
