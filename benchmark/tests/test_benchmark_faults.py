"""The check catches a broken timed path: each fault a cell can have,
planted under a run on the CPU, turns ``correct`` false."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import bench, cell_of, tiny_cell


def _run(tiny, mode):
    cfg, traffic = tiny[mode]
    return run.run_cell(cell_of(mode), 987654321, 1.0, False, device="cpu",
                        cfg=cfg, traffic=traffic, bench=bench(),
                          cell=tiny_cell(mode))


def test_infer_answer_altered(tiny, monkeypatch):
    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper

    call = MIRAGEWrapper.__call__

    def altered(self, x):
        out = dict(call(self, x))
        bad = out["bscan"].clone()
        bad[-1] += 0.05 * bad[-1].std()
        out["bscan"] = bad
        return out

    monkeypatch.setattr(MIRAGEWrapper, "__call__", altered)
    assert not _run(tiny, "infer")["correct"]


def test_infer_half_batch_left_out(tiny, monkeypatch):
    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper

    call = MIRAGEWrapper.__call__

    def half(self, x):
        b = next(iter(x.values())).shape[0]
        keep = (b + 1) // 2
        out = call(self, {k: v[:keep] for k, v in x.items()})
        return {k: torch.cat([v, v[:b - keep]]) for k, v in out.items()}

    monkeypatch.setattr(MIRAGEWrapper, "__call__", half)
    assert not _run(tiny, "infer")["correct"]


@pytest.mark.parametrize("mode", ["train", "tune"])
def test_step_returns_state_unchanged(tiny, mode, monkeypatch):
    from mirage_tpu_torch.train.optim import GroupedOptimizer

    def frozen(self, grads, state, params, lr, wd_scale=1.0, gnorm=None):
        from mirage_tpu_torch.train.optim import global_norm

        return global_norm([g for g in grads.values() if g is not None])

    monkeypatch.setattr(GroupedOptimizer, "update", frozen)
    result = _run(tiny, mode)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("mode", ["train", "tune"])
def test_half_batch_left_out(tiny, mode, monkeypatch):
    from mirage_tpu_torch.train import steps

    make = steps.make_train_step

    def half_step(loss_fn, optimizer, **kw):
        def half_loss(batch, generator=None, **kwargs):
            b = next(iter(batch.values())).shape[0]
            cut = {k: v[:b // 2] for k, v in batch.items()}
            if "task_masks" in kwargs:
                kwargs["task_masks"] = {k: v[:b // 2] for k, v in
                                        kwargs["task_masks"].items()}
            return loss_fn(cut, generator=generator, **kwargs)

        return make(half_loss, optimizer, **kw)

    monkeypatch.setattr(steps, "make_train_step", half_step)
    assert not _run(tiny, mode)["correct"]
