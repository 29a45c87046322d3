"""The pretraining command line with a pipeline (--mesh_pipe,
--pp_microbatches): its refusals against the JAX command line's, word for
word, and a run on two processes (gloo on the CPU, spawned, rendezvous
through a file) resumed under data parallelism in one process against an
uninterrupted run.

The tiny model gets two blocks in the run (``worker.tiny_depth``: the
command line has no depth flag, and two stages need an even depth), one a
stage.
"""

import json

import numpy as np
import pytest
import torch

from mirage_tpu.cli import run_pretraining as jax_cli
from mirage_tpu_torch.api import wrapper
from mirage_tpu_torch.cli import run_pretraining
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_step import one_thread  # noqa: F401
from tests.test_torch_pretrain_cli import TINY, _make_data

# the refusals: the flags after TINY, each a condition the JAX command
# line names (run_pretraining.py:295-311)
REFUSALS = {
    "pipe x tensor": ["--model", "miragepre_base", "--mesh_pipe", "2",
                      "--mesh_tensor", "2"],
    "pipe x fsdp": ["--model", "miragepre_base", "--mesh_pipe", "2",
                    "--mesh_fsdp", "2"],
    "depth % S": ["--mesh_pipe", "2"],  # the tiny preset: 3 blocks
    "drop_path": ["--model", "miragepre_base", "--mesh_pipe", "2",
                  "--drop_path", "0.1"],
}


def _exit_message(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pipeline_refusals_match_the_jax_cli(tmp_path, case, monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    argv = TINY + ["--data_path", str(tmp_path)] + REFUSALS[case]
    want = _exit_message(jax_cli.main, argv)
    got = _exit_message(run_pretraining.main, argv + ["--device", "cpu"])
    assert got == want
    assert "--mesh_pipe" in got


@pytest.mark.parametrize("requested,local_b", [(3, 8), (-2, 8), (4, 2)])
def test_bad_microbatches_refused_as_the_jax_cli_does(tmp_path, capsys,
                                                       requested, local_b,
                                                       monkeypatch):
    """A --pp_microbatches that is no positive divisor of the local batch:
    the JAX command line on its 8 virtual devices (data 4 x pipe 2, so a
    batch of 4·local_b) and the port's check at that local batch name the
    same condition."""
    argv = TINY + ["--data_path", str(tmp_path), "--model",
                   "miragepre_base", "--mesh_pipe", "2", "--batch_size",
                   str(4 * local_b), "--pp_microbatches", str(requested)]
    want = _exit_message(jax_cli.main, argv)
    with pytest.raises(SystemExit) as e:
        run_pretraining.pipeline_microbatches(2, requested, local_b)
    got = str(e.value.code)
    head = f"--pp_microbatches {requested} must be a positive divisor of " \
           f"the local batch ({local_b} = batch_size"
    assert want.startswith(head) and got.startswith(head)


@pytest.mark.parametrize("stages,local_b,want", [(2, 8, 4), (2, 6, 3),
                                                 (4, 8, 8), (4, 6, 6),
                                                 (2, 1, 1)])
def test_automatic_microbatches(capsys, stages, local_b, want):
    """0 = auto: 2·S shrunk to a divisor of the local batch, the bubble
    (S − 1)/(M + S − 1) printed (run_pretraining.py:312-319)."""
    assert run_pretraining.pipeline_microbatches(stages, 0, local_b) == want
    bubble = (stages - 1) / (want + stages - 1)
    assert f"(bubble {bubble:.0%}" in capsys.readouterr().out


def test_pipeline_run_resumes_under_dp(tmp_path, monkeypatch):
    """One epoch with --distributed --mesh_pipe 2 on two processes (each a
    host of --batch_size 4: every stage loads the whole global batch of 8,
    four microbatches of 2 by default, and the epoch-0 panels' forward runs
    through the pipeline too), resumed for a
    second epoch in one process (data parallelism over one), equals two
    epochs in one process: the pipeline's checkpoint holds every stage's
    blocks in the standard layout."""
    monkeypatch.setattr(wrapper, "model_dims",
                        worker.tiny_depth(wrapper.model_dims, 2))
    _make_data(tmp_path / "data", np.random.default_rng(0))

    def argv(out, epochs):
        # --opt_eps 1e-5: see tests/_torch_parallel_worker.py:optimizer
        return TINY + ["--warmup_epochs", "1", "--lr", "1e-3", "--opt_eps",
                       "1e-5", "--data_path", str(tmp_path / "data"),
                       "--output_dir", str(out), "--device", "cpu",
                       "--epochs", str(epochs)]

    whole = run_pretraining.main(argv(tmp_path / "one", 2))
    workdir = tmp_path / "workers"
    workdir.mkdir()
    (workdir / "cli.json").write_text(json.dumps({
        "module": "mirage_tpu_torch.cli.run_pretraining", "tiny_depth": 2,
        "argv": argv(tmp_path / "pp", 1) + [
            "--distributed", "--mesh_pipe", "2", "--batch_size", "4"]}))
    log = worker.spawn("cli", 2, str(workdir))
    np.testing.assert_allclose(log[0]["train_loss"],
                               whole["log"][0]["train_loss"], rtol=1e-5)
    assert (tmp_path / "pp" / "debug").is_dir()
    resumed = run_pretraining.main(argv(tmp_path / "pp", 2))
    assert [r["epoch"] for r in resumed["log"]] == [1]
    a = torch.load(tmp_path / "one" / "checkpoint-1" / "checkpoint.pth")
    b = torch.load(tmp_path / "pp" / "checkpoint-1" / "checkpoint.pth")
    assert list(a["params"]) == list(b["params"])
    assert any(n.startswith("encoder.1.") for n in a["params"])
    for n, p in a["params"].items():
        torch.testing.assert_close(b["params"][n], p, atol=1e-5, rtol=1e-5,
                                   msg=n)
    for key in ("mu", "nu"):
        for n, m in a["opt"][key].items():
            torch.testing.assert_close(b["opt"][key][n], m, atol=1e-5,
                                       rtol=1e-5, msg=n)
    assert int(b["opt"]["count"]) == int(a["opt"]["count"]) == 2

