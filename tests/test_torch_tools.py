"""The PyTorch port's tooling against the JAX package: the grid runner
(mirage_tpu_torch.cli.runner, a JAX-free copy of mirage_tpu.cli.runner) and
the Hugging Face helper (mirage_tpu_torch.cli.hf_push): push -> load and
export -> hf.py round trips at a tiny size, the pushed tensors against the
JAX helper's, and neither safetensors nor huggingface_hub imported unless
--hub asks for the upload (which a stub stands in for: no network).

Everything runs on the CPU. Tensors round-trip bit for bit (the same
float32 bytes written and read); the features of hf.py against the
model's own forward hold to 1e-5 (the same float32 math in another order).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mirage_tpu_torch import hf
from mirage_tpu_torch.api.convert import load_safetensors
from mirage_tpu_torch.api.wrapper import build_model
from mirage_tpu_torch.cli import hf_push, runner

ROOT = Path(__file__).resolve().parents[1]
DOMAINS = ["bscan", "slo", "bscanlayermap"]
ARGS = dict(model="miragepre_tiny", in_domains=DOMAINS, out_domains=DOMAINS,
            dim_tokens=64, depth=2, num_heads=2, decoder_dim=32,
            decoder_depth=1, decoder_num_heads=2)
# the flags of tests/test_torch_pretrain_cli.py: miragepre_tiny at 64²,
# patch 8
TINY = ["--in_domains", "bscan-slo-bscanlayermap",
        "--out_domains", "bscan-slo-bscanlayermap",
        "--model", "miragepre_tiny", "--decoder_dim", "64",
        "--decoder_depth", "1", "--decoder_num_heads", "4",
        "--input_size", "64", "--patch_size", "8",
        "--num_encoded_tokens", "48", "--batch_size", "8",
        "--num_workers", "0", "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run no faster on more threads, and the suite runs
    several test processes on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- runner

RUNNER_ARGVS = [
    ["python -m x", "--", "--a", "1", "2", "--b", "x", "y", "z"],
    ["python", "-m", "x", "--runners", "3", "--", "--flag", "--a", "1", "2"],
    ["python -m x", "--runner-info", "--", "--a", "1", "--b", "2", "3"],
    ["python -m x", "--", "--a", "1", "2", "--b", "x", "y",
     "--runner-filter", "1,y", "2,x"],
    ["python -m x", "--runner-filter", "--a 2", "--", "--a", "1", "2"],
    ["python -m x --fixed 7", "--", "--data_set", "OCTID", "OCTDL",
     "--pool", "global", "token_mix", "--linear_probing"],
    ["python -m x", "--runners", "2", "--runner-info"],
    ["python -m x", "--", "--a", "--b", "--runners", "4", "--c", "1"],
]


@pytest.mark.parametrize("argv", RUNNER_ARGVS)
def test_runner_builds_the_jax_runners_commands(argv):
    """parse and build_commands equal the JAX runner's over each argv: the
    base command, the runner count, the dry-run flag, the filters, the grid
    and the commands in their order."""
    from mirage_tpu.cli import runner as jax_runner

    got, want = runner.parse(list(argv)), jax_runner.parse(list(argv))
    assert got == want
    base, _, _, incompatible, grid = got
    assert runner.build_commands(base, grid, incompatible) == \
        jax_runner.build_commands(base, grid, incompatible)


def test_runner_info_runs_nothing(monkeypatch, capsys):
    """--runner-info prints every command and runs none; without it each
    command goes to the shell once, and the failures are counted."""
    argv = ["echo run", "--", "--a", "1", "2", "--b", "x", "y"]
    called = []
    monkeypatch.setattr(runner.subprocess, "call",
                        lambda cmd, shell: called.append(cmd) or
                        (1 if "--a 2 --b y" in cmd else 0))
    assert runner.main(argv + ["--runner-info"]) == [0] * 4
    out = capsys.readouterr().out
    assert called == [] and "Number of commands: 4" in out
    assert "echo run --a 2 --b y" in out
    codes = runner.main(["--runners", "2"] + argv)
    assert sorted(called) == sorted(
        f"echo run --a {a} --b {b}" for a in "12" for b in "xy")
    assert codes == [0, 0, 0, 1]
    assert "1/4 commands failed" in capsys.readouterr().out


# ---------------------------------------------------------------- hf_push

@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    """A tiny three-modality pretraining checkpoint (decoders included)."""
    path = tmp_path_factory.mktemp("hf") / "mirage-base_tiny.pth"
    sd = build_model("miragepre_tiny", ARGS, DOMAINS, 256, 32,
                     generator=torch.Generator().manual_seed(5)).state_dict()
    torch.save({"model": sd, "args": ARGS}, path)
    return path, sd


def test_push_then_load_round_trips(tmp_path, tiny_pth, monkeypatch):
    """push writes the encoder-only tensors bit for bit (the decoders
    dropped), config.json and the model card; they equal the JAX helper's
    push of the same checkpoint; load reads them through hf.py and its
    forward equals hf.py's on the source checkpoint."""
    from mirage_tpu.cli import hf_push as jax_hf_push

    path, sd = tiny_pth
    monkeypatch.setitem(hf.MIRAGEWrapper.SIZES, "base", (64, 2, 2))
    out = tmp_path / "MIRAGE-Base"
    hf_push.main(["-t", "push", "-s", "base", "--weights", str(path),
                  "--path", str(out)])
    got = load_safetensors(str(out / "model.safetensors"))
    want = {k: v for k, v in sd.items() if "output_adapters" not in k}
    assert sorted(got) == sorted(want) and len(want) < len(sd)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert json.loads((out / "config.json").read_text()) == {
        "input_size": 512, "patch_size": 32, "modalities": "bscan-slo",
        "size": "base"}
    card = (out / "README.md").read_text()
    assert "# MIRAGE-Base (PyTorch / CUDA)" in card \
        and "from mirage_tpu_torch.hf import MIRAGEWrapper" in card

    jax_out = tmp_path / "jax"
    jax_hf_push.main(["-t", "push", "-s", "base", "--weights", str(path),
                      "--path", str(jax_out)])
    jax_got = load_safetensors(str(jax_out / "model.safetensors"))
    assert sorted(jax_got) == sorted(got)
    for k, v in got.items():
        assert torch.equal(jax_got[k], v), k
    assert json.loads((jax_out / "config.json").read_text()) == \
        json.loads((out / "config.json").read_text())

    feats = hf_push.main(["-t", "load", "-s", "base", "--path", str(out),
                          "--device", "cpu"])
    assert feats.shape == (1, 513, 64)
    ref = hf.MIRAGEWrapper.from_pretrained(str(path), size="base",
                                           device="cpu")
    x = np.zeros((1, 1, 512, 512), np.float32)
    assert torch.equal(feats, ref({"bscan": x, "slo": x}))


def test_export_then_hf_round_trips(tmp_path, monkeypatch):
    """export of a pretraining checkpoint-N (the model rebuilt from its
    meta.json) writes every parameter bit for bit in the reference
    namespace and a config.json; hf.py's features from the export equal the
    checkpoint's model's own encoder features; a checkpoint of another
    configuration raises."""
    from mirage_tpu_torch.cli import run_pretraining as cli
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import init_train_state

    args = cli.process_args(parse_with_yaml(
        cli.get_parser(), TINY + ["--data_path", str(tmp_path),
                                  "--output_dir", str(tmp_path / "out")]))
    model = cli.build_model(args, torch.Generator().manual_seed(7))
    state = init_train_state(model, GroupedOptimizer(OptimizerConfig()))
    cdir = ckpt.save_checkpoint(str(tmp_path / "out"), state, 3,
                                args=vars(args))
    out = hf_push.main(["-t", "export", "--weights", cdir])
    assert out == str(tmp_path / "out" / "model.safetensors")
    got = load_safetensors(out)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert json.loads((tmp_path / "out" / "config.json").read_text()) == {
        "input_size": [64, 64], "patch_size": [8, 8],
        "modalities": "bscan-slo-bscanlayermap", "size": "tiny"}

    monkeypatch.setitem(hf.MIRAGEWrapper.SIZES, "tiny", (192, 3, 4))
    wrapper = hf.MIRAGEWrapper.from_pretrained(
        str(tmp_path / "out"), size="tiny", input_size=64, patch_size=8,
        modalities="bscan-slo", device="cpu")
    rng = np.random.default_rng(8)
    x = {d: rng.random((2, 1, 64, 64), dtype=np.float32)
         for d in ("bscan", "slo")}
    with torch.no_grad():
        want_f = model.features({d: torch.from_numpy(v)
                                 for d, v in x.items()})
    np.testing.assert_allclose(wrapper(x).numpy(), want_f.numpy(),
                               atol=1e-5, rtol=1e-5)

    new = tmp_path / "new" / "model.safetensors"  # a directory to make
    hf_push.main(["-t", "export", "--weights", cdir, "--path", str(new)])
    assert (new.parent / "config.json").is_file()
    assert sorted(load_safetensors(str(new))) == sorted(want)

    meta = json.loads((Path(cdir) / "meta.json").read_text())
    meta["args"]["decoder_dim"] = 32
    (Path(cdir) / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="size mismatch"):
        hf_push.main(["-t", "export", "--weights", cdir,
                      "--path", str(tmp_path / "other.safetensors")])


def test_hf_push_imports_neither_safetensors_nor_the_hub(tmp_path, tiny_pth):
    """In a fresh interpreter push, load and export import neither
    safetensors, huggingface_hub, JAX nor the JAX package; --hub imports
    huggingface_hub (a stub module here, so nothing leaves the machine) and
    uploads the pushed folder to the named repo."""
    path, _ = tiny_pth
    out = tmp_path / "push"
    code = f"""
import sys, types
from mirage_tpu_torch import hf
from mirage_tpu_torch.cli import hf_push
hf.MIRAGEWrapper.SIZES["base"] = (64, 2, 2)
hf_push.main(["-t", "push", "--weights", {str(path)!r}, "--path", {str(out)!r}])
hf_push.main(["-t", "load", "--path", {str(out)!r}, "--device", "cpu"])
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("safetensors", "huggingface_hub", "jax", "mirage_tpu"))
assert not bad, bad
calls = []
class HfApi:
    def create_repo(self, repo, **kw):
        calls.append(("create", repo))
    def upload_folder(self, folder_path, repo_id, **kw):
        calls.append(("upload", folder_path, repo_id))
sys.modules["huggingface_hub"] = types.SimpleNamespace(HfApi=HfApi)
hf_push.main(["-t", "push", "--weights", {str(path)!r}, "--path",
              {str(out)!r}, "--hub", "--repo", "me/tiny"])
assert calls == [("create", "me/tiny"), ("upload", {str(out)!r}, "me/tiny")]
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_hf_push_load_defaults_to_the_card(tmp_path, tiny_pth, monkeypatch):
    """load's default device is the card, which raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hf_push.main(["-t", "load", "--path", str(tiny_pth[0])])


def test_deviations_cite_existing_tests():
    """Every test that mirage_tpu_torch/DEVIATIONS.md names as a pin exists
    in the file it names, and every entry names one."""
    import re

    text = (ROOT / "mirage_tpu_torch" / "DEVIATIONS.md").read_text()
    cited = re.findall(r"`(tests/test_\w+\.py)::\s*(test_\w+)", text)
    assert len(cited) >= 20
    for path, name in cited:
        assert f"def {name}(" in (ROOT / path).read_text(), (path, name)
    rows = [line for line in text.splitlines() if line.startswith("| ")
            and not line.startswith(("| #", "| Deviation"))]
    assert rows and all("test_" in r.split("|")[-2] for r in rows), rows
