"""The port's tensor-parallel training steps (train/steps.py: tp on data=2,
tensor=2 and tp_fsdp on fsdp=2, tensor=2) against the JAX package's step
builder on the same mesh shape and against the port's one-process step, as
tests/test_torch_parallel_step.py holds dp and fsdp: two pretraining steps
of the tiny model in four gloo processes, loss, grad norm, parameters and
moments at 1e-5. tp_fsdp runs with a small clip_grad, so the global norm
bucketed over 'fsdp' and 'tensor' decides the update. Its checkpoint
(written in the standard layout) is read into dp, written again and read
back into tp_fsdp, bit-equal each time.
"""

import pytest
import torch

from tests.test_torch_parallel_step import (check_case,  # noqa: F401
                                            one_thread, run_layouts)

CASES = {"tp": ("tp", None), "tp_fsdp_clip": ("tp_fsdp", 0.05)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return run_layouts(tmp_path_factory, CASES, resume=True)


@pytest.mark.parametrize("case", list(CASES))
def test_layout_matches_jax_and_one_process(setup, case):
    check_case(setup, CASES, case)


def test_checkpoints_resume_across_layouts(setup):
    _, _, out, _ = setup
    want = out["tp_fsdp_clip"]
    for kind in ("dp", "tp_fsdp"):
        got = out[f"resumed_{kind}"]
        for n, p in want["params"].items():
            assert torch.equal(got["params"][n], p), (kind, n)
        for key in ("mu", "nu"):
            for n, m in want["opt"][key].items():
                assert torch.equal(got["opt"][key][n], m), (kind, key, n)
        assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 2
        assert int(got["step"]) == 2
