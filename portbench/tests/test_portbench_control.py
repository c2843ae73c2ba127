"""The control comes out as not correct: the program's TF32 path switched on
(the precision below the configuration's float32 with TF32 off), on the
card, where TF32 exists."""
import argparse

import pytest
import torch


def test_tf32_control_is_not_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from portbench import run as bench

    args = argparse.Namespace(workload="hope_sac.eval_dlp1k", seed=5_200_000_009, seconds=3.0,
                              trace=0)
    line = bench.run_cell(args, control="tf32")
    assert not line["correct"], line["checks"]
