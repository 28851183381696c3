"""The precision control at a tiny size on the CPU: the reference with its
registration statistics in bfloat16 against the reference in float32
departs where float32 against itself does not."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(Path(__file__).parent)]

from control import check_roll, control_numbers  # noqa: E402
from harness import check, discover  # noqa: E402
from tiny import tiny_root  # noqa: E402


def _setup(tmp_path):
    root, _ = tiny_root(tmp_path, lap_scans=12)
    cfg = discover.config("tiny", root=root)
    mix = discover.mix("drive", root=root)
    traffic = discover.generator("lap").make(
        mix, 424242, cfg["lidar"], torch.device("cpu"), lap_scans=12)
    return cfg, traffic


def test_the_ring_layout_round_trips():
    box = torch.arange(5 * 7 * 3).reshape(5, 7, 3).numpy()
    off = [1, 6, 0]
    assert (check.unroll(check_roll(box, off), off) == box).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_control_departs_where_the_reference_does_not(tmp_path, dtype):
    cfg, traffic = _setup(tmp_path)
    limits = discover.checks("tiny.drive", root=tmp_path)["limits"]
    if dtype == torch.float32:
        ref, poses = check.replay(cfg, traffic, 8, torch.device("cpu"))
        v, w, pos, off = ref.window_box()
        window = (check_roll(v.numpy(), off), check_roll(w.numpy(), off),
                  pos, off)
        nums = check.reference_numbers(cfg, traffic, poses, window,
                                       device=torch.device("cpu"),
                                       free_scans=4)
        assert check.passed(check.judge(nums, limits, 0)) is True
    else:
        nums = control_numbers(cfg, traffic, 8, torch.device("cpu"),
                               free_scans=4)
        assert check.passed(check.judge(nums, limits, 0)) is False
