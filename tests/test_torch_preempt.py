"""Preemption across the ranks of a process group: a launcher's SIGTERM
reaches the ranks at different times, and every rank must still stop after
the same step and save together (``esr_tpu_torch/train.py`` combines the
flag over the world before each check). Two gloo CPU ranks under
``train_tp: 2`` (G nf 8, nb 2, gc 4; each checkpoint gathers the sharded
trunk, a collective). Two cases: rank 0 raises its flag when step 2 ends and
rank 1 when step 3 ends; or rank 1 alone raises it from a thread while its
second stop check waits in the all-reduce (SIGTERM's handler runs when that
call returns), which the next check must still see. Both ranks stop after
step 2 in either case. One ``comm.spawn`` with a 60 s timeout: ranks that
part ways meet mismatched collectives and hang or fail, which the timeout
turns into a failure here."""

from __future__ import annotations

import os

import pytest
import torch

import torch_parallel_workers as W
from esr_tpu_torch.parallel import comm

NITER = 4


def tp_opt(root: str, name: str) -> dict:
    return {"name": name, "model": "sr", "scale": 4, "bf16": False, "train_tp": 2,
            "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "n_images": 8, "image_size": 48,
                                   "batch_size": 2, "HR_size": 32}},
            "path": {"root": root},
            "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1},
            "train": {"lr_G": 1e-3, "manual_seed": 0, "watchdog": False, "pixel_weight": 1.0, "niter": NITER},
            "logger": {"print_freq": 1, "save_checkpoint_freq": 100}}


@pytest.mark.parametrize("raise_at", [[("step", 2), ("step", 3)], [None, ("check", 2)]],
                         ids=["after_step_2_and_3", "during_check_2"])
def test_preemption_stops_every_rank_after_the_same_step(tmp_path, raise_at):
    root = str(tmp_path / "runs")
    runs = [(tp_opt(root, "pre"), False, raise_at),
            (tp_opt(root, "pre"), True, None),  # --auto_resume to the end
            (tp_opt(root, "straight"), False, None)]
    ranks = comm.spawn(W.preempt_runs, 2, tmp_path / "ranks", args=(runs,), timeout=60.0)
    assert ranks[0] == ranks[1] == [[1, 2], [3, 4], [1, 2, 3, 4]], ranks
    exp = os.path.join(root, "experiments")
    # the preempted run wrote one latest_G.pth and one 2.state; the resumed run its end state beside it
    assert sorted(os.listdir(os.path.join(exp, "pre", "training_state"))) == ["2.state", "4.state"]
    assert sorted(os.listdir(os.path.join(exp, "straight", "models"))) == ["latest_G.pth"]
    state = torch.load(os.path.join(exp, "pre", "training_state", "2.state"), weights_only=True)
    assert state["iter"] == 2
    resumed = torch.load(os.path.join(exp, "pre", "models", "latest_G.pth"), weights_only=True)
    straight = torch.load(os.path.join(exp, "straight", "models", "latest_G.pth"), weights_only=True)
    assert resumed.keys() == straight.keys()
    for k, v in straight.items():
        torch.testing.assert_close(resumed[k], v, rtol=0, atol=0, msg=k)


def test_any_rank_under_nccl_agrees_over_a_gloo_group_on_the_host(tmp_path):
    """The flags' all-reduce stays off the device stream: under an NCCL world
    ``comm.any_rank`` runs a CPU tensor over a gloo group of the world, made
    at the first call and reused after."""
    assert comm.spawn(W.any_rank_host_group, 2, tmp_path / "ranks", timeout=60.0) == [[True, False, True]] * 2
