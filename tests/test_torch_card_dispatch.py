"""Many steps in one dispatch at full width on the card (B16 x HR 128): the
train steps as CUDA graphs (``utils/graphs.py``) against the same steps
eagerly, cuDNN deterministic.

The GAN step (train_explorable_SR.json): a chunk of 4
(``optimize_parameters_chunk``, ``steps_per_dispatch`` 4) across an
``lr_steps`` milestone against 4 eager steps (G, D, Adam moments and
metrics bit for bit, or within the GAN step's bands), 69 / 4 / 2 launches a
replay, a replay's trace holding the kernel events of an eager step; a
chunk with ``D_update_ratio`` 2 (two graphs); a planted fault (the learning
rate a Python float frozen at capture) that the comparison fails. The SR
step (train_RRDB_PSNR.json) in short. The train CLI with
``steps_per_dispatch`` 3 against the per-step run (log rows and
checkpoints). (The Z search: ``test_torch_cuda.py``'s graph tests.)
"""

import json

import pytest
import torch

from esr_tpu_torch import train as train_cli
from esr_tpu_torch.models import create_model
from esr_tpu_torch.models.base_model import Adam
from esr_tpu_torch.options import parse
from torch_card import (EXPECTED_PER_FORWARD, card, counted, gan_grads, hr_batches, per_forward, rel_l2,  # noqa: F401
                        release_memory, run_train, train_csv, train_options, train_state, traced)

CHUNK = 4  # the GAN chunk (steps_per_dispatch 4); lr_steps [3]: it spans a milestone


@pytest.fixture(autouse=True)
def deterministic():
    """Graph against eager, bit for bit: cuDNN's deterministic algorithms."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def dispatch_models(tmp, json_name: str, **train) -> list:
    """Two models from the same seeds on the port's copy of ``json_name``
    (full width, B16 x HR 128); the second runs eagerly."""
    opt = train_options(tmp, "dispatch", json_name, None, niter=8, **train)
    models = [create_model(parse(json.loads(json.dumps(opt)), is_train=True)) for _ in range(2)]
    models[1]._step_graphs.enabled = False
    return models


def train_tensors(model) -> list[tuple[str, torch.Tensor]]:
    """A trainer's weights, buffers and Adam moments, by name."""
    nets = [("G", model.g_module, model.g_opt)]
    if hasattr(model, "d_module"):
        nets.append(("D", model.d_module, model.d_opt))
    out = []
    for tag, net, opt in nets:
        out += [(f"{tag}.{k}", v) for k, v in net.state_dict().items()]
        for key in ("mu", "nu"):
            out += [(f"{tag}.{key}.{i}", t) for i, t in enumerate(getattr(opt, key))]
    return out


def same_training(a, b, start: dict) -> tuple[bool, str]:
    """Two trainers after the same steps: (held, what): bit for bit, or else
    every G weight's update within the GAN step's gradient band of the
    other's (relative L2; D's and the moments within the widest), and the
    last step's metrics within its loss bands."""
    ta, tb = train_tensors(a), train_tensors(b)
    la, lb = a.get_current_losses(), b.get_current_losses()
    if la == lb and all(torch.equal(x, y) for (_, x), (_, y) in zip(ta, tb)):
        return True, "bit for bit"
    bands = gan_grads().bands
    widest = max(bands["grads"].values())
    worst = 0.0
    for (name, x), (_, y) in zip(ta, tb):
        if not x.is_floating_point() or torch.equal(x, y):
            continue
        x0 = start.get(name)
        ux, uy = (x - x0, y - x0) if x0 is not None else (x, y)
        worst = max(worst, rel_l2(ux, uy) / bands["grads"].get(name[2:], widest))
    for k, v in lb.items():
        scale = 1.0 if k in ("D_real", "D_fake") else max(abs(v), 1e-12)
        worst = max(worst, abs(la[k] - v) / scale / bands["losses"].get(k, widest))
    return worst <= 1.0, f"not bit for bit; worst ratio to the bands {worst:.3f}"


def chunk_against_eager(tmp, batches, **train):
    """A graphed chunk of CHUNK steps against CHUNK eager steps from the same
    seeds: (graphed model, eager model, the eager tensors at the start, each
    eager step's launches, the chunk's launches)."""
    graph_m, eager_m = dispatch_models(tmp, "train_explorable_SR.json", **train)
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    per_step = []
    for i in range(CHUNK):
        eager_m.feed_data(batches[i])
        per_step.append(counted(lambda i=i: eager_m.optimize_parameters(i + 1))[1])
    _, chunk = counted(lambda: graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:CHUNK])))
    return graph_m, eager_m, start, per_step, chunk


@pytest.mark.cuda
def test_cuda_gan_chunk_equals_eager_steps(tmp_path):
    """A chunk of 4 across the milestone at 3, replayed as the step's CUDA
    graph, equals 4 eager steps from the same state: G, D, Adam moments and
    the last metrics bit for bit (or within the GAN step's bands). 69 / 4 /
    2 launches an eager step and a replay (the graph's replays add what its
    capture counted), 4 x that a chunk; a profiler trace of one replay holds
    one eager step's kernel events, from graph launches."""
    card()
    batches = hr_batches(CHUNK + 1)
    graph_m, eager_m, start, per_step, chunk = chunk_against_eager(tmp_path, batches, lr_steps=[3])
    held, how = same_training(graph_m, eager_m, start)
    assert held, how
    assert graph_m.step == eager_m.step == CHUNK and len(graph_m._step_graphs.steps) == 1
    assert chunk == per_forward(CHUNK) and all(c == EXPECTED_PER_FORWARD for c in per_step)
    graph_m.feed_data(batches[CHUNK])
    assert counted(lambda: graph_m.optimize_parameters(CHUNK + 1))[1] == EXPECTED_PER_FORWARD
    eager_m.feed_data(batches[CHUNK])
    steps = iter(range(CHUNK + 2, 10**6))
    k_replay, split = traced(tmp_path, "gan_replay", lambda: graph_m.optimize_parameters(next(steps)),
                             lambda: graph_m.optimize_parameters(next(steps)))
    k_eager, _ = traced(tmp_path, "gan_eager", lambda: eager_m.optimize_parameters(next(steps)),
                        lambda: eager_m.optimize_parameters(next(steps)))
    want = {"rdb5c_tc_kernel": EXPECTED_PER_FORWARD["rdb5c"], "conv_tc_kernel": 6}
    assert k_replay == k_eager == want and split["graph_launches"] >= 1, (k_replay, k_eager, split)
    del graph_m, eager_m
    release_memory()


@pytest.mark.cuda
def test_cuda_gan_chunk_with_d_update_ratio(tmp_path):
    """``D_update_ratio`` 2, ``D_init_iters`` 1: G updates at steps 2 and 4
    only, two graphs (G's update skipped / made), equal to eager; Adam
    counts G 2, D 4."""
    card()
    graph_m, eager_m, start, _, _ = chunk_against_eager(tmp_path, hr_batches(CHUNK), D_update_ratio=2,
                                                        D_init_iters=1)
    held, how = same_training(graph_m, eager_m, start)
    assert held, how
    assert len(graph_m._step_graphs.steps) == 2 and graph_m.g_opt.count == 2 and graph_m.d_opt.count == 4


def frozen_lr_adam():
    """The planted fault: Adam's update reads the learning rate as the Python
    float the host computed last, which a CUDA graph freezes at capture."""
    step, rows = Adam.step, Adam.next_scalars

    def next_scalars(self, lr):
        self.host_lr = float(lr)
        return rows(self, lr)

    def frozen_step(self, grads, lr=None, sq_sum=None):
        if lr is not None:
            self.stage(lr)
        keep = [p.clone() for p in self.params]
        step(self, grads, None, sq_sum)  # the update at the staged scalars, then rescaled to host_lr
        with torch.no_grad():
            upd = torch._foreach_sub(keep, self.params)
            torch._foreach_div_(upd, self.scalars[0])
            torch._foreach_add_(keep, upd, alpha=-self.host_lr)
            for p, k in zip(self.params, keep):
                p.copy_(k)

    return {"step": frozen_step, "next_scalars": next_scalars}


@pytest.mark.cuda
def test_cuda_gan_chunk_comparison_fails_a_frozen_learning_rate(tmp_path, monkeypatch):
    """The planted fault, across the milestone: the graphed chunk with Adam's
    learning rate a Python float frozen at capture does not equal the eager
    steps, in the comparison's bands either."""
    card()
    batches = hr_batches(CHUNK)
    graph_m, eager_m = dispatch_models(tmp_path, "train_explorable_SR.json", lr_steps=[3])
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    for i in range(CHUNK):
        eager_m.feed_data(batches[i])
        eager_m.optimize_parameters(i + 1)
    with monkeypatch.context() as mp:
        for k, fn in frozen_lr_adam().items():
            mp.setattr(Adam, k, fn)
        graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:CHUNK]))
    held, how = same_training(graph_m, eager_m, start)
    assert not held, how


@pytest.mark.cuda
def test_cuda_sr_chunk_equals_eager_steps(tmp_path):
    """The SR (PSNR) step: a chunk of 3 as graph replays equals 3 eager
    steps; 3 x 69 / 4 / 2 launches, one replay 69 / 4 / 2."""
    card()
    batches = hr_batches(4)
    graph_m, eager_m = dispatch_models(tmp_path, "train_RRDB_PSNR.json")
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    for i in range(3):
        eager_m.feed_data(batches[i])
        eager_m.optimize_parameters(i + 1)
    _, chunk = counted(lambda: graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:3])))
    held, how = same_training(graph_m, eager_m, start)
    graph_m.feed_data(batches[3])
    _, replay = counted(lambda: graph_m.optimize_parameters(4))
    assert held, how
    assert len(graph_m._step_graphs.steps) == 1 and chunk == per_forward(3) and replay == EXPECTED_PER_FORWARD


@pytest.mark.cuda
def test_cuda_train_cli_steps_per_dispatch(tmp_path):
    """The train CLI with ``steps_per_dispatch`` 3, print_freq 4, save_freq 5
    (5 steps: chunks [1-3], [4], [5]) against the per-step run: the same log
    rows (at 4), checkpoints, and states at 5 bit for bit; 5 x 69 / 4 / 2
    launches each."""
    card()
    runs = {}
    for k in (1, 3):
        root = tmp_path / f"cli_{k}"
        opt = train_options(root, "dispatch_cli", "train_explorable_SR.json", None, niter=5, steps_per_dispatch=k)
        opt["logger"] = {"print_freq": 4, "save_checkpoint_freq": 5}
        _, launches = run_train(root, opt)
        runs[k] = (train_csv(root, "dispatch_cli"),
                   sorted(p.name for p in (root / "experiments" / "dispatch_cli" / "models").iterdir()),
                   train_state(root, "dispatch_cli", 5), launches)
    (rows1, models1, st1, c1), (rows3, models3, st3, c3) = runs[1], runs[3]
    assert rows1 == rows3 and [int(r["step"]) for r in rows3] == [4] and models1 == models3
    assert all(torch.equal(v, st3[n]["net"][key]) for n in ("G", "D") for key, v in st1[n]["net"].items())
    assert c1 == c3 == per_forward(5)
