"""Many train steps in one dispatch (the port of the JAX package's
``steps_per_dispatch``), on the CPU.

- ``chunk_limit`` and ``stack_chunk`` equal ``esr_tpu.train``'s, over a
  hypothesis grid and the JAX package's own cases;
- ``optimize_parameters_chunk`` of k steps equals k ``optimize_parameters``
  calls bit for bit (weights, Adam moments and counts, D's statistics, the
  last step's metrics) for the SR and the GAN trainer, across an
  ``lr_steps`` milestone, and with ``D_update_ratio`` 2 and ``D_init_iters``
  1 (G's update skipped in some steps of a chunk);
- the train CLI with ``steps_per_dispatch`` 3 and print / save steps that are
  not multiples of 3 runs the chunks JAX's ``chunk_limit`` predicts, and
  logs and saves at the per-step run's steps with its values; a preemption
  with a chunk pending trains it before the save, and ``--auto_resume``
  continues to the straight run's state;
- the device default of ``parallel.multihost.global_device_array``;
- the graph helper off the card: the same step, eagerly.

Tiny size: nf 8, nb 1, gc 4, HR 32, batch 2, f32 (tests/test_torch_train_helpers.py).
"""

import copy
import csv
import json
import os
import signal

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from esr_tpu.train import chunk_limit as jchunk_limit
from esr_tpu.train import stack_chunk as jstack_chunk
from esr_tpu_torch import train as ptrain
from esr_tpu_torch.models import create_model
from esr_tpu_torch.models.srragan_model import SRRaGANModel
from esr_tpu_torch.models.sr_model import SRModel
from esr_tpu_torch.ops.cuda.lib import LaunchCounter
from esr_tpu_torch.options import parse
from esr_tpu_torch.parallel import make_mesh
from esr_tpu_torch.parallel.multihost import global_device_array
from esr_tpu_torch.utils.graphs import GraphedStep, StepGraphs

from test_torch_train_helpers import N, gan_opt

torch.set_num_threads(1)


# -- chunk_limit / stack_chunk ----------------------------------------------------


def test_chunk_limit_jax_cases():
    """tests/test_train_step.py's cases of JAX's chunk_limit, on the port's."""
    assert ptrain.chunk_limit(0, 4, (20, 0, 100), 1000) == 4
    assert ptrain.chunk_limit(18, 8, (20, 0, 100), 1000) == 2
    assert ptrain.chunk_limit(20, 8, (20, 0, 0), 1000) == 8
    assert ptrain.chunk_limit(998, 8, (0, 0, 0), 1000) == 2
    assert ptrain.chunk_limit(999, 8, (1, 0, 0), 1000) == 1


@settings(max_examples=300, deadline=None)
@given(step=st.integers(0, 500), k=st.integers(1, 16),
       freqs=st.tuples(*[st.one_of(st.none(), st.integers(0, 40))] * 3), extra=st.integers(0, 60))
def test_chunk_limit_matches_jax(step, k, freqs, extra):
    niter = step + extra
    assert ptrain.chunk_limit(step, k, freqs, niter) == jchunk_limit(step, k, freqs, niter)


@settings(max_examples=40, deadline=None)
@given(k=st.integers(1, 5), n=st.integers(1, 3), with_paths=st.booleans())
def test_stack_chunk_matches_jax(k, n, with_paths):
    rng = np.random.default_rng(k * 10 + n)
    batches = [{"HR": rng.random((n, 4, 4, 3)).astype(np.float32)} for _ in range(k)]
    if with_paths:
        for i, b in enumerate(batches):
            b["HR_path"] = [f"img{i}_{j}.png" for j in range(n)]
    got, want = ptrain.stack_chunk(batches), jstack_chunk(batches)
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]


# -- optimize_parameters_chunk == per-step calls -------------------------------------------------


def _batches(k: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"HR": (rng.random((N, 32, 32, 3)) * 255).astype(np.uint8)} for _ in range(k)]


def _snapshot(model) -> dict:
    nets = {"G": (model.g_module, model.g_opt)}
    if isinstance(model, SRRaGANModel):
        nets["D"] = (model.d_module, model.d_opt)
    out = {"step": model.step, "losses": model.get_current_losses()}
    for key, (net, opt) in nets.items():
        out[key] = {k: v.clone() for k, v in net.state_dict().items()}
        out[key + "_opt"] = {"count": opt.count, "mu": [t.clone() for t in opt.mu], "nu": [t.clone() for t in opt.nu]}
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a["step"] == b["step"] and a["losses"] == b["losses"]
    for key in a:
        if key in ("step", "losses"):
            continue
        if key.endswith("_opt"):
            assert a[key]["count"] == b[key]["count"]
            assert all(torch.equal(x, y) for x, y in zip(a[key]["mu"] + a[key]["nu"], b[key]["mu"] + b[key]["nu"]))
        else:
            assert all(torch.equal(v, b[key][k]) for k, v in a[key].items()), key


def _model(opt: dict):
    return create_model(parse(copy.deepcopy(opt), is_train=True), device="cpu")


def _sr_opt(root: str) -> dict:
    opt = gan_opt(root, lr_steps=[2], pixel_weight=1.0, lr_G=2e-4)
    opt.update(model="sr", name="chunk_sr")
    return opt


CASES = {
    "sr": (_sr_opt, [(1, 3)]),
    "gan": (lambda r: gan_opt(r), [(1, 3)]),
    # chunks 2-4 and 5-6 straddle the milestone at 3 (G's LR read at the global step, D's at its count)
    "gan_lr_milestone": (lambda r: gan_opt(r, lr_steps=[3]), [(1, 1), (2, 3), (5, 2)]),
    # G updates at steps 2 and 4 only (step % 2 == 0 and step > 1): a chunk mixes both graphs' keys
    "gan_d_ratio_2": (lambda r: gan_opt(r, D_update_ratio=2, D_init_iters=1), [(1, 4)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_equals_per_step(tmp_path, case):
    """The chunks of ``CASES[case]`` (first step, length) against the same
    steps one ``optimize_parameters`` call at a time from the same seeds:
    bit for bit, with the last step's metrics reported."""
    make_opt, chunks = CASES[case]
    opt = make_opt(str(tmp_path))
    n = sum(k for _, k in chunks)
    batches = _batches(n)
    per_step, chunked = _model(opt), _model(opt)
    for i, b in enumerate(batches):
        per_step.feed_data(b)
        per_step.optimize_parameters(i + 1)
    for first, k in chunks:
        chunked.optimize_parameters_chunk(first, ptrain.stack_chunk(batches[first - 1 : first - 1 + k]))
    _assert_same(_snapshot(per_step), _snapshot(chunked))
    if case == "gan_d_ratio_2":
        assert chunked.g_opt.count == 2 and chunked.d_opt.count == 4


def test_chunk_reports_the_last_step():
    """``get_current_losses`` after a chunk: its last step's metrics (a
    chunk of 3 against its first 2 steps alone and then the third)."""
    opt = gan_opt("unused")
    batches = _batches(3)
    a, b = _model(opt), _model(opt)
    a.optimize_parameters_chunk(1, ptrain.stack_chunk(batches))
    b.optimize_parameters_chunk(1, ptrain.stack_chunk(batches[:2]))
    first_two = b.get_current_losses()
    b.feed_data(batches[2])
    b.optimize_parameters(3)
    assert a.get_current_losses() == b.get_current_losses() != first_two
    assert a.step == 3 and a.get_current_learning_rate() == b.get_current_learning_rate()


# -- the train CLI -----------------------------------------------------------------------


def _cli_opt(root, niter=11, k=1):
    opt = gan_opt(str(root), niter=niter, val_freq=5, steps_per_dispatch=k)
    opt["datasets"]["train"].update(n_images=5, image_size=40)
    opt["datasets"]["val"] = {"name": "val", "mode": "SYNTHETIC", "n_images": 1, "image_size": 32}
    opt["logger"] = {"print_freq": 4, "save_checkpoint_freq": 5}
    return opt


def _run_cli(root, opt, *flags):
    path = os.path.join(str(root), f"{opt['name']}.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    ptrain.main(["-opt", path, "--device", "cpu", *flags])


def _exp(root):
    return os.path.join(str(root), "experiments", "train_parity")


def _csv(root):
    with open(os.path.join(_exp(root), "train_metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _state(root, label):
    return torch.load(os.path.join(_exp(root), "training_state", f"{label}.state"), weights_only=True)


def _same_state(a: dict, b: dict) -> None:
    assert a["iter"] == b["iter"] and a["epoch"] == b["epoch"]
    for net in ("G", "D"):
        for k, v in a[net]["net"].items():
            assert torch.equal(v, b[net]["net"][k]), (net, k)
        assert a[net]["opt"]["count"] == b[net]["opt"]["count"]
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(a[net]["opt"][key], b[net]["opt"][key]))


def _jax_chunks(niter: int, k: int, freqs) -> list[tuple[int, int]]:
    """(first step, length) of each chunk the JAX loop runs."""
    out, step = [], 0
    while step < niter:
        n = jchunk_limit(step, k, freqs, niter)
        out.append((step + 1, n))
        step += n
    return out


@pytest.fixture(scope="module")
def per_step_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("per_step")
    _run_cli(root, _cli_opt(root))
    return root


def _recording(monkeypatch) -> list:
    """The chunks the loop runs, as (first step, length); plain steps as length 1."""
    ran = []
    chunk, single = SRRaGANModel.optimize_parameters_chunk, SRRaGANModel.optimize_parameters

    def rec_chunk(self, first, batches):
        ran.append((first, len(batches["HR"])))
        chunk(self, first, batches)

    def rec_single(self, step):
        ran.append((step, 1))
        single(self, step)

    monkeypatch.setattr(SRRaGANModel, "optimize_parameters_chunk", rec_chunk)
    monkeypatch.setattr(SRRaGANModel, "optimize_parameters", rec_single)
    return ran


def test_train_cli_chunks_keep_the_cadence(per_step_run, tmp_path, monkeypatch):
    """steps_per_dispatch 3, print every 4, save and validate every 5, 11
    steps: the chunks JAX's chunk_limit predicts ([1-3], [4], [5], [6-8],
    [9-10], [11]), the log rows at 4 and 8 and the checkpoints at 5 and 10
    of the per-step run, with its values."""
    ran = _recording(monkeypatch)
    _run_cli(tmp_path, _cli_opt(tmp_path, k=3))
    assert ran == _jax_chunks(11, 3, (4, 5, 5)) == [(1, 3), (4, 1), (5, 1), (6, 3), (9, 2), (11, 1)]
    assert [int(r["step"]) for r in _csv(tmp_path)] == [4, 8]
    assert _csv(tmp_path) == _csv(per_step_run)
    for label in (5, 10, 11):
        _same_state(_state(tmp_path, label), _state(per_step_run, label))
    assert sorted(os.listdir(os.path.join(_exp(tmp_path), "training_state"))) == ["10.state", "11.state", "5.state"]


def test_train_cli_preemption_flushes_the_pending_chunk(per_step_run, tmp_path, monkeypatch):
    """SIGTERM as the train loader hands out step 8's batch, while the chunk
    of steps 6-8 is gathering: the batches already taken in (6 and 7) are
    trained before the save at 7, and ``--auto_resume`` (step 8 alone, then
    the chunks to 11) ends in the per-step run's state."""
    from esr_tpu_torch.data import DataLoader

    ran = _recording(monkeypatch)
    iterate, drawn = DataLoader.__iter__, []

    def preempting(self):
        for b in iterate(self):
            if len(b["HR"]) == N:  # the train loader's (validation takes one image)
                drawn.append(1)
                if len(drawn) == 8:
                    os.kill(os.getpid(), signal.SIGTERM)
            yield b

    monkeypatch.setattr(DataLoader, "__iter__", preempting)
    _run_cli(tmp_path, _cli_opt(tmp_path, k=3))
    assert ran == [(1, 3), (4, 1), (5, 1), (6, 2)]
    assert sorted(os.listdir(os.path.join(_exp(tmp_path), "training_state"))) == ["5.state", "7.state"]
    monkeypatch.setattr(DataLoader, "__iter__", iterate)
    ran.clear()
    _run_cli(tmp_path, _cli_opt(tmp_path, k=3), "--auto_resume")
    assert ran == [(8, 1), (9, 2), (11, 1)]
    for label in (10, 11):
        _same_state(_state(tmp_path, label), _state(per_step_run, label))


# -- the multihost device default --------------------------------------------------------


def test_global_device_array_defaults_to_the_gpu(monkeypatch):
    """Without a device, the rows go to this rank's GPU: with no CUDA that
    raises resolve_device's error, and no CPU tensor comes back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        global_device_array({"HR": np.ones((2, 4, 4, 3), np.float32)}, make_mesh())
    got = global_device_array(np.ones((2, 4, 4, 3), np.float32), make_mesh(), device="cpu")
    assert got.device.type == "cpu"


# -- the graph helper off the card -------------------------------------------------------


def test_graph_helpers_run_eagerly_off_the_card():
    """On the CPU, GraphedStep and StepGraphs call the step every time (no
    capture, no launch counts added) with the inputs as given."""
    calls = []
    counter = LaunchCounter("test_counter")

    def fn(key, x, y=None):
        calls.append((key, y))
        counter.count += 1
        return x * 2

    graphs = StepGraphs(fn, torch.device("cpu"), "test")
    for i in range(3):
        assert torch.equal(graphs.run("k", {"x": torch.full((2,), float(i))}), torch.full((2,), 2.0 * i))
    assert calls == [("k", None)] * 3 and counter.count == 3 and graphs.steps == []
    step = GraphedStep(lambda: fn("g", torch.ones(1)), "cpu", "test")
    assert not step.enabled and torch.equal(step(), torch.full((1,), 2.0)) and step.graph is None
    LaunchCounter.all.remove(counter)


def test_models_graph_only_on_cuda_in_one_process(tmp_path):
    """A model's train step graphs are off on the CPU (eager, the same code)."""
    for opt in (gan_opt(str(tmp_path)), _sr_opt(str(tmp_path))):
        model = _model(opt)
        assert isinstance(model, SRModel) and not model._step_graphs.enabled
