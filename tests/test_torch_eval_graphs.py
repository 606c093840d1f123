"""The eval forward as one CUDA graph per input shape (``models/base_model.
EvalForward``), on the CPU.

- On the CPU ``make_eval_forward`` runs eagerly, as before, and still
  matches the JAX package's ``_make_forward`` on ``rrdb_to_torch`` weights
  (f32, with and without Z).
- Through a stand-in for capture and replay (tests/torch_fake_graphs.py):
  one graph per shape of ``lr`` and ``z`` (``z`` None a shape of its own);
  the generator's layout generation (``prepare_kernels`` /
  ``release_kernels``) drops the graphs; each call returns a tensor that
  the next call does not overwrite.
- The explorer renders through a forward of its own, not the callable its Z
  search captures; new generator weights drop the render's graphs.
- A trainer's validation forward is built eagerly.

Tiny size: nf 16, nb 2, gc 8, x4, one Z channel, f32.
"""

import jax
import numpy as np
import pytest
import torch

import torch_fake_graphs
from esr_tpu.models import create_model as jcreate_model
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu.options import parse as jparse
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.explore.session import ExplorationSession
from esr_tpu_torch.models import base_model, create_model, define_G, make_eval_forward
from esr_tpu_torch.models.base_model import EvalForward
from esr_tpu_torch.options import parse

torch.set_num_threads(1)

NET = {"which_model_G": "RRDB_net", "nf": 16, "nb": 2, "gc": 8, "in_nc": 3, "out_nc": 3,
       "num_latent_channels": 1, "latent_input": "first_layer", "fold": 1}


def _jax_opt(root: str) -> dict:
    return {"name": "eval_graphs", "model": "srragan", "scale": 4, "use_cem": True, "bf16": False,
            "path": {"root": root}, "train": {"manual_seed": 0}, "network_G": dict(NET),
            "datasets": {"test_1": {"name": "syn", "mode": "SYNTHETIC", "n_images": 1, "image_size": 32}}}


def _small(seed: int = 0):
    g = define_G({"network_G": dict(NET), "scale": 4, "bf16": False}, device="cpu", seed=seed)
    return g, make_cem(CEMConf(scale=4), device="cpu")


def _lr(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


@pytest.mark.parametrize("with_z", [True, False], ids=["z", "z_none"])
def test_eval_forward_matches_jax_make_forward(tmp_path, with_z):
    """make_eval_forward on the CPU: no graphs, the eager composition
    cem.project(g(lr, z), lr) bit for bit, and JAX's jitted _make_forward on
    the same weights (rrdb_to_torch) to 1e-4; z None is zeros Z."""
    jmodel = jcreate_model(jparse(_jax_opt(str(tmp_path)), is_train=False))
    params = (getattr(jmodel, "g_state", None) or jmodel.state).params
    g, cem = _small()
    g.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in rrdb_to_torch(jax.device_get(params)).items()},
                      strict=True)
    lr = _lr((2, 12, 10, 3), 1)
    z = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 12, 10, 1)).astype(np.float32))
    fwd = make_eval_forward(g, cem)
    assert isinstance(fwd, EvalForward) and not fwd.graphs.enabled
    got = fwd(lr, z if with_z else None)
    with torch.no_grad():
        assert torch.equal(got, cem.project(g(lr, z if with_z else None), lr))
    want = np.asarray(jmodel._forward(params, lr.numpy(), (z if with_z else torch.zeros_like(z)).numpy()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert fwd.graphs.steps == []


def test_one_graph_per_shape_and_the_layout_generation(monkeypatch):
    """With graphs on (the stand-in): one capture per (lr shape, z shape or
    None), replays after; prepare_kernels and release_kernels each move the
    layout generation, and the next call drops every graph and captures
    anew; each answer equals the eager forward's."""
    captured = torch_fake_graphs.install(monkeypatch)
    g, cem = _small()
    fwd = make_eval_forward(g, cem)
    fwd.graphs.enabled = True
    eager = make_eval_forward(g, cem, graphs=False)
    lr_a, lr_b = _lr((1, 8, 8, 3), 3), _lr((1, 8, 12, 3), 4)
    z_a = torch.zeros(1, 8, 8, 1)
    for lr, z in ((lr_a, None), (lr_a, None), (lr_a, z_a), (lr_b, None), (lr_a, z_a)):
        assert torch.equal(fwd(lr, z), eager(lr, z))
    assert len(captured) == 3 and len(fwd.graphs.steps) == 3
    for change in (g.prepare_kernels, g.release_kernels):
        gen = g.layout_generation
        change()
        assert g.layout_generation == gen + 1
        assert torch.equal(fwd(lr_a, None), eager(lr_a, None))
        assert len(fwd.graphs.steps) == 1 and fwd.graphs.steps[0] is captured[-1] and fwd.generation == gen + 1
    assert len(captured) == 5


def test_answer_is_not_overwritten_by_the_next_call(monkeypatch):
    """A replay writes the graph's static output in place; the forward
    returns a copy, so an answer kept past the next call stays as it was
    (SRModel.test keeps sr[0] in its visuals)."""
    torch_fake_graphs.install(monkeypatch)
    g, cem = _small()
    fwd = make_eval_forward(g, cem)
    fwd.graphs.enabled = True
    first = fwd(_lr((1, 8, 8, 3), 5))  # the capture's warm-up answer
    second = fwd(_lr((1, 8, 8, 3), 6))  # a replay
    keep = second.clone()
    third = fwd(_lr((1, 8, 8, 3), 7))  # the next replay
    (step,) = fwd.graphs.steps
    assert torch.equal(step.out, third) and step.out.data_ptr() != third.data_ptr()
    assert torch.equal(second, keep) and not torch.equal(second, third) and not torch.equal(first, second)


def test_explorer_renders_through_its_own_forward(monkeypatch):
    """The session's render is an EvalForward; its Z search captures
    session.forward, another callable (captures do not nest). The render
    equals session.forward without grad bit for bit; new generator weights
    drop the render's graphs and render from the new weights."""
    torch_fake_graphs.install(monkeypatch)
    g, cem = _small()
    lr = np.random.default_rng(8).random((12, 12, 3)).astype(np.float32)
    sess = ExplorationSession(g, cem, lr, num_latent_channels=1, n_steps=2)
    assert isinstance(sess._render, EvalForward) and sess._render is not sess.forward
    assert sess._optimizer.forward == sess.forward and sess._optimizer.forward != sess._render
    sess._render.graphs.enabled = True
    sr = sess.current_sr()
    with torch.no_grad():
        want = sess.forward(torch.from_numpy(lr)[None], torch.zeros(1, 12, 12, 1)).numpy()
    np.testing.assert_array_equal(sr, want)
    sess.current_sr(np.zeros_like(sess.z))
    assert len(sess._render.graphs.steps) == 1
    sess.smooth()
    g2, _ = _small(seed=5)
    sess.set_generator_weights(g2.state_dict())
    assert sess._render.graphs.steps == []
    with torch.no_grad():
        want2 = cem.project(g2(torch.from_numpy(lr)[None], torch.from_numpy(sess.z)), torch.from_numpy(lr)[None])
    np.testing.assert_array_equal(sess.current_sr(), want2.numpy())


def test_trainer_validation_forward_is_eager(tmp_path, monkeypatch):
    """A trainer's test() builds its forward with graphs off (the weights
    change before the next validation); an eval model keeps one graphed
    forward."""
    seen = []
    init = EvalForward.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append(args[4] if len(args) > 4 else kwargs.get("graphs", True))

    monkeypatch.setattr(base_model.EvalForward, "__init__", record)
    opt = _jax_opt(str(tmp_path))
    opt.update(model="sr", datasets={"train": {"name": "syn", "mode": "SYNTHETIC", "HR_size": 32, "batch_size": 2,
                                               "n_images": 2}},
               train={"manual_seed": 0, "lr_G": 1e-4, "watchdog": False})
    model = create_model(parse(opt, is_train=True), device="cpu")
    model.feed_data({"LR": np.random.default_rng(9).random((8, 8, 3)).astype(np.float32)})
    model.test()
    assert seen == [False]
    eval_opt = _jax_opt(str(tmp_path))
    eval_opt.pop("datasets")
    create_model(parse(dict(eval_opt, datasets={}), is_train=False), device="cpu")
    assert seen == [False, True]
