"""The port's generator variants against the JAX package's, on the CPU in
f32: ``RRDBNet`` with ``latent_input='all_layers'`` (Z re-injected before
every RRDB through a 1x1 ``latent_proj``; the scan and the unrolled JAX
layouts) and ``SRResNet`` (x4 and x3, pixel-shuffle upsampling), on weights
carried over by the bridges. Forwards within 1e-4 at nf 8-16. One step of
the SR (PSNR) trainer for each generator, and one whose training LR the CEM
operator of a 2-D kernel synthesises, against JAX's step: the metrics at
rel 1e-4, the gradients at rel L2 1e-3 and the parameters by
``check_param_change`` (tests/test_torch_train_helpers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.data.pipeline import make_train_pipeline as jmake_train_pipeline
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.architecture import SRResNet as JSRResNet
from esr_tpu.models.architecture import pixel_shuffle as jpixel_shuffle
from esr_tpu.models.base_model import TrainState, make_adam, multistep_schedule
from esr_tpu.models.base_model import step_keyed as jstep_keyed
from esr_tpu.models.networks import define_G as jdefine_G
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu.models.sr_model import make_sr_train_step as jmake_sr_train_step
from esr_tpu.scripts.blind_bench import gaussian_kernel
from esr_tpu_torch.models import (
    RRDBNet,
    SRResNet,
    create_model,
    define_G,
    make_eval_forward,
    srresnet_state_dict_from_jax,
    state_dict_from_jax,
)
from esr_tpu_torch.models.base_model import step_keyed
from esr_tpu_torch.models.blocks import pixel_shuffle
from esr_tpu_torch.models.sr_model import make_sr_train_step
from esr_tpu_torch.options import parse

from test_torch_train_helpers import RecordingAdam, check_metrics, check_param_change, deep, fixed_batch, gan_opt, rel_l2

torch.set_num_threads(1)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(seed, nz, shape=(2, 10, 12)):
    rng = np.random.default_rng(seed)
    lr = rng.random(shape + (3,)).astype(np.float32)
    z = rng.uniform(-1, 1, shape + (nz,)).astype(np.float32) if nz else None
    return lr, z


def _jax_all_layers(scan: bool, nf=16, nb=2, gc=8):
    model = JRRDBNet(nf=nf, nb=nb, gc=gc, scale=4, num_latent_channels=1, latent_input="all_layers",
                     scan_blocks=scan)
    return model, model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_all_layers_forward_matches_jax(layout):
    model, variables = _jax_all_layers(layout == "scan")
    lr, z = _inputs(0, 1)
    want = np.asarray(model.apply(variables, jnp.asarray(lr), jnp.asarray(z)))
    net = RRDBNet(nf=16, nb=2, gc=8, scale=4, num_latent_channels=1, latent_input="all_layers")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net(_t(lr), _t(z))
        zeros = net(_t(lr))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want0 = np.asarray(model.apply(variables, jnp.asarray(lr), None))
    np.testing.assert_allclose(zeros.numpy(), want0, atol=ATOL)  # Z None: zeros at every injection


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_all_layers_bridge_equals_rrdb_to_torch(layout):
    """state_dict_from_jax == rrdb_to_torch key for key (``latent_proj.{i}``)
    and value for value; rrdb_to_torch's output loads with strict=True."""
    _, variables = _jax_all_layers(layout == "scan", nf=8, nb=3, gc=4)
    ours, ref = state_dict_from_jax(variables), rrdb_to_torch(variables)
    assert set(ours) == set(ref) and {f"latent_proj.{i}.weight" for i in range(3)} <= set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    net = RRDBNet(nf=8, nb=3, gc=4, scale=4, num_latent_channels=1, latent_input="all_layers")
    assert set(net.state_dict()) == set(ref)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, strict=True)


@pytest.mark.parametrize("scale,nz", [(4, 1), (3, 0)], ids=["x4_nz1", "x3_nz0"])
def test_srresnet_forward_matches_jax(scale, nz):
    model = JSRResNet(nf=16, nb=2, scale=scale, num_latent_channels=nz)
    args = (jnp.zeros((1, 8, 8, 3)),) + ((jnp.zeros((1, 8, 8, nz)),) if nz else ())
    variables = model.init(jax.random.PRNGKey(scale), *args)
    lr, z = _inputs(scale, nz)
    want = np.asarray(model.apply(variables, jnp.asarray(lr), None if z is None else jnp.asarray(z)))
    net = SRResNet(nf=16, nb=2, scale=scale, num_latent_channels=nz)
    sd = srresnet_state_dict_from_jax(variables)
    assert set(sd) == set(net.state_dict()) and "block1.conv2.weight" in sd and "upconv1.bias" in sd
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(_t(lr), None if z is None else _t(z))
    assert tuple(got.shape) == want.shape == (2, 10 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_equals_torch_and_jax(r):
    x = np.random.default_rng(r).standard_normal((2, 5, 7, 3 * r * r)).astype(np.float32)
    got = pixel_shuffle(_t(x), r)
    want = torch.pixel_shuffle(_t(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpixel_shuffle(jnp.asarray(x), r)))


def test_define_g_builds_the_variants():
    """define_G: sr_resnet / srresnet / msrresnet -> SRResNet (JAX's nb 16 by
    default), all_layers -> one latent_proj per RRDB (none without Z);
    bf16 unless ``bf16`` is false; an unknown latent_input raises."""
    for which in ("sr_resnet", "SRResNet", "msrresnet"):
        g = define_G({"network_G": {"which_model_G": which, "nf": 8}, "scale": 4}, device="cpu")
        assert isinstance(g, SRResNet) and g.nb == 16 and g.dtype == torch.bfloat16 and not g.training
        assert isinstance(jdefine_G({"network_G": {"which_model_G": which}}), JSRResNet)
    opt = {"network_G": {"nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1, "latent_input": "all_layers"},
           "scale": 4, "bf16": False}
    g = define_G(opt, device="cpu")
    assert g.all_layers and len(g.latent_proj) == 2 and g.latent_proj[0].weight.shape == (8, 9, 1, 1)
    g0 = define_G(dict(opt, network_G=dict(opt["network_G"], num_latent_channels=0)), device="cpu")
    assert not g0.all_layers and not hasattr(g0, "latent_proj")
    with pytest.raises(ValueError, match="latent_input"):
        define_G(dict(opt, network_G=dict(opt["network_G"], latent_input="middle")), device="cpu")


@pytest.mark.parametrize("which", ["sr_resnet", "all_layers"])
def test_variants_through_the_eval_surface(which):
    """make_eval_forward (prepare_kernels: nothing to build on the CPU) with a
    2-D-kernel CEM; release_kernels; bf16 within bf16 rounding of f32."""
    from esr_tpu_torch.cem import CEMConf, make_cem

    net_g = ({"which_model_G": "sr_resnet", "nf": 8, "nb": 2, "num_latent_channels": 1} if which == "sr_resnet"
             else {"nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1, "latent_input": "all_layers"})
    g32 = define_G({"network_G": net_g, "scale": 4, "bf16": False}, device="cpu", seed=2)
    g16 = define_G({"network_G": net_g, "scale": 4}, device="cpu", seed=2)
    cem = make_cem(CEMConf(scale=4, kernel=tuple(map(tuple, gaussian_kernel(sup=9)))), device="cpu")
    lr, z = (torch.from_numpy(a) for a in _inputs(5, 1, (1, 8, 6)))
    out32 = make_eval_forward(g32, cem)(lr, z)
    assert all(m.kernel_weights is None for m in g32.modules() if hasattr(m, "prepare_kernel"))
    g32.release_kernels()
    assert cem._mode == "fft" and (cem.downsample(out32) - lr).abs().max().item() <= 1e-5
    with torch.no_grad():
        a, b = g16(lr, z), g32(lr, z)
    assert a.dtype == torch.float32 and (a - b).abs().max().item() < 0.05


def _sr_opt(tmp, net_g: dict, kernel=None) -> dict:
    opt = gan_opt(tmp, lr_G=2e-4, lr_steps=[], pixel_weight=1.0)
    opt.update(model="sr", use_cem=False)
    opt["network_G"] = dict(net_g, fold=1)
    if kernel is not None:  # the 2-D kernel synthesises the training LR; no augmentation, no Z
        opt["kernel"] = np.asarray(kernel).tolist()
        opt["datasets"]["train"].update(use_flip=False, use_rot=False)
    return opt


def _jax_g(opt):
    jg = jdefine_G(opt)
    nz = jg.num_latent_channels
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, nz)) if nz else None)
    return jg, params["params"]


def _bridge(opt, params):
    which = opt["network_G"].get("which_model_G", "RRDB_net").lower()
    fn = srresnet_state_dict_from_jax if which == "sr_resnet" else state_dict_from_jax
    return fn(jax.device_get(params))


@pytest.mark.parametrize("which", ["sr_resnet", "all_layers"])
def test_sr_trainer_step_matches_jax(tmp_path, which):
    """One SR-trainer step of each generator on a fixed batch with Z."""
    net_g = ({"which_model_G": "sr_resnet", "nf": 8, "nb": 2, "num_latent_channels": 1} if which == "sr_resnet"
             else {"which_model_G": "RRDB_net", "nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1,
                   "latent_input": "all_layers"})
    opt = _sr_opt(str(tmp_path), net_g)
    jg, params = _jax_g(opt)
    batch = fixed_batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = TrainState.create(apply_fn=jg.apply, params=params,
                              tx=make_adam(jstep_keyed(multistep_schedule(2e-4, [], 0.5))))
    grad = jax.grad(lambda p: jnp.mean(jnp.abs(jg.apply({"params": p}, jb["LR"], jb["Z"]) - jb["HR"])))(params)
    state, m = jax.jit(jmake_sr_train_step(jg, lambda h, r: jb, "l1", 1.0))(state, jnp.zeros(()),
                                                                          jax.random.PRNGKey(1))
    model = create_model(parse(deep(opt), is_train=True), device="cpu")
    model.g_module.load_state_dict(_bridge(opt, params), strict=True)
    g_opt = RecordingAdam(model.g_opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pm = make_sr_train_step(model.g_module, lambda h, g: tb, g_opt, step_keyed(model.schedulers["G"]))(
        None, torch.Generator())
    check_metrics([{k: float(v) for k, v in jax.device_get(m).items()}], [{k: float(v) for k, v in pm.items()}])
    want = _bridge(opt, grad)
    for (name, _), g in zip(model.g_module.named_parameters(), g_opt.grads[0]):
        assert rel_l2(g.numpy(), want[name]) <= 1e-3, name
    check_param_change(_bridge(opt, params), _bridge(opt, state.params), model.g_module.state_dict(), 2e-4, 1)


def test_sr_trainer_step_under_a_2d_kernel_matches_jax(tmp_path):
    """A 2-D ``kernel`` option: the port's trainer synthesises the training LR
    with its CEM operator's depthwise ``downsample`` (fft-mode CEM), as
    JAX's pipeline does with ``downsample_fn``; one step through the
    model's own pipeline on the same HR batch."""
    k = gaussian_kernel(sup=9, sx=1.5, sy=1.0, theta=0.3)
    opt = _sr_opt(str(tmp_path), {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 0},
                  kernel=k)
    jg, params = _jax_g(opt)
    jcem = jmake_cem(JCEMConf(scale=4, kernel=tuple(map(tuple, k))))
    pipe = jmake_train_pipeline(scale=4, use_flip=False, use_rot=False, downsample_fn=jcem.downsample)
    hr = np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32)
    state = TrainState.create(apply_fn=jg.apply, params=params,
                              tx=make_adam(jstep_keyed(multistep_schedule(2e-4, [], 0.5))))
    state, m = jax.jit(jmake_sr_train_step(jg, pipe, "l1", 1.0))(state, jnp.asarray(hr), jax.random.PRNGKey(1))
    model = create_model(parse(deep(opt), is_train=True), device="cpu")
    assert model._lr_synth is not None and model._lr_synth._mode == "fft" and model.cem is None
    model.g_module.load_state_dict(_bridge(opt, params), strict=True)
    model.feed_data({"HR": hr})
    model.optimize_parameters(1)
    check_metrics([{k: float(v) for k, v in jax.device_get(m).items()}], [model.get_current_losses()])
    check_param_change(_bridge(opt, params), _bridge(opt, state.params), model.g_module.state_dict(), 2e-4, 1)
    lr = pipe(jnp.asarray(hr), jax.random.PRNGKey(0))["LR"]
    np.testing.assert_allclose(model._lr_synth.downsample(torch.from_numpy(hr)).numpy(), np.asarray(lr), atol=1e-5)


@pytest.mark.parametrize("which", ["sr_resnet", "all_layers"])
def test_gan_trainer_under_a_2d_kernel(tmp_path, which):
    """The port of tests/test_train_step.py::test_custom_kernel_training with a
    2-D kernel and each new generator: the GAN trainer's CEM and its training
    LR synthesis are one fft-mode operator, as in the JAX model; one step
    from an HR batch gives finite losses."""
    from esr_tpu.models import create_model as jcreate_model

    net_g = ({"which_model_G": "sr_resnet", "nf": 8, "nb": 2, "num_latent_channels": 1} if which == "sr_resnet"
             else {"nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1, "latent_input": "all_layers"})
    opt = gan_opt(str(tmp_path))
    opt["network_G"] = dict(net_g, fold=1)
    opt["kernel"] = gaussian_kernel(sup=9, sx=1.5, sy=1.0, theta=0.3).tolist()
    model = create_model(parse(deep(opt), is_train=True), device="cpu")
    jmodel = jcreate_model(parse(deep(opt), is_train=True))
    assert model.cem._mode == jmodel.cem._mode == "fft" and model._lr_synth is model.cem
    model.feed_data({"HR": fixed_batch(9)["HR"]})
    model.optimize_parameters(1)
    assert np.isfinite(list(model.get_current_losses().values())).all()
