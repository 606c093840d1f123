"""Entry points of a compile-and-run check (port of ``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn(lr, z)`` is the
CEM-wrapped flagship forward (RRDBNet nf 64, nb 23, gc 32, x4, one Z
channel, bf16 convs on the Hopper kernels, CEM in matmul mode), on seeded
weights, and the example arguments are a B2 x LR 64 input and a zero Z. The
JAX entry runs the folded (``fold=2``) program, a TPU lane layout with no
counterpart here, so there is no fold.

``dryrun_multichip(n)`` runs the multi-device checks of the JAX package's
dry run (``__graft_entry__._dryrun_multichip_impl``) over ``n`` gloo ranks
on the CPU, spawned by ``parallel.comm.spawn``, at G nf 8 / gc 4: a
data-parallel GAN step, the ring-halo spatial forward, the batched spatial
eval (batch over 'data', height over 'spatial'), the GPipe trunk and the
channel-TP trunk (each equal to the whole model's forward), the composed
spatial x TP forward, and two GAN steps through each of ``train_tp``,
``train_pp`` and ``train_spatial``. It raises ``RuntimeError`` with the
ranks' tracebacks when a check fails.

    python -m esr_tpu_torch.graft_entry [N]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry"]

HR, SCALE, NZ = 32, 4, 1  # the dry run's train crop and generator
G_SMALL = {"nf": 8, "gc": 4, "scale": SCALE, "num_latent_channels": NZ}


def entry(device: str | torch.device = "cuda"):
    """``(fn, (lr, z))``: the flagship forward and its example arguments on ``device``."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models import define_G, make_eval_forward

    opt = {"network_G": {"nf": 64, "nb": 23, "gc": 32, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    g = define_G(opt, device=device, seed=0)
    fn = make_eval_forward(g, make_cem(CEMConf(scale=SCALE, inv_mode="matmul"), device=device))
    dev = next(g.parameters()).device
    lr = torch.from_numpy(np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)).to(dev)
    return fn, (lr, torch.zeros((2, 64, 64, NZ), device=dev))


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> None:
    """The dry run over ``n_devices`` (a power of two, at least 2) gloo CPU ranks."""
    from esr_tpu_torch.parallel import comm

    n = int(n_devices)
    if n < 2 or n & (n - 1):
        raise ValueError(f"dryrun_multichip({n}): the meshes need a power of two ranks, at least 2")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        try:
            lines = comm.spawn(_dryrun_rank, n, work, args=(n,), timeout=timeout)
        except (RuntimeError, TimeoutError) as e:
            raise RuntimeError(f"dryrun_multichip({n}) failed:\n{str(e)[-4000:]}") from e
    print(lines[0], flush=True)


def _gan_opt(root: str, nb: int, **parallel) -> dict:
    """The GAN trainer of the JAX dry run: G nf 8 / gc 4, D nf 4, VGG19 to
    conv2_2, vanilla GAN, f32."""
    return {"name": "dryrun", "model": "srragan", "scale": SCALE, "use_cem": True, "bf16": False,
            "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "HR_size": HR, "batch_size": 2}},
            "path": {"root": root},
            "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": nb, "gc": 4, "num_latent_channels": NZ},
            "network_D": {"which_model_D": "discriminator_vgg_128", "nf": 4},
            "train": {"lr_G": 1e-4, "lr_D": 1e-4, "lr_steps": [100], "pixel_weight": 0.01, "feature_weight": 1.0,
                      "gan_weight": 0.005, "range_weight": 1.0, "map_weight": 1.0, "gan_type": "vanilla",
                      "feature_layer": 8, "manual_seed": 0, "watchdog": False},
            **parallel}


def _batch(rows: int, seed: int) -> dict:
    """A fixed train batch: HR in [0, 1], its MATLAB-bicubic LR, Z in [-1, 1]."""
    from esr_tpu_torch.ops.resize import imresize_np

    rng = np.random.default_rng(seed)
    hr = rng.random((rows, HR, HR, 3), dtype=np.float32)
    lr = np.stack([imresize_np(h, scale=1 / SCALE) for h in hr]).astype(np.float32)
    return {"HR": hr, "LR": lr, "Z": rng.uniform(-1, 1, (rows, HR // SCALE, HR // SCALE, NZ)).astype(np.float32)}


def _finite_steps(opt: dict, rows: int, steps: int, what: str) -> None:
    from esr_tpu_torch.parallel.ranks import gan_steps

    eps = [np.zeros((rows, 1, 1, 1), np.float32)] * steps
    res = gan_steps(opt, None, _batch(rows, 1), eps, steps)
    bad = [(i + 1, k, v) for i, m in enumerate(res["metrics"]) for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(f"{what}: non-finite metrics {bad}")


def _lr(shape: tuple, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _close(got: torch.Tensor, want: torch.Tensor, what: str, atol: float = 2e-6) -> None:
    err = (got - want).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: max |sharded - whole| {err:.3g} > {atol}")


def _shape(got: torch.Tensor, want: tuple, what: str) -> None:
    if tuple(got.shape) != want:
        raise AssertionError(f"{what}: output {tuple(got.shape)}, expected {want}")


@torch.no_grad()
def _forwards(n: int) -> None:
    """The sharded forwards of the JAX dry run, on this rank."""
    from esr_tpu_torch.models.architecture import RRDBNet
    from esr_tpu_torch.parallel import (
        make_mesh,
        make_spatial_tp_mesh,
        make_stage_mesh,
        make_tp_mesh,
        pipelined_rrdb_apply,
        spatial_sharded_forward,
        spatial_tp_apply,
        spatial_window_forward,
        tp_rrdb_apply,
    )

    g = RRDBNet(nb=1, **G_SMALL)
    # the ring-halo spatial forward
    fwd = spatial_sharded_forward(g, make_mesh(n, spatial=n), scale=SCALE, halo=4)
    _shape(fwd(_lr((1, 8 * n, 16, 3), 2)), (1, 32 * n, 64, 3), "spatial forward")
    # batched spatial eval: batch over 'data', height over 'spatial', exact-edge windows
    sp = max(n // 2, 1)
    mesh = make_mesh(n, data=n // sp, spatial=sp)
    data = mesh.shape["data"]
    fwd = spatial_window_forward(g, mesh, scale=SCALE, halo=2, data_axis="data" if data > 1 else None)
    _shape(fwd(_lr((data * 2, 8 * sp, 16, 3), 9)), (data * 2, 32 * sp, 64, 3), "batched spatial eval")
    # the GPipe trunk: one block a stage, 4 microbatches
    g = RRDBNet(nb=n, seed=1, **G_SMALL)
    lr = _lr((8, HR // SCALE, HR // SCALE, 3), 3)
    _close(pipelined_rrdb_apply(g, make_stage_mesh(n), n_micro=4)(lr), g(lr), "pipelined trunk")
    # the channel-TP trunk (DP x TP when the world holds two of it); sharding is in place
    tp = min(n, 4)
    tp_data = 2 if n >= 2 * tp else 1
    g = RRDBNet(nb=2, seed=2, **G_SMALL)
    lr = _lr((2 * tp_data, HR // SCALE, HR // SCALE, 3), 4)
    want = g(lr)
    mesh = make_tp_mesh(tp, data=tp_data)
    i = mesh.index("data") if tp_data > 1 else 0
    _close(tp_rrdb_apply(g, mesh)(lr[2 * i : 2 * i + 2]), want[2 * i : 2 * i + 2], "channel-TP trunk")
    # the composed spatial x TP forward
    mesh = make_spatial_tp_mesh(max(n // 4, 1), tp)
    s = mesh.shape["spatial"]
    fwd = spatial_tp_apply(RRDBNet(nb=2, seed=2, **G_SMALL), mesh, halo=4)
    _shape(fwd(_lr((1, 8 * s, 16, 3), 6)), (1, 32 * s, 64, 3), "spatial x TP forward")


def _dryrun_rank(n: int) -> str:
    """Every check of the dry run, on this rank of ``n``."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="dryrun_rank_") as root:
        # the data-parallel GAN step: two rows a rank
        _finite_steps(_gan_opt(root, 1, dist=True), 2 * n, 1, "dist GAN step")
        _forwards(n)
        # GAN training through the model-parallel trunks and the spatial windows
        tp = min(n, 4)
        for what, par in (("train_tp", {"train_tp": tp}), ("train_pp", {"train_pp": 2}),
                          ("train_spatial", {"train_spatial": 2, "train_spatial_halo": 2})):
            _finite_steps(_gan_opt(root, 2, **par), 4, 2, what)
    return (f"dryrun_multichip({n}) OK: GAN DP step + spatial sharded forward + batched spatial eval "
            "(data x spatial windows) + pipelined trunk + channel-TP trunk + composed spatial x TP forward "
            "+ GAN training through TP (DP x 'model'), PP ('stage') and spatial (DP x 'spatial' windows) trunks")


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
