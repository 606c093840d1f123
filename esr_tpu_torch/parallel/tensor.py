"""Tensor parallelism (channel sharding) of the RRDB trunk (port of
esr_tpu/parallel/tensor.py).

Every RDB conv is row-parallel: each rank of the 'model' axis holds a
contiguous slice of the conv's input channels (its Cin slice, 1/T of the
kernel, and so 1/T of its Adam moments), convolves that slice of the
replicated features and the ranks sum the partial outputs (``all_reduce``);
bias and LeakyReLU come after the sum. Row-parallel because the dense block
concatenates every earlier feature: the concat stays a local slice of
replicated activations, and the only collectives are the five sums per RDB.
Activations are not sharded (use the spatial axis for that, or
:func:`spatial_tp_apply` for both). The ``all_layers`` 1x1 ``latent_proj``
stays replicated (its Cin is not generally divisible by T), and so do the
pre- and post-trunk layers.

Each partial conv runs the ``conv3x3`` kernel (``kpack_conv3x3`` without
bias or activation; at T = 2 the flagship's slices are Cin 32 to 96). An RDB
then launches no ``rdb5c`` kernel: the fused block needs every input channel.

The sharding is done in place on the generator (:func:`shard_trunk`): each
RDB conv's weight becomes its slice and the RDB (``blocks.py``) hands its
forward and its kernel layouts to :class:`RowParallelRDB`. The sum's backward
is the identity (every rank computes the same loss, so each partial's
gradient is the output's gradient), and the replicated features each rank
slices get the sum of the ranks' gradients (``comm.fan_out``): the gradients
equal the single-device ones, not T times them. Checkpoints stay the
reference's strict state dicts: :func:`full_state_dict` gathers the slices,
:func:`load_full_state_dict` cuts them again.
"""

from __future__ import annotations

import torch
from torch import nn

from esr_tpu_torch.models.blocks import _frozen_layout, lrelu
from esr_tpu_torch.ops.cuda.autograd import conv3x3_fn
from esr_tpu_torch.ops.cuda.kpack_conv import conv_kernel_weights, conv_launch, kpack_conv3x3
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.common import check_trunk_parallel_model
from esr_tpu_torch.parallel.mesh import make_spatial_tp_mesh, make_tp_mesh
from esr_tpu_torch.parallel.spatial import spatial_window_forward

__all__ = [
    "RowParallelRDB",
    "full_param_tensors",
    "full_state_dict",
    "load_full_state_dict",
    "local_param_tensors",
    "make_spatial_tp_mesh",
    "make_tp_mesh",
    "shard_trunk",
    "sharded_names",
    "spatial_tp_apply",
    "tp_rrdb_apply",
    "tp_trunk",
]


def _partial_conv(conv, xs: torch.Tensor) -> torch.Tensor:
    """``conv``'s weight slice on ``xs``: no bias, no activation."""
    if not torch.is_grad_enabled():
        if conv.kernel_weights is not None:
            return conv_launch(xs, conv.kernel_weights, False)
    elif xs.is_cuda:
        return conv3x3_fn(xs, conv.hwio(), None, False, _frozen_layout(conv))
    return kpack_conv3x3(xs, conv.hwio(), None, False)


class RowParallelRDB:
    """A ResidualDenseBlock5C whose convs hold the Cin slices ``slices`` of
    this rank on ``group``."""

    def __init__(self, group: comm.Group, slices: list[tuple[int, int]]):
        self.group, self.slices = group, slices

    def forward(self, rdb, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for k, (c0, c1) in enumerate(self.slices, start=1):
            conv = getattr(rdb, f"conv{k}")
            part = _partial_conv(conv, comm.fan_out(feats, self.group)[..., c0:c1])
            # the partials summed in f32: in bf16 the sum would round once more than one conv's output
            y = (comm.reduce(part.float(), self.group) + conv.bias).to(x.dtype)
            if k < 5:
                feats = torch.cat([feats, lrelu(y)], dim=-1)
        return x + 0.2 * y

    def prepare_kernel(self, rdb, dtype: torch.dtype) -> None:
        """Each conv slice's ``conv3x3`` layout (no bias: it is added after the sum)."""
        for k in range(1, 6):
            conv = getattr(rdb, f"conv{k}")
            conv.kernel_weights = (
                conv_kernel_weights(conv.hwio(), None, dtype, conv.weight.device, 3) if conv.weight.is_cuda else None
            )


def _widths(model) -> tuple[int, int]:
    return model.conv_first.weight.shape[0], model.RRDB_trunk[0].RDB1.conv1.weight.shape[0]


def _check_tp_divisible(model, tp: int) -> None:
    nf, gc = _widths(model)
    if nf % tp or gc % tp:
        raise ValueError(f"channel TP over {tp} devices requires nf ({nf}) and gc ({gc}) divisible by {tp}")


def _rdbs(model):
    for i, blk in enumerate(model.RRDB_trunk):
        for j in (1, 2, 3):
            yield f"RRDB_trunk.{i}.RDB{j}", getattr(blk, f"RDB{j}")


def shard_trunk(model, mesh, axis: str = "model"):
    """Cut every RDB conv of ``model`` to this rank's Cin slice on ``axis``, in
    place (a model already sharded is returned as it is). Returns ``model``."""
    check_trunk_parallel_model(model, "tensor parallelism")
    if getattr(model, "tp_group", None) is not None:
        return model
    group = mesh.group(axis)
    _check_tp_divisible(model, group.size)
    nf, gc = _widths(model)
    for _, rdb in _rdbs(model):
        slices = []
        for k in range(1, 6):
            conv = getattr(rdb, f"conv{k}")
            n = (nf + (k - 1) * gc) // group.size
            c0 = group.index * n
            w = conv.weight
            conv.weight = nn.Parameter(w.detach()[:, c0 : c0 + n].clone(), requires_grad=w.requires_grad)
            conv.kernel_weights = None
            slices.append((c0, c0 + n))
        rdb.tp, rdb.kernel_weights = RowParallelRDB(group, slices), None
    model.tp_group = group
    return model


def sharded_names(model) -> dict[str, tuple[int, int]]:
    """The parameter names of the sharded conv weights, with their Cin slices."""
    if getattr(model, "tp_group", None) is None:
        return {}
    return {f"{name}.conv{k}.weight": rdb.tp.slices[k - 1] for name, rdb in _rdbs(model) for k in range(1, 6)}


def full_state_dict(model) -> dict:
    """``model``'s state dict with the conv slices gathered over the model axis
    (collective): the reference's keys and shapes."""
    state = model.state_dict()
    names = sharded_names(model)
    return {k: comm.gather(v, model.tp_group, dim=1) if k in names else v for k, v in state.items()}


def load_full_state_dict(model, state: dict) -> None:
    """Load a full (reference) state dict into a sharded ``model``, strictly."""
    names = sharded_names(model)
    model.load_state_dict({k: v[:, names[k][0] : names[k][1]] if k in names else v for k, v in state.items()},
                          strict=True)


def full_param_tensors(model, tensors: list) -> list:
    """Tensors aligned with ``model.parameters()`` (Adam's moments), the
    sharded weights' gathered to full width (collective)."""
    names = sharded_names(model)
    return [comm.gather(t, model.tp_group, dim=1) if n in names else t
            for (n, _), t in zip(model.named_parameters(), tensors, strict=True)]


def local_param_tensors(model, tensors: list) -> list:
    """The inverse of :func:`full_param_tensors`: full-width tensors cut to this rank's slices."""
    names = sharded_names(model)
    return [t[:, names[n][0] : names[n][1]] if n in names else t
            for (n, _), t in zip(model.named_parameters(), tensors, strict=True)]


def tp_trunk(model, mesh, axis: str = "model", data_axis: str | None = None):
    """``fn(carry) -> carry``: ``model``'s nb-block trunk with row-parallel
    convs over ``axis`` (``model`` is sharded in place). ``data_axis``: the
    batch is sharded there by the caller (DP x TP); the sums stay on
    ``axis``, so the two compose without further collectives."""
    shard_trunk(model, mesh, axis)
    return model.run_blocks


def tp_rrdb_apply(model, mesh, axis: str = "model"):
    """``fn(lr, z=None) -> sr``: ``model``'s forward with the trunk
    channel-sharded over ``axis``; the pre- and post-trunk layers run alike on
    every rank. The sharded RDBs run their own row-parallel forward, so this
    is ``model`` itself, sharded in place (its trunk is :func:`tp_trunk`'s)."""
    return shard_trunk(model, mesh, axis)


def spatial_tp_apply(model, mesh, halo: int = 32, scale: int | None = None, spatial_axis: str = "spatial",
                     axis: str = "model"):
    """Spatial x channel TP on a ('spatial', 'model') mesh: ``fn(lr, z=None) ->
    raw_sr`` slices each rank's exact-edge window of the LR over
    ``spatial_axis`` (activations 1/S, the 4x stages included) and runs it
    through the row-parallel trunk over ``axis`` (trunk parameters and
    compute 1/T). Wrap the RAW generator; project CEM on the output."""
    check_trunk_parallel_model(model, "spatial_tp_apply")
    _check_tp_divisible(model, mesh.shape[axis])
    if halo < 0:
        raise ValueError("halo must be >= 0")
    sc = int(scale if scale is not None else model.scale)
    return spatial_window_forward(tp_rrdb_apply(model, mesh, axis), mesh, scale=sc, halo=halo, axis=spatial_axis)
