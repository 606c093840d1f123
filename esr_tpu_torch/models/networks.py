"""Network factories and the JAX -> port weight bridges (port of
esr_tpu/models/networks.py): ``define_G`` / ``define_D`` / ``define_F`` build
the generator (RRDBNet, SRResNet, SwinIR or HAT), the discriminator and the frozen VGG19
feature extractor from the reference options dict; ``state_dict_from_jax``,
``srresnet_state_dict_from_jax``, ``discriminator_state_dict_from_jax``,
``vgg_state_dict_from_jax`` and ``kernelgan_state_dict_from_jax`` turn the
JAX package's param trees into the port's state_dicts (the reference torch
keys where there are any); ``normalize_rrdb_keys`` reads the reference's
released generator files (both of its key layouts), ``normalize_swinir_keys``
the released SwinIR and HAT files."""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.data.util import parse_size
from esr_tpu_torch.models.architecture import (
    HAT,
    DiscriminatorVGG128,
    RRDBNet,
    SRResNet,
    SwinIR,
    VGG19FeatureExtractor,
)

__all__ = [
    "define_D",
    "define_F",
    "define_G",
    "discriminator_state_dict_from_jax",
    "kernelgan_state_dict_from_jax",
    "normalize_rrdb_keys",
    "normalize_swinir_keys",
    "rrdb_options_from_state",
    "srresnet_state_dict_from_jax",
    "state_dict_from_jax",
    "vgg_state_dict_from_jax",
]


def define_G(opt: dict, device: str | torch.device = "cuda",
             seed: int = 0) -> RRDBNet | SRResNet | SwinIR | HAT:
    """The generator from the reference options dict (``network_G`` block:
    ``which_model_G`` (``RRDB_net``, ``sr_resnet``, ``SwinIR`` or ``HAT``),
    ``nf``, ``nb``, ``in_nc``, ``out_nc``, ``gc``, ``latent_input``,
    ``num_latent_channels``; SwinIR takes its released constructor's keys
    (``in_chans``, ``embed_dim``, ``depths``, ``num_heads``, ``window_size``,
    ``mlp_ratio``, ``upscale``, ``img_range``, ``upsampler``,
    ``resi_connection``; ``img_size`` is accepted and changes nothing), HAT
    the same and ``compress_ratio``, ``squeeze_factor``, ``conv_scale`` and
    ``overlap_ratio``;
    top-level ``scale`` and ``bf16``), in eval mode on ``device`` with seeded
    weights. ``fold`` and ``packed`` are accepted and change nothing:
    per-image math is identical."""
    dev = resolve_device(device)
    o = opt["network_G"]
    which = (o.get("which_model_G") or "RRDB_net").lower()
    if which == "swinir":
        scale = int(o.get("upscale") or opt.get("scale") or 4)
        if opt.get("scale") and int(opt["scale"]) != scale:
            raise ValueError(f"SwinIR: network_G.upscale {scale} and scale {opt['scale']} differ")
        g = SwinIR(
            in_chans=int(o.get("in_chans") or 3),
            embed_dim=int(o.get("embed_dim") or 180),
            depths=tuple(o.get("depths") or (6,) * 6),
            num_heads=tuple(o.get("num_heads") or (6,) * 6),
            window_size=int(o.get("window_size") or 8),
            mlp_ratio=float(o.get("mlp_ratio") or 2.0),
            upscale=scale,
            img_range=float(o.get("img_range") or 1.0),
            upsampler=o.get("upsampler") or "nearest+conv",
            resi_connection=o.get("resi_connection") or "1conv",
            dtype=_dtype(opt),
            seed=seed,
        )
        return g.to(dev).eval()
    if which == "hat":
        scale = int(o.get("upscale") or opt.get("scale") or 4)
        if opt.get("scale") and int(opt["scale"]) != scale:
            raise ValueError(f"HAT: network_G.upscale {scale} and scale {opt['scale']} differ")
        g = HAT(
            in_chans=int(o.get("in_chans") or 3),
            embed_dim=int(o.get("embed_dim") or 180),
            depths=tuple(o.get("depths") or (6,) * 6),
            num_heads=tuple(o.get("num_heads") or (6,) * 6),
            window_size=int(o.get("window_size") or 16),
            compress_ratio=int(o.get("compress_ratio") or 3),
            squeeze_factor=int(o.get("squeeze_factor") or 30),
            conv_scale=float(o.get("conv_scale") or 0.01),
            overlap_ratio=float(o.get("overlap_ratio") or 0.5),
            mlp_ratio=float(o.get("mlp_ratio") or 2.0),
            upscale=scale,
            img_range=float(o.get("img_range") or 1.0),
            upsampler=o.get("upsampler") or "pixelshuffle",
            resi_connection=o.get("resi_connection") or "1conv",
            dtype=_dtype(opt),
            seed=seed,
        )
        return g.to(dev).eval()
    if which in ("sr_resnet", "srresnet", "msrresnet"):
        g = SRResNet(
            in_nc=int(o.get("in_nc") or 3),
            out_nc=int(o.get("out_nc") or 3),
            nf=int(o.get("nf") or 64),
            nb=int(o.get("nb") or 16),
            scale=int(opt.get("scale") or 4),
            num_latent_channels=int(o.get("num_latent_channels") or 0),
            dtype=_dtype(opt),
            seed=seed,
        )
        return g.to(dev).eval()
    if which not in ("rrdb_net", "rrdbnet", "rrdb"):
        raise NotImplementedError(f"generator {which} not supported")
    latent = o.get("latent_input") or opt.get("latent_input")
    g = RRDBNet(
        in_nc=int(o.get("in_nc") or 3),
        out_nc=int(o.get("out_nc") or 3),
        nf=int(o.get("nf") or 64),
        nb=int(o.get("nb") or 23),
        gc=int(o.get("gc") or 32),
        scale=int(opt.get("scale") or 4),
        num_latent_channels=int(o.get("num_latent_channels") or 0),
        latent_input=latent or "first_layer",
        dtype=_dtype(opt),
        seed=seed,
    )
    return g.to(dev).eval()


def _dtype(opt: dict) -> torch.dtype:
    return torch.bfloat16 if opt.get("bf16", True) else torch.float32


def define_D(opt: dict, device: str | torch.device = "cuda", seed: int = 0) -> DiscriminatorVGG128:
    """``DiscriminatorVGG128`` from the ``network_D`` block (``which_model_D``,
    ``in_nc``, ``nf``, ``norm_type``) on ``device``; its first linear layer is
    sized by ``datasets.train.HR_size``; bf16 convs unless ``bf16`` is false."""
    o = opt.get("network_D") or {}
    which = (o.get("which_model_D") or "discriminator_vgg_128").lower()
    if "vgg" not in which:
        raise NotImplementedError(f"discriminator {which} not supported")
    hr_size = parse_size(((opt.get("datasets") or {}).get("train") or {}).get("HR_size"))
    d = DiscriminatorVGG128(
        in_nc=int(o.get("in_nc") or 3), nf=int(o.get("nf") or 64),
        norm="batch" if (o.get("norm_type") or "batch") == "batch" else "none",
        hr_size=hr_size, dtype=_dtype(opt), seed=seed,
    )
    return d.to(resolve_device(device))


def define_F(opt: dict, device: str | torch.device = "cuda", seed: int = 0) -> VGG19FeatureExtractor:
    """The frozen VGG19 feature extractor up to ``train.feature_layer`` (34,
    conv5_4 before its ReLU); bf16 convs unless ``bf16`` is false. Its
    weights are seeded: ImageNet weights come from a torchvision ``.pth``
    (``path.pretrain_model_F``, loaded by the trainer)."""
    layer = int((opt.get("train") or {}).get("feature_layer") or 34)
    return VGG19FeatureExtractor(feature_layer=layer, dtype=_dtype(opt), seed=seed).to(resolve_device(device))


# the reference's old RRDBNet layout: model.0 conv_first, model.1.sub.{i} the
# RRDBs (and trunk_conv, the last sub), model.3 / 6 / 8 / 10 the convs after it
_OLD_RRDB_NAMES = {"0": "conv_first", "3": "upconv1", "6": "upconv2", "8": "HRconv", "10": "conv_last"}
# a conv inside Sequential(conv, LeakyReLU) carries a '.0' (the reference's RDB convs)
_SEQ_CONV = re.compile(r"^(conv_first|trunk_conv|upconv\d+|HRconv|conv_last|RRDB_trunk\.\d+\.RDB\d\.conv\d)"
                       r"\.0\.(weight|bias)$")


def normalize_rrdb_keys(state: dict) -> dict:
    """A torch ESRGAN generator state dict in the keys this port's RRDBNet
    loads: a ``{"state_dict": ...}`` wrapper unwrapped; the reference's old
    layout (``model.0`` / ``model.1.sub.{i}.RDB{j}.conv{k}`` / the last
    ``model.1.sub.{nb}`` / ``model.3`` / ``model.6`` / ``model.8`` /
    ``model.10``) renamed to ``conv_first`` / ``RRDB_trunk.{i}.RDB{j}.conv{k}``
    / ``trunk_conv`` / ``upconv1`` / ``upconv2`` / ``HRconv`` / ``conv_last``
    (the JAX package's ``_normalize_rrdb_keys``); the ``.0`` of a conv inside
    ``Sequential(conv, LeakyReLU)`` (``conv{k}.0.weight``) dropped. Other keys
    pass as they are, so a strict load still refuses an unknown or missing
    one; two keys that name the same parameter raise ``ValueError``."""
    if isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    out = {}
    for key, v in state.items():
        new = key
        m = re.match(r"model\.1\.sub\.(\d+)\.(.+)$", key)
        if m:
            new = (f"RRDB_trunk.{m[1]}." if m[2].startswith("RDB") else "trunk_conv.") + m[2]
        else:
            m = re.match(r"model\.(\d+)\.(.+)$", key)
            if m and m[1] in _OLD_RRDB_NAMES:
                new = f"{_OLD_RRDB_NAMES[m[1]]}.{m[2]}"
        new = _SEQ_CONV.sub(r"\1.\2", new)
        if new in out:
            raise ValueError(f"{key} and another key both name {new}")
        out[new] = v
    return out


def normalize_swinir_keys(state: dict) -> dict:
    """A released SwinIR or HAT state dict (``main_test_swinir.py``'s files,
    HAT's ``HAT_SRx4*.pth``) in the keys the port's ``SwinIR`` and ``HAT``
    load: the ``params`` / ``params_ema`` wrapper unwrapped (``params_ema``
    first, as the released scripts take it), the buffers the port does not
    keep (SwinIR's ``relative_position_index`` and each shifted block's
    ``attn_mask``, HAT's ``relative_position_index_SA`` / ``_OCA``) dropped.
    Other keys pass as they are."""
    for key in ("params_ema", "params"):
        if isinstance(state.get(key), dict):
            state = state[key]
            break
    return {k: v for k, v in state.items()
            if not k.endswith(("attn.relative_position_index", ".attn_mask"))
            and not k.startswith("relative_position_index_")}


def rrdb_options_from_state(state: dict) -> dict:
    """The ``network_G`` block of the RRDBNet whose state dict (this port's
    keys, :func:`normalize_rrdb_keys`) is ``state``: widths, depth and the Z
    channels (``conv_first``'s input beyond RGB). The scale is not in the
    weights (x2 and x3 have the same convs), so it is the caller's."""
    first = state["conv_first.weight"]
    blocks = {int(m[1]) for k in state if (m := re.match(r"RRDB_trunk\.(\d+)\.", k))}
    proj = any(k.startswith("latent_proj.") for k in state)
    return {"which_model_G": "RRDB_net", "in_nc": 3, "out_nc": int(state["conv_last.weight"].shape[0]),
            "nf": int(first.shape[0]), "nb": len(blocks), "gc": int(state["RRDB_trunk.0.RDB1.conv1.weight"].shape[0]),
            "num_latent_channels": int(first.shape[1]) - 3, "latent_input": "all_layers" if proj else "first_layer"}


def _conv_entries(name: str, conv: dict) -> dict:
    c = conv["Conv_0"] if "Conv_0" in conv else conv
    w = np.transpose(np.asarray(c["kernel"], dtype=np.float32), (3, 2, 0, 1))  # HWIO -> OIHW
    return {
        f"{name}.weight": torch.from_numpy(np.ascontiguousarray(w)),
        f"{name}.bias": torch.from_numpy(np.asarray(c["bias"], dtype=np.float32).copy()),
    }


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's RRDBNet param tree (nested dicts of arrays, scan
    layout ``rrdb_scan/block`` with a leading (nb,) axis or unrolled
    ``rrdb{i}``) -> this port's ``state_dict`` (reference ESRGAN keys, OIHW;
    the ``all_layers`` projections ``rrdb_scan/latent_proj`` or
    ``latent_proj{i}`` as ``latent_proj.{i}``, the keys of ``esr_tpu``'s
    ``rrdb_to_torch``). Loads with ``load_state_dict(strict=True)``."""
    if "params" in params and "conv_first" not in params:
        params = params["params"]
    if "rrdb_scan" in params:
        stacked = params["rrdb_scan"]["block"]
        nb = int(np.asarray(stacked["rdb1"]["conv1"]["Conv_0"]["kernel"]).shape[0])
        blocks = [_index_tree(stacked, i) for i in range(nb)]
        sp = params["rrdb_scan"].get("latent_proj")
        projs = [] if sp is None else [_index_tree(sp, i) for i in range(nb)]
    else:
        nb = sum(1 for k in params if re.fullmatch(r"rrdb\d+", k))
        blocks = [params[f"rrdb{i}"] for i in range(nb)]
        projs = [params[f"latent_proj{i}"] for i in range(nb) if f"latent_proj{i}" in params]
    out: dict = {}
    for i, p in enumerate(projs):
        out.update(_conv_entries(f"latent_proj.{i}", p))
    for name in ("conv_first", "trunk_conv", "HRconv", "conv_last"):
        out.update(_conv_entries(name, params[name]))
    for i, blk in enumerate(blocks):
        for j in (1, 2, 3):
            for k in range(1, 6):
                out.update(_conv_entries(f"RRDB_trunk.{i}.RDB{j}.conv{k}", blk[f"rdb{j}"][f"conv{k}"]))
    i = 1
    while f"upconv{i}" in params:
        out.update(_conv_entries(f"upconv{i}", params[f"upconv{i}"]))
        i += 1
    return out


def srresnet_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's SRResNet param tree -> this port's ``state_dict``.
    The JAX package has no torch export for SRResNet, so these keys are the
    flax module names (``conv_first``, ``block{i}.conv1/conv2``,
    ``trunk_conv``, ``upconv{i}``, ``HRconv``, ``conv_last``), OIHW, with no
    reference counterpart. Loads with ``load_state_dict(strict=True)``."""
    params = params.get("params", params)
    out: dict = {}
    for name, sub in params.items():
        if re.fullmatch(r"block\d+", name):
            for conv in ("conv1", "conv2"):
                out.update(_conv_entries(f"{name}.{conv}", sub[conv]))
        else:
            out.update(_conv_entries(name, sub))
    return out


def kernelgan_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``LinearKernelG`` or ``PatchD`` param tree (``conv{i}`` with a
    ``kernel`` and, for D, a ``bias``) -> the port module's ``state_dict``
    (``conv{i}.weight`` OIHW, ``conv{i}.bias``)."""
    params = params.get("params", params)
    out: dict = {}
    for name, conv in params.items():
        out[f"{name}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        if "bias" in conv:
            out[f"{name}.bias"] = _t(conv["bias"])
    return out


def _t(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C"))


def discriminator_state_dict_from_jax(variables: dict, hr_size=None) -> dict[str, torch.Tensor]:
    """The JAX package's ``DiscriminatorVGG128`` variables (``{'params'[,
    'batch_stats']}``) -> this port's ``state_dict``: ``conv{b}_{i}`` OIHW,
    ``bn{b}_{i}`` with the running statistics, ``linear1`` with its input
    permuted from the JAX NHWC flatten to the NCHW one, and ``linear2``.
    ``hr_size`` (the train crop, int or [H, W]) sets the last feature map's
    H/32 x W/32; a square crop is assumed without it. Loads with
    ``load_state_dict(strict=True)``."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats") or {}
    out: dict = {}
    for name in (f"{b}_{i}" for b in range(5) for i in (0, 1)):
        conv = params[f"conv{name}"]
        out[f"conv{name}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        if "bias" in conv:
            out[f"conv{name}.bias"] = _t(conv["bias"])
        if f"bn{name}" in params:
            bn, st = params[f"bn{name}"], stats.get(f"bn{name}", {})
            out[f"bn{name}.weight"] = _t(bn["scale"])
            out[f"bn{name}.bias"] = _t(bn["bias"])
            out[f"bn{name}.running_mean"] = _t(st.get("mean", np.zeros_like(bn["bias"])))
            out[f"bn{name}.running_var"] = _t(st.get("var", np.ones_like(bn["bias"])))
            out[f"bn{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    c = np.asarray(params["conv4_1"]["kernel"]).shape[-1]
    w1 = np.asarray(params["linear1"]["kernel"], np.float32).T  # (100, h*w*c), NHWC flatten
    if hr_size is None:
        h = w = math.isqrt(w1.shape[1] // c)
    else:
        h, w = (v // 32 for v in parse_size(hr_size))
    w1 = w1.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(w1.shape[0], -1)
    out["linear1.weight"] = _t(w1)
    out["linear1.bias"] = _t(params["linear1"]["bias"])
    out["linear2.weight"] = _t(np.asarray(params["linear2"]["kernel"]).T)
    out["linear2.bias"] = _t(params["linear2"]["bias"])
    return out


_VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
_VGG_CONV_NAMES = tuple(f"conv{s + 1}_{i + 1}" for s, n in enumerate((2, 2, 4, 4, 4)) for i in range(n))


def vgg_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``VGG19FeatureExtractor`` params (``conv{s}_{l}``) ->
    torchvision-keyed ``features.{i}.weight/bias`` (OIHW): the inverse of
    ``load_vgg19_from_torch``, loadable by ``VGG19FeatureExtractor.load_torchvision``."""
    params = params.get("params", params)
    out: dict = {}
    for idx, name in zip(_VGG_CONV_INDICES, _VGG_CONV_NAMES):
        if name not in params:
            break
        out[f"features.{idx}.weight"] = _t(np.transpose(np.asarray(params[name]["kernel"]), (3, 2, 0, 1)))
        out[f"features.{idx}.bias"] = _t(params[name]["bias"])
    return out
