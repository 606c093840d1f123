"""Network architectures (port of esr_tpu/models/architecture.py).

- ``RRDBNet``: conv_first -> nb RRDB blocks -> trunk conv (+residual) ->
  nearest-upsample + conv stages -> HR conv -> last conv. The explorable fork
  feeds ``num_latent_channels`` extra Z-map channels, concatenated at the
  input (``latent_input='first_layer'``), and with ``'all_layers'`` also
  re-injected before every RRDB through a 1x1 ``latent_proj``.
- ``SRResNet``: conv_first -> nb conv-ReLU-conv residual blocks (no BN) ->
  trunk conv (+residual) -> conv + pixel-shuffle stages -> HR conv -> last
  conv; the same Z-map input as RRDBNet.
- ``SwinIR``: SwinIR (Liang et al. 2021) with the real-world x4
  ``nearest+conv`` upsampler: conv_first -> patch LayerNorm -> residual
  Swin transformer blocks (RSTB: Swin blocks of shifted-window attention and
  an MLP, then a 3x3 conv, + identity) -> LayerNorm -> conv_after_body
  (+residual) -> conv_before_upsample + LeakyReLU(0.01) -> two nearest-2x
  + conv stages -> HR conv -> last conv; no Z input.
- ``HAT``: the Hybrid Attention Transformer (Chen et al. 2023) with the
  classical x4 ``pixelshuffle`` upsampler: conv_first -> patch LayerNorm ->
  residual hybrid attention groups (RHAG: hybrid attention blocks, each a
  window-16 attention plus a scaled channel-attention conv branch and an
  MLP, then an overlapping cross-attention block, then a 3x3 conv, +
  identity) -> LayerNorm -> conv_after_body (+residual) ->
  conv_before_upsample + LeakyReLU(0.01) -> two conv 64 -> 256 + pixel
  shuffle stages -> last conv; no Z input.
- ``DiscriminatorVGG128``: the VGG-style 10-conv strided stack (BatchNorm
  after all but the first conv, LeakyReLU 0.2) and two linear heads -> one
  logit.
- ``VGG19FeatureExtractor``: VGG19 up to conv5_4 before its ReLU, ImageNet
  input normalisation, frozen: the ESRGAN perceptual-loss space.

Inputs are NHWC, as in the JAX package; parameters are f32 under the
reference torch state_dict keys, and the convs compute in ``dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from esr_tpu_torch.models.blocks import (
    CAB,
    HAB,
    OCAB,
    RRDB,
    Conv1x1,
    ConvLRelu,
    FusedUpsampleConvLRelu,
    LayerNorm,
    ResidualBlockNoBN,
    SwinBlock,
    pixel_shuffle,
    upsample_nearest,
)

__all__ = ["DiscriminatorVGG128", "FlaxBatchNorm2d", "HAT", "RRDBNet", "SRResNet", "SwinIR", "VGG19FeatureExtractor"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _up_factors(scale: int) -> tuple[int, ...]:
    """Per-stage upsample factors for an integer model scale."""
    table = {1: (), 2: (2,), 3: (3,), 4: (2, 2), 8: (2, 2, 2)}
    if scale not in table:
        raise ValueError(f"unsupported scale {scale}; supported: {sorted(table)}")
    return table[scale]


class _Generator(nn.Module):
    """The kernel-layout surface the models call on any generator.

    ``layout_generation`` counts the changes of the weight layouts
    (``prepare_kernels``, ``release_kernels``): a CUDA graph of a forward
    holds the layouts' addresses, so its owner drops it when the count has
    moved (``models/base_model.EvalForward``)."""

    layout_generation = 0

    def _kernel_modules(self) -> list[nn.Module]:
        """The modules whose forward runs a CUDA kernel."""
        return [m for m in self.modules() if isinstance(m, ConvLRelu)]

    def prepare_kernels(self) -> None:
        """Build every kernel's weight layout once, in ``dtype``, from the
        weights as they are now (on the CPU: nothing to build). Call it again
        after changing the weights."""
        for m in self._kernel_modules():
            m.prepare_kernel(self.dtype)
        self.layout_generation += 1

    def release_kernels(self) -> None:
        """Drop the weight layouts ``prepare_kernels`` built (a trainer does so
        after an eval forward: the next step changes the weights)."""
        for m in self.modules():
            if hasattr(m, "prepare_kernel"):
                m.kernel_weights = None
        self.layout_generation += 1

    def _input(self, lr: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:
        """LR, with the Z map (zeros when None) concatenated when the net has one."""
        if not self.num_latent_channels:
            return lr
        if z is None:
            z = lr.new_zeros(lr.shape[:-1] + (self.num_latent_channels,))
        return torch.cat([lr, z.to(lr.dtype)], dim=-1)


class RRDBNet(_Generator):
    """NHWC RRDB generator. Parameters are f32 under the reference ESRGAN
    state_dict keys (``latent_proj.{i}`` for the per-block Z projections of
    ``latent_input='all_layers'``, as ``esr_tpu``'s ``rrdb_to_torch`` names
    them); the convs compute in ``dtype`` and the output is f32. Weights are
    seeded Kaiming(x0.1 on residual branches) from ``seed``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23, gc: int = 32,
                 scale: int = 4, num_latent_channels: int = 0, latent_input: str = "first_layer",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if latent_input not in ("first_layer", "all_layers", "none"):
            raise ValueError(f"unknown latent_input {latent_input!r}")
        self.num_latent_channels = num_latent_channels
        self.scale = scale
        self.dtype = dtype
        self.all_layers = latent_input == "all_layers" and bool(num_latent_channels)
        g = torch.Generator().manual_seed(seed)
        self.conv_first = ConvLRelu(in_nc + num_latent_channels, nf, act=False, generator=g)
        self.RRDB_trunk = nn.ModuleList(RRDB(nf, gc, g) for _ in range(nb))
        if self.all_layers:
            self.latent_proj = nn.ModuleList(Conv1x1(nf + num_latent_channels, nf, g) for _ in range(nb))
        self.trunk_conv = ConvLRelu(nf, nf, act=False, init_scale=0.1, generator=g)
        for i, r in enumerate(_up_factors(scale)):
            # 2x stages take the 4-parity rewrite; odd factors (x3) the
            # materialized nearest upsample + conv
            up = FusedUpsampleConvLRelu if r == 2 else ConvLRelu
            self.add_module(f"upconv{i + 1}", up(nf, nf, act=True, generator=g))
        self.HRconv = ConvLRelu(nf, nf, act=True, generator=g)
        self.conv_last = ConvLRelu(nf, out_nc, act=False, generator=g)

    def _kernel_modules(self) -> list[nn.Module]:
        """The RDB kernel runs each RDB; its five convs run inside it."""
        convs = [self.conv_first, self.trunk_conv, self.HRconv, self.conv_last]
        convs += [getattr(self, f"upconv{i + 1}") for i in range(len(_up_factors(self.scale)))]
        return convs + [rdb for blk in self.RRDB_trunk for rdb in (blk.RDB1, blk.RDB2, blk.RDB3)]

    def run_blocks(self, carry, blocks=None):
        """Trunk blocks ``blocks`` (all by default) in order on ``carry``: the
        trunk features, or ``(trunk, z)`` with ``latent_input='all_layers'``
        (Z re-injected before every RRDB rides the carry unchanged)."""
        for i in range(len(self.RRDB_trunk)) if blocks is None else blocks:
            if self.all_layers:
                trunk, zc = carry
                carry = (self.RRDB_trunk[i](self.latent_proj[i](torch.cat([trunk, zc], dim=-1))), zc)
            else:
                carry = self.RRDB_trunk[i](carry)
        return carry

    def forward(self, lr: torch.Tensor, z: torch.Tensor | None = None, trunk_fn=None) -> torch.Tensor:
        """lr: (N, H, W, in_nc) in [0, 1]; z: (N, H, W, num_latent_channels) or
        None. ``trunk_fn(carry) -> carry`` replaces :meth:`run_blocks` (the
        pipelined trunk, ``parallel/pipeline.py``)."""
        x = self._input(lr, z)
        fea = self.conv_first(x.to(self.dtype))
        carry = (fea, x[..., -self.num_latent_channels :].to(self.dtype)) if self.all_layers else fea
        trunk = (trunk_fn or self.run_blocks)(carry)
        if self.all_layers:
            trunk = trunk[0]
        fea = fea + self.trunk_conv(trunk)
        for i, r in enumerate(_up_factors(self.scale)):
            up = getattr(self, f"upconv{i + 1}")
            fea = up(fea) if isinstance(up, FusedUpsampleConvLRelu) else up(upsample_nearest(fea, r))
        return self.conv_last(self.HRconv(fea)).float()


class SRResNet(_Generator):
    """NHWC SRResNet / MSRResNet generator (``which_model_G: sr_resnet``):
    conv_first + lrelu -> ``block{i}`` (conv, ReLU, conv, + identity) ->
    trunk_conv (+residual) -> per stage ``upconv{i}`` (nf -> nf r^2), pixel
    shuffle, lrelu -> HRconv + lrelu -> conv_last. The module names are the
    flax ones; the JAX package exports no torch keys for this net. Every conv
    is ``ConvLRelu``, so a 3x3 ``conv3x3`` kernel (the lrelu after the pixel
    shuffle is elementwise, so it runs in the conv's epilogue)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 16, scale: int = 4,
                 num_latent_channels: int = 0, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.num_latent_channels = num_latent_channels
        self.scale = scale
        self.dtype = dtype
        self.nb = nb
        g = torch.Generator().manual_seed(seed)
        self.conv_first = ConvLRelu(in_nc + num_latent_channels, nf, act=True, generator=g)
        for i in range(nb):
            self.add_module(f"block{i}", ResidualBlockNoBN(nf, g))
        self.trunk_conv = ConvLRelu(nf, nf, act=False, init_scale=0.1, generator=g)
        for i, r in enumerate(_up_factors(scale)):
            self.add_module(f"upconv{i + 1}", ConvLRelu(nf, nf * r * r, act=True, generator=g))
        self.HRconv = ConvLRelu(nf, nf, act=True, generator=g)
        self.conv_last = ConvLRelu(nf, out_nc, act=False, generator=g)

    def forward(self, lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        """lr: (N, H, W, in_nc) in [0, 1]; z: (N, H, W, num_latent_channels) or None."""
        fea = self.conv_first(self._input(lr, z).to(self.dtype))
        trunk = fea
        for i in range(self.nb):
            trunk = getattr(self, f"block{i}")(trunk)
        fea = fea + self.trunk_conv(trunk)
        for i, r in enumerate(_up_factors(self.scale)):
            fea = pixel_shuffle(getattr(self, f"upconv{i + 1}")(fea), r)
        return self.conv_last(self.HRconv(fea)).float()


class _RSTB(nn.Module):
    """SwinIR's residual Swin transformer block (``resi_connection='1conv'``):
    ``conv(blocks(t)) + t``, the blocks at shifts 0, ws / 2, 0, ...; keys
    ``residual_group.blocks.{i}.*`` and ``conv``."""

    def __init__(self, dim: int, depth: int, heads: int, ws: int, mlp_ratio: float, generator: torch.Generator):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, mlp_ratio, generator) for i in range(depth))
        self.conv = ConvLRelu(dim, dim, act=False, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        u = t
        for blk in self.residual_group.blocks:
            u = blk(u)
        return self.conv(u) + t


class SwinIR(_Generator):
    """NHWC SwinIR generator (``which_model_G: SwinIR``), the released
    real-world x4 model's layout (``upsampler='nearest+conv'``,
    ``resi_connection='1conv'``) and state_dict keys (``conv_first``,
    ``patch_embed.norm``, ``layers.{l}.residual_group.blocks.{i}.{norm1,
    attn.relative_position_bias_table, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2}``, ``layers.{l}.conv``, ``norm``, ``conv_after_body``,
    ``conv_before_upsample.0``, ``conv_up1``, ``conv_up2``, ``conv_hr``,
    ``conv_last``; ``networks.normalize_swinir_keys`` reads a released file).

    The LR is reflect-padded to multiples of the window and the output
    cropped back; tokens stay NHWC (a token is a pixel) in ``dtype``, the
    residual stream too; LayerNorm statistics and the softmax are f32. On
    the card in bf16: every 3x3 conv on ``conv_tc_kernel`` (the 180-channel
    ones on its Cin 129-192 instances, the two 2x stages in its 2x2 parity
    mode, as ``RRDBNet``'s), every attention on the ``window_attn`` kernel,
    every linear on the ``token_linear`` kernel (fc1's GELU and the blocks'
    residual adds in its epilogue). No Z input
    (``num_latent_channels`` 0)."""

    MEAN = (0.4488, 0.4371, 0.4040)
    NUM_FEAT = 64

    def __init__(self, in_chans: int = 3, embed_dim: int = 180, depths=(6,) * 6, num_heads=(6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0, upscale: int = 4, img_range: float = 1.0,
                 upsampler: str = "nearest+conv", resi_connection: str = "1conv",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if upsampler != "nearest+conv" or resi_connection != "1conv" or upscale != 4:
            raise NotImplementedError(f"SwinIR: upsampler {upsampler!r}, resi_connection {resi_connection!r}, x"
                                      f"{upscale}; the port has the real-world x4 'nearest+conv' / '1conv' model")
        self.num_latent_channels = 0
        self.scale = upscale
        self.dtype = dtype
        self.window_size = window_size
        self.img_range = float(img_range)
        self.register_buffer("mean", torch.tensor(self.MEAN if in_chans == 3 else (0.0,) * in_chans),
                             persistent=False)
        g = torch.Generator().manual_seed(seed)
        nf = self.NUM_FEAT
        self.conv_first = ConvLRelu(in_chans, embed_dim, act=False, generator=g)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            _RSTB(embed_dim, d, h, window_size, mlp_ratio, g) for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = ConvLRelu(embed_dim, embed_dim, act=False, generator=g)
        self.conv_before_upsample = nn.ModuleList([ConvLRelu(embed_dim, nf, act=True, slope=0.01, generator=g)])
        self.conv_up1 = FusedUpsampleConvLRelu(nf, nf, act=True, generator=g)
        self.conv_up2 = FusedUpsampleConvLRelu(nf, nf, act=True, generator=g)
        self.conv_hr = ConvLRelu(nf, nf, act=True, generator=g)
        self.conv_last = ConvLRelu(nf, in_chans, act=False, generator=g)

    def _kernel_modules(self) -> list[nn.Module]:
        """The convs, the attentions (their dense biases) and the linears and
        norms (their weights in the compute dtype)."""
        return [m for m in self.modules() if m is not self and hasattr(m, "prepare_kernel")]

    def forward(self, lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        """lr: (N, H, W, in_chans) in [0, 1] -> (N, 4H, 4W, in_chans) f32."""
        if z is not None:
            raise ValueError("SwinIR takes no Z map")
        _, h, w, _ = lr.shape
        ws = self.window_size
        x = F.pad(lr.permute(0, 3, 1, 2), (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), mode="reflect")
        x = ((x.permute(0, 2, 3, 1) - self.mean) * self.img_range).to(self.dtype)
        fea = self.conv_first(x)
        t = self.patch_embed.norm(fea)
        for layer in self.layers:
            t = layer(t)
        fea = self.conv_after_body(self.norm(t)) + fea
        y = self.conv_up2(self.conv_up1(self.conv_before_upsample[0](fea)))
        out = self.conv_last(self.conv_hr(y)).float() / self.img_range + self.mean
        s = self.scale
        return out if out.shape[1:3] == (s * h, s * w) else out[:, : s * h, : s * w].contiguous()


class _RHAG(nn.Module):
    """HAT's residual hybrid attention group (``resi_connection='1conv'``):
    ``conv(ocab(blocks(t))) + t``, the HABs at shifts 0, ws / 2, 0, ...; keys
    ``residual_group.blocks.{i}.*``, ``residual_group.overlap_attn.*`` and
    ``conv``."""

    def __init__(self, dim: int, depth: int, heads: int, ws: int, cfg: dict, generator: torch.Generator):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            HAB(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, cfg["compress_ratio"], cfg["squeeze_factor"],
                cfg["conv_scale"], cfg["mlp_ratio"], generator) for i in range(depth))
        self.residual_group.overlap_attn = OCAB(dim, heads, ws, cfg["overlap_ratio"], cfg["mlp_ratio"], generator)
        self.conv = ConvLRelu(dim, dim, act=False, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        u = t
        for blk in self.residual_group.blocks:
            u = blk(u)
        return self.conv(self.residual_group.overlap_attn(u)) + t


class HAT(_Generator):
    """NHWC HAT generator (``which_model_G: HAT``), the released classical
    x4 layout (``upsampler='pixelshuffle'``, ``resi_connection='1conv'``) and
    keys (``conv_first``, ``patch_embed.norm``, ``layers.{l}.residual_group.
    blocks.{i}.{norm1, conv_block.cab.{0,2}, conv_block.cab.3.attention.{1,3},
    attn.relative_position_bias_table, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2}``, ``layers.{l}.residual_group.overlap_attn.*``,
    ``layers.{l}.conv``, ``norm``, ``conv_after_body``,
    ``conv_before_upsample.0``, ``upsample.{0,2}``, ``conv_last``;
    ``networks.normalize_swinir_keys`` reads a released file).

    The LR is reflect-padded to multiples of the window and the output
    cropped back; tokens stay NHWC in ``dtype``, the residual stream too;
    LayerNorm statistics, the softmax and the channel attention's squeeze
    are f32. On the card in bf16: every 3x3 conv on the conv kernels
    (``conv_tc_kernel``, the CABs' first on ``conv_tc_kernel_gelu``), every
    attention on the ``hat_attn`` kernel, every channel attention on the
    ``channel_attn`` kernels, every linear on ``token_linear`` and every
    LayerNorm on ``layernorm``. No Z input (``num_latent_channels`` 0)."""

    MEAN = (0.4488, 0.4371, 0.4040)
    NUM_FEAT = 64

    def __init__(self, in_chans: int = 3, embed_dim: int = 180, depths=(6,) * 6, num_heads=(6,) * 6,
                 window_size: int = 16, compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0, upscale: int = 4, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", resi_connection: str = "1conv",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if upsampler != "pixelshuffle" or resi_connection != "1conv" or upscale != 4:
            raise NotImplementedError(f"HAT: upsampler {upsampler!r}, resi_connection {resi_connection!r}, x"
                                      f"{upscale}; the port has the classical x4 'pixelshuffle' / '1conv' model")
        self.num_latent_channels = 0
        self.scale = upscale
        self.dtype = dtype
        self.window_size = window_size
        self.img_range = float(img_range)
        self.register_buffer("mean", torch.tensor(self.MEAN if in_chans == 3 else (0.0,) * in_chans),
                             persistent=False)
        g = torch.Generator().manual_seed(seed)
        nf = self.NUM_FEAT
        cfg = {"compress_ratio": compress_ratio, "squeeze_factor": squeeze_factor, "conv_scale": conv_scale,
               "overlap_ratio": overlap_ratio, "mlp_ratio": mlp_ratio}
        self.conv_first = ConvLRelu(in_chans, embed_dim, act=False, generator=g)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            _RHAG(embed_dim, d, h, window_size, cfg, g) for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = ConvLRelu(embed_dim, embed_dim, act=False, generator=g)
        self.conv_before_upsample = nn.ModuleList([ConvLRelu(embed_dim, nf, act=True, slope=0.01, generator=g)])
        self.upsample = nn.ModuleList([ConvLRelu(nf, 4 * nf, act=False, generator=g), nn.PixelShuffle(2),
                                       ConvLRelu(nf, 4 * nf, act=False, generator=g), nn.PixelShuffle(2)])
        self.conv_last = ConvLRelu(nf, in_chans, act=False, generator=g)

    def _kernel_modules(self) -> list[nn.Module]:
        """The convs (the CABs' inside their ``CAB``, which pads them), the
        attentions, the CABs and the linears and norms."""
        inner = {id(c) for m in self.modules() if isinstance(m, CAB) for c in m.convs()}
        return [m for m in self.modules() if m is not self and hasattr(m, "prepare_kernel") and id(m) not in inner]

    def forward(self, lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        """lr: (N, H, W, in_chans) in [0, 1] -> (N, 4H, 4W, in_chans) f32."""
        if z is not None:
            raise ValueError("HAT takes no Z map")
        _, h, w, _ = lr.shape
        ws = self.window_size
        x = F.pad(lr.permute(0, 3, 1, 2), (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), mode="reflect")
        x = ((x.permute(0, 2, 3, 1) - self.mean) * self.img_range).to(self.dtype)
        fea = self.conv_first(x)
        t = self.patch_embed.norm(fea)
        for layer in self.layers:
            t = layer(t)
        fea = self.conv_after_body(self.norm(t)) + fea
        y = self.conv_before_upsample[0](fea)
        y = pixel_shuffle(self.upsample[2](pixel_shuffle(self.upsample[0](y), 2)), 2)
        out = self.conv_last(y).float() / self.img_range + self.mean
        s = self.scale
        return out if out.shape[1:3] == (s * h, s * w) else out[:, : s * h, : s * w].contiguous()


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm of an NCHW tensor as flax's ``BatchNorm`` computes it: batch
    statistics over (N, H, W) in f32 with the biased variance E[x^2] -
    E[x]^2, and the running statistics updated with that biased variance
    (``nn.BatchNorm2d`` would use the unbiased one). ``momentum`` 0.1 is
    flax's 0.9. The state_dict keys are ``nn.BatchNorm2d``'s. ``stat_mean``:
    the batch statistics' mean (``torch.mean``; a data-parallel step sets the
    global one, ``parallel/dp.py::BatchComm.stat_mean``)."""

    stat_mean = staticmethod(torch.mean)

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = self.stat_mean(xf, dim=(0, 2, 3))
            var = (self.stat_mean(xf * xf, dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
                    self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class DiscriminatorVGG128(nn.Module):
    """NHWC (N, H, W, in_nc) -> (N, 1) f32 logits. The first linear layer
    takes the last feature map flattened in NCHW order (the reference
    state_dict's ``linear1``), sized by the train crop: H/32 x W/32 x 8 nf
    (4 x 4 x 512 at HR 128). ``train``: BatchNorm on batch statistics;
    ``update_stats``: then also update the running ones (the D update does,
    G's adversarial loss does not)."""

    def __init__(self, in_nc: int = 3, nf: int = 64, norm: str = "batch", hr_size=(128, 128),
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.names = [f"{b}_{i}" for b in range(5) for i in (0, 1)]
        feats = [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf, 8 * nf]
        cin = in_nc
        for j, (name, cout) in enumerate(zip(self.names, feats)):
            k = 3 if j % 2 == 0 else 4
            use_norm = norm == "batch" and j > 0
            conv = nn.Conv2d(cin, cout, k, stride=1 + j % 2, padding=(k - 1) // 2, bias=not use_norm)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * math.sqrt(2.0 / (cin * k * k)))
                if conv.bias is not None:
                    conv.bias.zero_()
            self.add_module(f"conv{name}", conv)
            if use_norm:
                self.add_module(f"bn{name}", FlaxBatchNorm2d(cout, eps=1e-5, momentum=0.1))
            cin = cout
        h, w = int(hr_size[0]) // 32, int(hr_size[1]) // 32
        self.linear1 = nn.Linear(cin * h * w, 100)
        self.linear2 = nn.Linear(100, 1)
        with torch.no_grad():
            for lin in (self.linear1, self.linear2):  # lecun normal, zero bias (flax Dense)
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) / math.sqrt(lin.in_features))
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = True, update_stats: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for name in self.names:
            conv = getattr(self, f"conv{name}")
            bias = None if conv.bias is None else conv.bias.to(dt)
            x = F.conv2d(x, conv.weight.to(dt), bias, stride=conv.stride, padding=conv.padding)
            bn = getattr(self, f"bn{name}", None)
            if bn is not None:
                x = bn(x, train, update_stats)
            x = F.leaky_relu(x, 0.2)
        x = x.reshape(x.shape[0], -1)
        x = F.leaky_relu(F.linear(x, self.linear1.weight.to(dt), self.linear1.bias.to(dt)), 0.2)
        return F.linear(x, self.linear2.weight.to(dt), self.linear2.bias.to(dt)).float()


# VGG19 conv plan: (features, convs per stage); a 2x2 max pool after each stage
_VGG19_CFG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class VGG19FeatureExtractor(nn.Module):
    """VGG19 features up to ``feature_layer`` (torchvision's ``features``
    index; 34 = conv5_4 before its ReLU), frozen. ``features.{i}`` holds the
    conv at torchvision index i, so a torchvision ``vgg19`` state_dict loads
    into it (:meth:`load_torchvision`). NHWC (N, H, W, 3) RGB in [0, 1] ->
    (N, h, w, 512) f32."""

    def __init__(self, feature_layer: int = 34, use_input_norm: bool = True,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.feature_layer = feature_layer
        self.use_input_norm = use_input_norm
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        layers, idx, cin = [], 0, 3
        for feats, n in _VGG19_CFG:
            for _ in range(n):
                if idx > feature_layer:
                    break
                conv = nn.Conv2d(cin, feats, 3, padding=1)
                with torch.no_grad():
                    conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * math.sqrt(1.0 / (cin * 9)))
                    conv.bias.zero_()
                layers += [conv, nn.ReLU()]
                idx, cin = idx + 2, feats
            if idx <= feature_layer:
                layers.append(nn.MaxPool2d(2))
                idx += 1
        self.features = nn.Sequential(*layers[: feature_layer + 1])
        self.requires_grad_(False)
        self.eval()

    def load_torchvision(self, state: dict) -> None:
        """Load the ``features.{i}`` entries of a torchvision ``vgg19``
        state_dict that this truncation holds (strictly: each must be there)."""
        own = self.state_dict()
        missing = [k for k in own if k not in state]
        if missing:
            raise KeyError(f"VGG19 state_dict lacks {missing[:4]}...")
        self.load_state_dict({k: state[k] for k in own}, strict=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(dt), m.bias.to(dt), padding=1)
            else:
                x = m(x)
        return x.permute(0, 2, 3, 1).float()
