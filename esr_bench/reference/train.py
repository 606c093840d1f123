"""The explorable GAN's train step, written out (ESRGAN, Wang et al. 2018,
with the explorable fork's CEM, range and map losses, Bahat & Michaeli,
CVPR 2020), as functions of state dicts with the reference torch keys.

One step on a batch of HR crops (N, H, W, 3) in [0, 1]:

- data: each crop takes one of the 8 flip / rot90 symmetries; the LR is
  MATLAB's antialiased bicubic ``imresize(hr, 1/s)`` (symmetric borders);
  Z is uniform in [-1, 1] on the LR grid. The draws (the symmetries, then
  Z) come from a CPU ``torch.Generator`` seeded by
  ``SeedSequence([seed, step])``, in that order: the rule by which the port
  reproduces a step's data, worked out again here;
- ``hr <- P(hr, lr)`` and ``sr = P(G(lr, z), lr)``, P the CEM projection;
- G's loss: ``w_pix |sr - hr|_1 + w_fea |F(clip(sr)) - F(hr)|_1 +
  w_gan RaGAN_G(D(hr), D(sr)) + w_range overshoot(sr) + w_map map(sr, hr,
  z)``, D in training mode on the doubled batch [hr; sr] (batch statistics,
  the running ones left alone); F is VGG19 to ``features.34`` (conv5_4
  before its ReLU) after ImageNet normalisation;
- G's Adam update, then D's: RaGAN_D on D([hr; sr]) with sr detached, the
  running statistics updated (momentum 0.1, the biased variance, as flax);
- Adam as optax's (``m_hat / (sqrt(v_hat) + eps)``, eps 1e-8, b2 0.999).

RaGAN with BCE on logits: ``G: (bce(r - mean f, 0) + bce(f - mean r, 1))
/ 2``, ``D: (bce(r - mean f, 1) + bce(f - mean r, 0)) / 2``. The map loss is
``mean((mean_c std7(sr) - mean_c std7(hr) - 0.1 mean_c box7(z_up))^2)``
with Z upsampled by nearest neighbour (box and std over 7 x 7, zero
padding).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from esr_bench.reference.cem import Cem, _cubic
from esr_bench.reference.nets import conv8, generator

__all__ = ["d_shapes", "draws", "imresize", "train_steps", "vgg_shapes"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG19 = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
D_FEATS = (64, 64, 128, 128, 256, 256, 512, 512, 512, 512)


def vgg_shapes(layer: int = 34) -> dict:
    """``features.{i}`` conv weights and biases of VGG19 up to index ``layer``."""
    out, idx, cin = {}, 0, 3
    for feats, n in VGG19:
        for _ in range(n):
            if idx <= layer:
                out[f"features.{idx}.weight"] = ((feats, cin, 3, 3), 1.0)
                out[f"features.{idx}.bias"] = ((feats,), 0.01)
            idx, cin = idx + 2, feats
        idx += 1
    return out


def _d_names():
    return [f"{b}_{i}" for b in range(5) for i in (0, 1)]


def d_shapes(nf: int, hr: int) -> dict:
    """The VGG-128 discriminator's parameters, ``{key: (shape, gain)}`` as
    :func:`~esr_bench.reference.nets.generator_shapes` gives them (the
    BatchNorm scales and shifts are set to 1 and 0 by the benchmark, which
    adds the running statistics, 0 and 1)."""
    out, cin = {}, 3
    for j, name in enumerate(_d_names()):
        k, cout = (3 if j % 2 == 0 else 4), D_FEATS[j] * nf // 64
        out[f"conv{name}.weight"] = ((cout, cin, k, k), 1.0)
        if j == 0:
            out[f"conv{name}.bias"] = ((cout,), 0.01)
        else:
            out[f"bn{name}.weight"] = ((cout,), 0.0)
            out[f"bn{name}.bias"] = ((cout,), 0.0)
        cin = cout
    side = hr // 32
    out["linear1.weight"] = ((100, cin * side * side), 0.5)
    out["linear1.bias"] = ((100,), 0.0)
    out["linear2.weight"] = ((1, 100), 0.5)
    out["linear2.bias"] = ((1,), 0.0)
    return out


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """MATLAB ``imresize``'s (n_out, n_in) matrix of one axis: the cubic
    kernel (stretched by the scale when shrinking), symmetric borders,
    rows normalised to sum 1."""
    scale = n_out / n_in
    width = 4.0 / scale if scale < 1 else 4.0
    u = np.arange(1, n_out + 1) / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - width / 2)
    taps = left[:, None] + np.arange(int(math.ceil(width)) + 2)[None, :]
    w = scale * _cubic((u[:, None] - taps) * scale) if scale < 1 else _cubic(u[:, None] - taps)
    w = w / w.sum(1, keepdims=True)
    idx = np.mod(taps.astype(np.int64) - 1, 2 * n_in)
    idx = np.where(idx >= n_in, 2 * n_in - 1 - idx, idx)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.repeat(np.arange(n_out)[:, None], taps.shape[1], 1), idx), w)
    return m


def imresize(x: torch.Tensor, s: int) -> torch.Tensor:
    """NHWC ``x`` shrunk by ``s``, float32."""
    mh = torch.as_tensor(resize_matrix(x.shape[1], x.shape[1] // s), dtype=torch.float32, device=x.device)
    mw = torch.as_tensor(resize_matrix(x.shape[2], x.shape[2] // s), dtype=torch.float32, device=x.device)
    return torch.einsum("ow,nhwc->nhoc", mw, torch.einsum("oh,nhwc->nowc", mh, x.float()))


def draws(seed: int, step: int, n: int, lr_hw: tuple, nz: int) -> tuple[list[int], torch.Tensor]:
    """The step's symmetry codes and Z map (CPU), by the port's rule."""
    hi, lo = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(int(hi) << 32 | int(lo))
    codes = torch.randint(0, 8, (n,), generator=gen).tolist()
    return codes, torch.rand((n, *lr_hw, nz), generator=gen) * 2.0 - 1.0


def dihedral(img: torch.Tensor, code: int) -> torch.Tensor:
    """HWC: 0 identity, 1 flip W, 2 flip H, 3 both; 4-7 the same after a transpose."""
    if code >= 4:
        img = img.transpose(0, 1)
    dims = ((), (1,), (0,), (0, 1))[code % 4]
    return img.flip(dims) if dims else img


def _conv(x, w, b, prec, **kw):
    return conv8(x, w, b, **kw) if prec == "fp8" else F.conv2d(x, w, b, **kw)


def vgg(sd: dict, x: torch.Tensor, prec: str, layer: int = 34) -> torch.Tensor:
    """NHWC [0, 1] -> the features at ``layer`` (NCHW)."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    h = ((x - mean) / std).permute(0, 3, 1, 2)
    idx = 0
    for feats, n in VGG19:
        for _ in range(n):
            h = _conv(h, sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"], prec, padding=1)
            if idx == layer:
                return h
            h, idx = F.relu(h), idx + 2
        h, idx = F.max_pool2d(h, 2), idx + 1
    return h


def disc(sd: dict, x: torch.Tensor, prec: str, stats: dict | None = None) -> torch.Tensor:
    """Logits (N, 1) of NHWC ``x``, BatchNorm on the batch's statistics;
    ``stats``: where to write each BN layer's (mean, biased var)."""
    h = x.permute(0, 3, 1, 2)
    for j, name in enumerate(_d_names()):
        k = 3 if j % 2 == 0 else 4
        h = _conv(h, sd[f"conv{name}.weight"], sd.get(f"conv{name}.bias"), prec, stride=1 + j % 2, padding=(k - 1) // 2)
        if j:
            mean = h.mean((0, 2, 3))
            var = ((h * h).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            if stats is not None:
                stats[name] = (mean.detach(), var.detach())
            h = (h - mean[:, None, None]) * (sd[f"bn{name}.weight"] * torch.rsqrt(var + 1e-5))[:, None, None] \
                + sd[f"bn{name}.bias"][:, None, None]
        h = F.leaky_relu(h, 0.2)
    h = F.leaky_relu(F.linear(h.reshape(h.shape[0], -1), sd["linear1.weight"], sd["linear1.bias"]), 0.2)
    return F.linear(h, sd["linear2.weight"], sd["linear2.bias"])


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs())))


def _box(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    c, lo = x.shape[-1], (k - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, k - 1 - lo, lo, k - 1 - lo))
    return F.conv2d(xp, x.new_full((c, 1, k, k), 1.0 / (k * k)), groups=c).permute(0, 2, 3, 1)


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((_box(x * x) - _box(x) ** 2).clamp(min=1e-10))


def _g_loss(g_sd, d_sd, f_sd, cfg, cem, lr, hr, z, prec, batch_keep):
    t = cfg["train"]
    sr = cem.project(generator(g_sd, cfg, lr, z, prec), lr, tf32=prec != "f32")
    keep = slice(None) if batch_keep is None else slice(0, batch_keep)
    sr_k, hr_k, z_k = sr[keep], hr[keep], z[keep]
    with torch.no_grad():
        f_hr = vgg(f_sd, hr_k, prec)
    terms = {
        "l_g_pix": t["pixel_weight"] * (sr_k - hr_k).abs().mean(),
        "l_g_fea": t["feature_weight"] * (vgg(f_sd, sr_k.clamp(0.0, 1.0), prec) - f_hr).abs().mean(),
    }
    d_real, d_fake = disc(d_sd, torch.cat([hr_k, sr_k]), prec).chunk(2)
    terms["l_g_gan"] = t["gan_weight"] * (_bce(d_real - d_fake.mean(), 0.0) + _bce(d_fake - d_real.mean(), 1.0)) / 2
    terms["l_g_range"] = t["range_weight"] * ((sr_k - 1).clamp(min=0) + (-sr_k).clamp(min=0)).mean()
    f = sr.shape[1] // z.shape[1]
    z_up = z_k.repeat_interleave(f, 1).repeat_interleave(f, 2)
    gap = _std(sr_k).mean(-1) - _std(hr_k).mean(-1) - 0.1 * _box(z_up).mean(-1)
    terms["l_g_map"] = t["map_weight"] * (gap**2).mean()
    return sum(terms.values()), terms, sr.detach()


class _Adam:
    def __init__(self, params: dict, lr: float, b1: float):
        self.lr, self.b1, self.b2, self.t = lr, b1, 0.999, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            upd = (self.m[k] / (1 - self.b1**self.t)) / (torch.sqrt(self.v[k] / (1 - self.b2**self.t)) + 1e-8)
            params[k] = params[k] - self.lr * upd


def train_steps(cfg: dict, g_sd: dict, d_sd: dict, f_sd: dict, batches: list, seed: int, device,
                prec: str = "f32", batch_keep: int | None = None) -> list[dict]:
    """Steps 1..len(batches) from the given weights (copied, not changed) on
    the uint8 HR batches. Per step: the losses (``l_g``, ``l_d`` and G's
    terms), the gradients of step 1 (``grads_G``, ``grads_D``), and after
    the last step the parameters (``params_G``, ``params_D``) and D's
    running statistics (``stats_D``). ``prec``: ``"fp8"`` for the control;
    ``batch_keep``: the losses over the first rows only (a planted fault)."""
    t = cfg["train"]
    nz = cfg["network_G"]["num_latent_channels"]
    s = int(cfg["scale"])
    cem = Cem(s, device)
    g = {k: v.detach().clone().float() for k, v in g_sd.items()}
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    d = {k: v.detach().clone().float() for k, v in d_sd.items() if not k.endswith(buffers)}
    running = {k: v.detach().clone().float() for k, v in d_sd.items() if k.endswith(buffers[:2])}
    g_opt, d_opt = _Adam(g, t["lr_G"], t["beta1_G"]), _Adam(d, t["lr_D"], t["beta1_D"])
    out = []
    for step, batch in enumerate(batches, start=1):
        hr = torch.as_tensor(batch, device=device).float() / 255.0
        n = hr.shape[0]
        codes, z = draws(seed, step, n, (hr.shape[1] // s, hr.shape[2] // s), nz)
        hr = torch.stack([dihedral(hr[i], c) for i, c in enumerate(codes)])
        lr = imresize(hr, s)
        z = z.to(device)
        hr = cem.project(hr, lr, tf32=prec != "f32")
        with torch.enable_grad():
            for v in g.values():
                v.requires_grad_(True)
            l_g, terms, sr = _g_loss(g, d, f_sd, cfg, cem, lr, hr, z, prec, batch_keep)
            g_grads = dict(zip(g, torch.autograd.grad(l_g, list(g.values()))))
        g = {k: v.detach() for k, v in g.items()}
        g_opt.step(g, g_grads)
        keep = slice(None) if batch_keep is None else slice(0, batch_keep)
        stats: dict = {}
        with torch.enable_grad():
            for v in d.values():
                v.requires_grad_(True)
            d_real, d_fake = disc(d, torch.cat([hr[keep], sr[keep]]), prec, stats).chunk(2)
            l_d = (_bce(d_real - d_fake.mean(), 1.0) + _bce(d_fake - d_real.mean(), 0.0)) / 2
            d_grads = dict(zip(d, torch.autograd.grad(l_d, list(d.values()))))
        d = {k: v.detach() for k, v in d.items()}
        d_opt.step(d, d_grads)
        for name, (mean, var) in stats.items():
            running[f"bn{name}.running_mean"] = 0.9 * running[f"bn{name}.running_mean"] + 0.1 * mean
            running[f"bn{name}.running_var"] = 0.9 * running[f"bn{name}.running_var"] + 0.1 * var
        rec = {"l_g": l_g.item(), "l_d": l_d.item(), **{k: v.item() for k, v in terms.items()}}
        if step == 1:
            rec["grads_G"], rec["grads_D"] = g_grads, d_grads
        out.append(rec)
    out[-1].update(params_G=g, params_D=d, stats_D=running)
    return out
