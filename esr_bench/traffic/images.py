"""Whole-image inference: back-to-back forwards of the CEM-wrapped generator
on non-square LR images (a DIV2K photograph's LR size, ragged against the
kernels' tiles), with any of the port's generators.

The mix's parameters: ``images`` LR images of ``lr_h`` x ``lr_w``, each
with ``z_draws`` Z draws (a net without Z takes one), make a batch of
``images * z_draws``; a ``pool`` of such batches is made on the card from
the seed (each image the smooth random field plus fine noise of
``eval.lr_tiles``, drawn at its own size) and cycled, in a closed loop that
keeps at most ``in_flight`` forwards enqueued ahead of the card. The timed
call is the port's ``make_eval_forward(g, cem)``, a CUDA graph replay per
call; answers stay on the card.

The check is ``eval``'s: one answer per batch of the pool, drawn uniformly
from the window, against the plain reference of the configuration's
generator (``reference/nets.py`` for RRDBNet and SRResNet,
``reference/swinir.py`` for SwinIR): ``sr_rel_err`` and ``cem_residual``
(``eval.compare``). For SwinIR, ``faults()`` plants each fault of the
attention the check must see (its shift, its mask, its bias, one head).
"""

from __future__ import annotations

import random

import torch
import torch.nn.functional as F

from esr_bench import reference as ref
from esr_bench.reference import swinir as ref_swinir
from esr_bench.roofline_swinir import is_swinir
from esr_bench.traffic.eval import compare, port_options

FAULTS = ("shift_dropped", "mask_dropped", "bias_dropped", "head_zeroed")


def generator_shapes(cfg: dict) -> dict:
    return (ref_swinir if is_swinir(cfg) else ref).generator_shapes(cfg)


def seeded_weights(b) -> dict:
    """The configuration's generator weights from the run's seed; SwinIR's
    LayerNorm weights are 1 plus the drawn noise."""
    sd = b.weights(generator_shapes(b.cfg), "weights.G")
    if is_swinir(b.cfg):
        for key in sd:
            if key.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
                sd[key].add_(1.0)
    return sd


def lr_images(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """``n`` LR images (n, h, w, 3) in [0, 1]: a smooth random field (bicubic
    from 16 x 16) plus fine noise, so that every frequency is present."""
    base = torch.rand((n, 3, 16, 16), generator=gen, device=device)
    x = F.interpolate(base, size=(h, w), mode="bicubic", align_corners=False)
    x = x + 0.05 * torch.randn((n, 3, h, w), generator=gen, device=device)
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def reference_answer(b, sd: dict, lr: torch.Tensor, z, prec: str = "f32") -> torch.Tensor:
    """The reference's answer for one batch (``prec``: ``"fp8"`` is the control)."""
    cem = ref.Cem(int(b.cfg["scale"]), b.device)
    gen = ref_swinir.generator if is_swinir(b.cfg) else ref.generator
    with ref.exact():
        return cem.project(gen(sd, b.cfg, lr, z, prec), lr, tf32=prec != "f32")


def judge_answers(b, sd: dict, pool: list, answers: list) -> tuple[list[tuple[str, float, float]], int]:
    """The check of one answer per batch of the pool, and the answers failed
    (an image over a limit, or a batch that no forward of the window answered)."""
    limits = b.workload["limits"]
    cem = ref.Cem(int(b.cfg["scale"]), b.device)
    rel_all, res_all, failed = [], [], 0
    for (lr, z), answer in zip(pool, answers):
        if answer is None:
            failed += 1
            continue
        rel, residual = compare(cem, answer, reference_answer(b, sd, lr, z), lr)
        failed += sum(r > limits["sr_rel_err"] for r in rel) + (residual > limits["cem_residual"])
        rel_all += rel
        res_all.append(residual)
    checks = [("sr_rel_err", max(rel_all, default=float("inf")), limits["sr_rel_err"]),
              ("cem_residual", max(res_all, default=float("inf")), limits["cem_residual"])]
    return checks, failed


def faulty_attention(fault: str):
    """A window attention with one fault planted, in plain PyTorch (f32
    scores and softmax), as the port's blocks call it:
    ``(qkv, bias, heads, ws, shift) -> (B, Hp, Wp, C)``."""

    def attend(qkv: torch.Tensor, bias: torch.Tensor, heads: int, ws: int, shift: int) -> torch.Tensor:
        b, h, w, c3 = qkv.shape
        c, n = c3 // 3, ws * ws
        hd = c // heads
        shift = 0 if fault == "shift_dropped" else shift
        x = torch.roll(qkv.float(), (-shift, -shift), (1, 2)) if shift else qkv.float()
        x = x.reshape(b, h // ws, ws, w // ws, ws, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
        q, k, v = x.reshape(3, -1, heads, n, hd)
        attn = q @ k.transpose(-2, -1) * hd**-0.5
        if fault != "bias_dropped":
            attn = attn + bias.float()
        if shift and fault != "mask_dropped":
            mask = ref_swinir.shift_mask(h, w, ws, shift, qkv.device)
            attn = (attn.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
        o = attn.softmax(-1) @ v
        if fault == "head_zeroed":
            o[:, 0] = 0.0
        o = o.view(b, h // ws, w // ws, heads, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
        o = torch.roll(o, (shift, shift), (1, 2)) if shift else o
        return o.to(qkv.dtype)

    return attend


class Traffic:
    SPANS = ("forward", "wait")

    def __init__(self, bench):
        self.b = bench
        self.failed = 0

    def setup(self) -> None:
        from esr_tpu_torch.cem import CEMConf, make_cem
        from esr_tpu_torch.models.base_model import make_eval_forward
        from esr_tpu_torch.models.networks import define_G

        b, cfg, mix = self.b, self.b.cfg, self.b.mix
        self.sd = seeded_weights(b)
        self.g = define_G(port_options(cfg), device=b.device)
        self.g.load_state_dict(self.sd, strict=True)
        self.nz = cfg["network_G"].get("num_latent_channels", 0)
        self.cem_scale = int(cfg["scale"])
        self.cem = make_cem(CEMConf(scale=self.cem_scale), device=b.device)
        self.fwd = make_eval_forward(self.g, self.cem)
        gen = b.generator("inputs")
        n, draws, h, w = mix["images"], mix["z_draws"] if self.nz else 1, mix["lr_h"], mix["lr_w"]
        self.batch = n * draws
        self.pool = []
        for _ in range(mix["pool"]):
            lr = lr_images(gen, n, h, w, b.device).repeat_interleave(draws, 0)
            z = None
            if self.nz:
                z = torch.rand((self.batch, h, w, self.nz), generator=gen, device=b.device) * 2.0 - 1.0
            self.pool.append((lr, z))
        self.hr_px = self.batch * h * w * self.cem_scale**2
        self.MIN_UNITS = len(self.pool)  # a window answers every batch of the pool, however short
        self.in_flight: list = []
        self.sampler = random.Random(b.generator("samples").initial_seed())
        self.seen = [0] * len(self.pool)
        self.kept: list = [None] * len(self.pool)
        for i in range(len(self.pool)):  # capture the graph, then replay each batch once
            self.unit(-1 - i)
        self.drain()

    def unit(self, i: int) -> None:
        if len(self.in_flight) >= self.b.mix["in_flight"]:
            with self.b.span("wait"):
                self.in_flight.pop(0).synchronize()
        slot = i % len(self.pool)
        with self.b.span("forward"):
            out = self.fwd(*self.pool[slot])
        if self.b.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self.in_flight.append(done)
        if i >= 0:  # a unit of the window (set-up and warm units are numbered below 0)
            self.seen[slot] += 1
            if self.sampler.random() * self.seen[slot] < 1.0:
                self.kept[slot] = out

    def drain(self) -> None:
        self.b.sync()
        self.in_flight.clear()

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"eval_hr_mp_per_s": (units * self.hr_px / 1e6 / window_s, "MP/s")}

    def counts(self, units: int) -> dict:
        return {"forwards": units, "lr_shape": (self.batch, self.b.mix["lr_h"], self.b.mix["lr_w"])}

    def release(self) -> None:
        del self.fwd, self.g

    def judge(self) -> list[tuple[str, float, float]]:
        checks, self.failed = judge_answers(self.b, self.sd, self.pool, self.kept)
        return checks

    def control(self) -> list[tuple[str, float, float]]:
        """The check with the control's answers in the program's place."""
        answers = [reference_answer(self.b, self.sd, lr, z, "fp8") for lr, z in self.pool]
        return judge_answers(self.b, self.sd, self.pool, answers)[0]

    def faults(self) -> dict[str, list]:
        """The check of the port's answers with each attention fault planted
        (SwinIR; none for a net without attention): the port's generator,
        its attention replaced by ``faulty_attention``, run eagerly."""
        if not is_swinir(self.b.cfg):
            return {}
        from esr_tpu_torch.models import blocks
        from esr_tpu_torch.models.base_model import make_eval_forward
        from esr_tpu_torch.models.networks import define_G

        g = define_G(port_options(self.b.cfg), device=self.b.device)
        g.load_state_dict(self.sd, strict=True)
        out, real = {}, blocks.window_attention
        try:
            for fault in FAULTS:
                blocks.window_attention = faulty_attention(fault)
                fwd = make_eval_forward(g, self.cem, graphs=False)
                answers = [fwd(lr, z) for lr, z in self.pool]
                out[fault] = judge_answers(self.b, self.sd, self.pool, answers)[0]
        finally:
            blocks.window_attention = real
        return out
