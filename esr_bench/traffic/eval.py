"""Batch tile inference: back-to-back forwards of the CEM-wrapped generator.

The mix's parameters: ``tiles`` LR tiles of ``lr_size``^2, each with
``z_draws`` Z draws, make a batch of ``tiles * z_draws``; a ``pool`` of such
batches is made on the card from the seed and cycled, in a closed loop that
keeps at most ``in_flight`` forwards enqueued ahead of the card. Answers
stay on the card. The timed call is the port's ``make_eval_forward(g,
cem)``, a CUDA graph replay per call.

The check keeps, for each batch of the pool, one answer drawn uniformly
from the window by reservoir sampling (a seeded host draw a forward), and
recomputes it with the plain reference once the window has closed:

- ``sr_rel_err``: the largest, over the images, of ``|answer - ref| /
  |ref - H^+ lr|`` (L2 norms): the answer's distance from the reference
  against the detail the generator adds to the consistent upscale;
- ``cem_residual``: the largest ``|H answer - lr|``, H applied in float64:
  the consistency the CEM guarantees, to float32 rounding.
"""

from __future__ import annotations

import random

import torch
import torch.nn.functional as F

from esr_bench import reference as ref


def port_options(cfg: dict) -> dict:
    """The port's options dict for the configuration (its own keys dropped)."""
    return {k: v for k, v in cfg.items() if k not in ("name", "source", "reduced", "assumed", "guarantees")}


def lr_tiles(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """``n`` LR tiles (n, size, size, 3) in [0, 1]: a smooth random field
    (bicubic from 16 x 16) plus fine noise, so that every frequency is present."""
    base = torch.rand((n, 3, 16, 16), generator=gen, device=device)
    x = F.interpolate(base, size=(size, size), mode="bicubic", align_corners=False)
    x = x + 0.05 * torch.randn((n, 3, size, size), generator=gen, device=device)
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


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
        self.sd = b.weights(ref.generator_shapes(cfg), "weights.G")
        self.g = define_G(port_options(cfg), device=b.device)
        self.g.load_state_dict(self.sd, strict=True)
        self.nz = cfg["network_G"].get("num_latent_channels", 0)
        self.cem_scale = int(cfg["scale"])
        self.fwd = make_eval_forward(self.g, make_cem(CEMConf(scale=self.cem_scale), device=b.device))
        gen = b.generator("inputs")
        tiles, draws, size = mix["tiles"], mix["z_draws"], mix["lr_size"]
        self.batch = tiles * draws
        self.pool = []
        for _ in range(mix["pool"]):
            lr = lr_tiles(gen, tiles, size, b.device).repeat_interleave(draws, 0)
            z = None
            if self.nz:
                z = torch.rand((self.batch, size, size, self.nz), generator=gen, device=b.device) * 2.0 - 1.0
            self.pool.append((lr, z))
        self.hr_px = self.batch * (size * self.cem_scale) ** 2
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
        size = self.b.mix["lr_size"]
        return {"forwards": units, "lr_shape": (self.batch, size, size)}

    def release(self) -> None:
        del self.fwd, self.g

    def judge(self) -> list[tuple[str, float, float]]:
        checks, self.failed = judge_answers(self.b, self.sd, self.pool, self.kept)
        return checks

    def control(self) -> list[tuple[str, float, float]]:
        """The check with the control's answers in the program's place."""
        answers = [reference_answer(self.b, self.sd, lr, z, "fp8") for lr, z in self.pool]
        return judge_answers(self.b, self.sd, self.pool, answers)[0]


def reference_answer(b, sd: dict, lr: torch.Tensor, z, prec: str = "f32") -> torch.Tensor:
    """The reference's answer for one batch (``prec``: ``"fp8"`` is the control)."""
    cem = ref.Cem(int(b.cfg["scale"]), b.device)
    with ref.exact():
        return cem.project(ref.generator(sd, b.cfg, lr, z, prec), lr, tf32=prec != "f32")


def compare(cem: ref.Cem, answer: torch.Tensor, expect: torch.Tensor, lr: torch.Tensor) -> tuple[list, float]:
    """Per image ``|answer - expect| / |expect - H^+ lr|``, and ``max |H answer - lr|``."""
    with ref.exact():
        detail = (expect - cem.upscale(lr.float())).double().flatten(1).norm(dim=1)
        rel = ((answer.double() - expect.double()).flatten(1).norm(dim=1) / detail).tolist()
        residual = (cem.downsample(answer.double()) - lr.double()).abs().max().item()
    return rel, residual


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
