"""Whole-image inference through HAT: ``images``' closed loop of
CEM-wrapped forwards on non-square LR images (``images.Traffic``'s loop and
``images.lr_images``, by import), with HAT's weights, reference and faults.

The mix's parameters are ``images``' (``images`` LR images of ``lr_h`` x
``lr_w``, ``z_draws`` 1: HAT has no Z, a ``pool`` of batches made on the card
from the seed, at most ``in_flight`` forwards enqueued). The check is
``eval``'s, against ``reference/hat.py``: ``sr_rel_err`` and
``cem_residual`` (``eval.compare``) of one answer per batch of the pool.
``faults()`` plants each fault of HAT's own mechanisms the check must see:
the HAB's shift dropped, the OCAB's keys cut to the query's own window, its
keys outside the map masked instead of scored at their bias, the channel
attention dropped (its scale 1), the whole CAB branch dropped.

This kind exists beside ``images`` because ``images`` and its readers tell
SwinIR from the RRDB nets by name; its readers are gated on ``hat``.
"""

from __future__ import annotations

import random

import torch
import torch.nn.functional as F

from esr_bench import reference as ref
from esr_bench.reference import hat as ref_hat
from esr_bench.reference import swinir as ref_swinir
from esr_bench.traffic import images
from esr_bench.traffic.eval import compare, port_options

FAULTS = ("shift_dropped", "oca_keys_cut", "oca_edge_masked", "ca_dropped", "cab_dropped")
WINDOWS = 256  # windows a step of a faulty attention


def seeded_weights(b) -> dict:
    """HAT's weights from the run's seed; the LayerNorm weights are 1 plus the drawn noise."""
    sd = b.weights(ref_hat.generator_shapes(b.cfg), "weights.G")
    for key in sd:
        if key.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
            sd[key].add_(1.0)
    return sd


def reference_answer(b, sd: dict, lr: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """The reference's answer for one batch (``prec``: ``"fp8"`` is the control)."""
    cem = ref.Cem(int(b.cfg["scale"]), b.device)
    with ref.exact():
        return cem.project(ref_hat.generator(sd, b.cfg, lr, None, prec), lr, tf32=prec != "f32")


def judge_answers(b, sd: dict, pool: list, answers: list) -> tuple[list[tuple[str, float, float]], int]:
    """The check of one answer per batch of the pool, and the answers failed
    (an image over a limit, or a batch that no forward of the window answered)."""
    limits = b.workload["limits"]
    cem = ref.Cem(int(b.cfg["scale"]), b.device)
    rel_all, res_all, failed = [], [], 0
    for (lr, _), answer in zip(pool, answers):
        if answer is None:
            failed += 1
            continue
        rel, residual = compare(cem, answer, reference_answer(b, sd, lr), lr)
        failed += sum(r > limits["sr_rel_err"] for r in rel) + (residual > limits["cem_residual"])
        rel_all += rel
        res_all.append(residual)
    checks = [("sr_rel_err", max(rel_all, default=float("inf")), limits["sr_rel_err"]),
              ("cem_residual", max(res_all, default=float("inf")), limits["cem_residual"])]
    return checks, failed


def _heads(x: torch.Tensor, heads: int, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, heads, ws^2, C / heads) in f32."""
    b, h, w, c = x.shape
    x = x.float().reshape(b, h // ws, ws, w // ws, ws, heads, c // heads)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, heads, ws * ws, c // heads)


def _attend(q, k, v, bias, mask, dtype) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias + mask) v in f32, a few windows at a
    time; ``mask`` (windows, Nq, Nk), repeating over the batch."""
    out = []
    for i in range(0, q.shape[0], WINDOWS):
        s = q[i:i + WINDOWS] @ k[i:i + WINDOWS].transpose(-2, -1) * q.shape[-1] ** -0.5 + bias
        if mask is not None:
            s = s + mask[torch.arange(i, i + s.shape[0], device=q.device) % mask.shape[0]][:, None]
        out.append(s.softmax(-1) @ v[i:i + WINDOWS])
    return torch.cat(out).to(dtype)


def _unwindows(o: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    nh, hd = o.shape[1], o.shape[3]
    return o.view(b, h // ws, w // ws, nh, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, nh * hd)


def faulty_hab(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int,
               shift: int) -> torch.Tensor:  # noqa: ARG001
    """The HAB attention with its shift dropped (so no mask either), as the port's blocks call it."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (_heads(qkv[..., i * c:(i + 1) * c], heads, ws) for i in range(3))
    bias = ref_swinir.relative_bias(table_t.t().float(), ws)
    return _unwindows(_attend(q, k, v, bias, None, qkv.dtype), b, h, w, ws)


def faulty_oca(fault: str):
    """The OCAB attention with ``fault`` planted, as the port's blocks call
    it: ``oca_keys_cut``, each window's keys its own ws x ws (the centre of
    its key window, scored at those keys' bias); ``oca_edge_masked``, the
    keys outside the map masked (-inf) instead of scored at their bias."""

    def attend(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int, wse: int) -> torch.Tensor:
        b, h, w, c3 = qkv.shape
        c, pad = c3 // 3, (wse - ws) // 2
        q = _heads(qkv[..., :c], heads, ws)
        kv = F.unfold(qkv[..., c:].float().permute(0, 3, 1, 2), wse, stride=ws, padding=pad)
        kv = kv.view(b, 2, heads, c // heads, wse * wse, -1).permute(1, 0, 5, 2, 4, 3).reshape(2, -1, heads, wse * wse,
                                                                                              c // heads)
        index = ref_hat.oca_index(ws, wse, qkv.device)
        bias = table_t.float()[:, index]  # (heads, ws^2, wse^2)
        e = torch.arange(wse, device=qkv.device)
        inner = (e >= pad) & (e < pad + ws) if fault == "oca_keys_cut" else e >= 0
        valid = (inner[:, None] & inner[None, :]).flatten()[None].expand(kv.shape[1] // b, -1)
        if fault == "oca_edge_masked":
            ones = torch.ones(1, 1, h, w, device=qkv.device)
            valid = F.unfold(ones, wse, stride=ws, padding=pad)[0].t() > 0.5  # (windows, wse^2)
        mask = torch.zeros(valid.shape, device=qkv.device).masked_fill(~valid, float("-inf"))[:, None, :]
        return _unwindows(_attend(q, kv[0], kv[1], bias, mask.expand(-1, ws * ws, -1), qkv.dtype), b, h, w, ws)

    return attend


def faulty_channel_attention(fault: str):
    """The channel attention and residual with ``fault`` planted:
    ``ca_dropped``, the sigmoid's scale 1 (r = u + scale cx);
    ``cab_dropped``, the CAB branch gone (r = u)."""

    def residual(cx, u, w1, b1, w2, b2, scale):  # noqa: ARG001
        if fault == "cab_dropped":
            return u
        return (u.float() + scale * cx[..., :u.shape[-1]].float()).to(u.dtype)

    return residual


def plant(fault: str) -> tuple[str, object]:
    """The name in ``models/blocks.py`` a fault replaces, and what replaces it."""
    if fault == "shift_dropped":
        return "hab_attention", faulty_hab
    if fault.startswith("oca_"):
        return "oca_attention", faulty_oca(fault)
    return "channel_attention", faulty_channel_attention(fault)


class Traffic(images.Traffic):
    """``images.Traffic``'s loop with HAT's weights, check and faults."""

    def setup(self) -> None:
        from esr_tpu_torch.cem import CEMConf, make_cem
        from esr_tpu_torch.models.base_model import make_eval_forward
        from esr_tpu_torch.models.networks import define_G

        b, cfg, mix = self.b, self.b.cfg, self.b.mix
        self.sd = seeded_weights(b)
        self.g = define_G(port_options(cfg), device=b.device)
        self.g.load_state_dict(self.sd, strict=True)
        self.cem_scale = int(cfg["scale"])
        self.cem = make_cem(CEMConf(scale=self.cem_scale), device=b.device)
        self.fwd = make_eval_forward(self.g, self.cem)
        gen = b.generator("inputs")
        n, h, w = mix["images"], mix["lr_h"], mix["lr_w"]
        self.batch = n
        self.pool = [(images.lr_images(gen, n, h, w, b.device), None) for _ in range(mix["pool"])]
        self.hr_px = self.batch * h * w * self.cem_scale**2
        self.MIN_UNITS = len(self.pool)  # a window answers every batch of the pool, however short
        self.in_flight: list = []
        self.sampler = random.Random(b.generator("samples").initial_seed())
        self.seen = [0] * len(self.pool)
        self.kept: list = [None] * len(self.pool)
        for i in range(len(self.pool)):  # capture the graph, then replay each batch once
            self.unit(-1 - i)
        self.drain()

    def judge(self) -> list[tuple[str, float, float]]:
        checks, self.failed = judge_answers(self.b, self.sd, self.pool, self.kept)
        return checks

    def control(self) -> list[tuple[str, float, float]]:
        """The check with the control's answers in the program's place."""
        answers = [reference_answer(self.b, self.sd, lr, "fp8") for lr, _ in self.pool]
        return judge_answers(self.b, self.sd, self.pool, answers)[0]

    def faults(self) -> dict[str, list]:
        """The check of the port's answers with each fault planted: the
        port's generator, one of its ``models/blocks.py`` functions replaced
        (:func:`plant`), run eagerly."""
        from esr_tpu_torch.models import blocks
        from esr_tpu_torch.models.base_model import make_eval_forward
        from esr_tpu_torch.models.networks import define_G

        g = define_G(port_options(self.b.cfg), device=self.b.device)
        g.load_state_dict(self.sd, strict=True)
        out = {}
        for fault in FAULTS:
            name, planted = plant(fault)
            real = getattr(blocks, name)
            setattr(blocks, name, planted)
            try:
                fwd = make_eval_forward(g, self.cem, graphs=False)
                answers = [fwd(lr, z) for lr, z in self.pool]
            finally:
                setattr(blocks, name, real)
            out[fault] = judge_answers(self.b, self.sd, self.pool, answers)[0]
        return out
