"""One editor user in a closed loop: select a region, apply a tool, look at
the result.

The mix's parameters: an LR image of ``lr_size``^2 made on the card from the
seed; the session is the port's ``ExplorationSession``. Click i selects a
seeded box of ``box_min``..``box_max`` LR pixels a side (``boxes`` of them,
cycled), runs tool ``i mod len(tools)`` of the fixed cycle (non-adaptive,
``z_steps`` Z steps), and renders the SR (``current_sr``). The cycle is
fixed, so every window holds the same mix of tools whatever the seed.

The check draws ``samples`` clicks of the window by reservoir sampling
(seeded), keeps the Z before and after each and its rendered SR, and once
the window has closed compares them with the plain reference:

- ``sr_rel_err`` and ``cem_residual``: the render of the click's Z against
  the reference's, as in the eval cells;
- ``z_search_shortfall``: the reference's objective at the program's Z,
  ``(L_prog - L_ref) / |L_in - L_ref|``, where ``L_ref`` is reached by the
  reference's own search from the same Z and ``L_in`` is the start: 0 when
  the program's search does as well as the reference's, 1 when it leaves Z
  where it was;
- ``z_outside_change``: the largest change of Z outside the searched crop
  (the paste-back leaves it exactly as it was).
"""

from __future__ import annotations

import random
import time

import torch

from esr_bench import reference as ref
from esr_bench.reference import explore
from esr_bench.traffic.eval import compare, lr_tiles, port_options


class Traffic:
    SPANS = ("select", "render", "tool.increase_variance", "tool.decrease_variance", "tool.smooth", "tool.brightness")

    def __init__(self, bench):
        self.b = bench
        self.failed = 0

    def setup(self) -> None:
        from esr_tpu_torch.cem import CEMConf, make_cem
        from esr_tpu_torch.explore.session import ExplorationSession
        from esr_tpu_torch.models.networks import define_G

        b, cfg, mix = self.b, self.b.cfg, self.b.mix
        t = time.perf_counter()
        self.scale = int(cfg["scale"])
        self.sd = b.weights(ref.generator_shapes(cfg), "weights.G")
        g = define_G(port_options(cfg), device=b.device)
        g.load_state_dict(self.sd, strict=True)
        size = mix["lr_size"]
        gen = b.generator("inputs")
        self.lr = lr_tiles(gen, 1, size, b.device)
        n = mix["boxes"]
        sides = torch.randint(mix["box_min"], mix["box_max"] + 1, (n, 2), generator=gen, device=b.device)
        corner = (torch.rand((n, 2), generator=gen, device=b.device) * (size + 1 - sides)).long()
        self.boxes = [(y, x, y + h, x + w) for (y, x), (h, w) in zip(corner.tolist(), sides.tolist())]
        self.session = ExplorationSession(
            g, make_cem(CEMConf(scale=self.scale), device=b.device), self.lr.cpu().numpy(),
            num_latent_channels=cfg["network_G"]["num_latent_channels"], scale=self.scale,
            n_steps=mix["z_steps"], opt_lr=mix["z_lr"])
        self.sampler = random.Random(b.generator("samples").initial_seed())
        self.kept: list = []
        self.seen = 0
        self.setup_phases = {"session": time.perf_counter() - t}
        for i in range(len(mix["tools"])):  # capture each tool's Z search and the render
            t = time.perf_counter()
            self.unit(-1 - i)
            self.setup_phases[f"warm click {i}"] = time.perf_counter() - t

    def unit(self, i: int) -> None:
        s, tool, box = self.session, self.b.mix["tools"][i % len(self.b.mix["tools"])], self.boxes[i % len(self.boxes)]
        z_before = s.z.copy()
        with self.b.span("select"):
            s.select_rect(*(v * self.scale for v in box))
        with self.b.span(f"tool.{tool['name']}"):
            if tool["name"] == "brightness":
                s.brightness(tool["level"])
            else:
                getattr(s, tool["name"])()
        with self.b.span("render"):
            sr = s.current_sr()
        if i < 0:
            return
        self.seen += 1
        record = {"box": box, "tool": tool, "z_before": z_before, "z_after": s.z.copy(), "sr": sr}
        if len(self.kept) < self.b.mix["samples"]:
            self.kept.append(record)
        else:
            j = self.sampler.randrange(self.seen)
            if j < len(self.kept):
                self.kept[j] = record

    def drain(self) -> None:
        self.b.sync()

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"click_ms": (1e3 * window_s / units, "ms")}

    def counts(self, units: int) -> dict:
        return {"clicks": units, "z_steps": units * self.b.mix["z_steps"]}

    def release(self) -> None:
        del self.session

    def judge(self) -> list[tuple[str, float, float]]:
        checks, self.failed = self._judge([(r, r["z_after"], torch.as_tensor(r["sr"], device=self.b.device))
                                           for r in self.kept])
        return checks

    def control(self) -> list[tuple[str, float, float]]:
        """The check with the control (the reference in fp8 and TF32) in the program's place."""
        cem = ref.Cem(self.scale, self.b.device)
        answers = []
        for r in self.kept:
            z = self._search(cem, r, "fp8")
            with torch.no_grad(), ref.exact():
                sr = cem.project(ref.generator(self.sd, self.b.cfg, self.lr, z, "fp8"), self.lr, tf32=True)
            answers.append((r, z.cpu().numpy(), sr))
        return self._judge(answers)[0]

    def _search(self, cem: ref.Cem, r: dict, prec: str) -> torch.Tensor:
        """The whole Z map after the reference's search of click ``r`` (``prec`` as the reference's)."""
        y, x, size, lr_c, m_c = self._crop(r)
        z = torch.as_tensor(r["z_before"], device=self.b.device)
        fwd = self._forward(cem, prec)
        with ref.exact():
            zc = explore.z_search(fwd, lr_c, z[:, y : y + size, x : x + size], m_c, r["tool"], self.b.mix["z_steps"],
                                  self.b.mix["z_lr"])
        z = z.clone()
        z[:, y : y + size, x : x + size] = zc
        return z

    def _forward(self, cem: ref.Cem, prec: str):
        return lambda lr, z: cem.project(ref.generator(self.sd, self.b.cfg, lr, z, prec), lr, tf32=prec != "f32")

    def _crop(self, r: dict):
        s, (y0, x0, y1, x1) = self.scale, r["box"]
        h, w = self.lr.shape[1:3]
        y, x, size = explore.crop_box((y0, x0, y1, x1), h, w)
        mask = torch.zeros((h * s, w * s), device=self.b.device)
        mask[y0 * s : y1 * s, x0 * s : x1 * s] = 1.0
        return y, x, size, self.lr[:, y : y + size, x : x + size], mask[y * s : (y + size) * s, x * s : (x + size) * s]

    def _judge(self, answers: list) -> tuple[list[tuple[str, float, float]], int]:
        """The check of the sampled clicks' answers, and the clicks failed."""
        limits = self.b.workload["limits"]
        cem = ref.Cem(self.scale, self.b.device)
        rel_all, res_all, short_all, out_all, failed = [], [], [], [], 0
        for r, z_after, sr in answers:
            z_after = torch.as_tensor(z_after, device=self.b.device)
            with torch.no_grad():
                expect = self._forward(cem, "f32")(self.lr, z_after)
                rel, residual = compare(cem, sr, expect, self.lr)
            y, x, size, lr_c, m_c = self._crop(r)
            z_ref = self._search(cem, r, "f32")
            fwd = self._forward(cem, "f32")
            with torch.no_grad(), ref.exact():
                z_in = torch.as_tensor(r["z_before"], device=self.b.device)
                loss = [explore.objective(r["tool"], fwd(lr_c, z[:, y : y + size, x : x + size]), m_c).item()
                        for z in (z_in, z_ref, z_after)]
            shortfall = (loss[2] - loss[1]) / max(abs(loss[0] - loss[1]), 1e-30)
            outside = (z_after - z_in).abs()
            outside[:, y : y + size, x : x + size] = 0
            numbers = {"sr_rel_err": rel[0], "cem_residual": residual, "z_search_shortfall": shortfall,
                       "z_outside_change": outside.max().item()}
            failed += any(v > limits[k] for k, v in numbers.items())
            rel_all.append(rel[0])
            res_all.append(residual)
            short_all.append(shortfall)
            out_all.append(numbers["z_outside_change"])
        worst = lambda v: max(v, default=float("inf"))  # noqa: E731
        return [("sr_rel_err", worst(rel_all), limits["sr_rel_err"]),
                ("cem_residual", worst(res_all), limits["cem_residual"]),
                ("z_search_shortfall", worst(short_all), limits["z_search_shortfall"]),
                ("z_outside_change", worst(out_all), limits["z_outside_change"])], failed + (not answers)
