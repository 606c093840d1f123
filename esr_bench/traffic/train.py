"""GAN training as ``train.py`` runs it: ``feed_data`` and
``optimize_parameters(step)`` for each step of the port's ``SRRaGANModel``
(``create_model``), back to back with no wait of the harness's own, the
losses fetched every ``print_freq`` steps as the CLI logs them, no
checkpoint or validation in the window.

The mix's parameters: a ``pool`` of batches of ``batch`` HR uint8 crops of
``hr_size``^2, made on the card from the seed and handed to the model from
the host as the loader does, cycled. The model's own seed
(``train.manual_seed``, the symmetries and Z of each step) is drawn from
the run's seed.

Set-up builds the model once, loads the seeded weights and runs step 1,
which captures the step's CUDA graph; the same object goes on into the
window. The checked steps are the window's first ``check_steps``, run as
the window runs them: enqueued back to back, each step's ``l_g`` and
``l_d`` copied on the card as it is enqueued and read once the window has
drained. The harness keeps Adam's first moments after step 1 (``m_1 = (1
- b1) g_1``), and after the last checked step the parameters and D's
running statistics (copies on the card, in stream order). Once the window
has closed the reference runs steps 1 to the last checked step from the
same weights and batches, and the check compares, by the worst leaf of G
and D:

- ``loss_gap``: ``|l - l_ref| / max(|l_ref|, |l_ref| at step 1)`` of ``l_g``
  and ``l_d`` at each step: D's loss falls from ln 2 towards 0 within a few
  steps, and a gap relative to a loss near 0 swings by rounding alone;
- ``grad_gap``: ``| |g_1| - |g_1,ref| | / max(|g_1,ref|, median leaf's)``;
- ``change_gap``: the same of each leaf's change over the steps, and of D's
  running statistics;
- ``grad_diff``: the median leaf's ``|g_1 - g_1,ref| / |g_1,ref|``, the
  larger of G's and D's: the gap of norms averages rounding away, so it
  cannot tell bf16 from the fp8 control, and this number can.

All three leave out the leaves whose reference gradient is under a thousandth of
the median leaf's: their gradient is nought but for rounding (the CEM
projection removes a constant shift of the output, so ``conv_last.bias``
has none), and Adam moves them by the rounding alone.
"""

from __future__ import annotations

import functools

import torch

from esr_bench.harness import sub_seed
from esr_bench.reference import generator_shapes
from esr_bench.reference import train as reft
from esr_bench.traffic.eval import lr_tiles, port_options

BUFFERS = ("running_mean", "running_var")


class Traffic:
    SPANS = ("feed", "optimize_parameters", "log")

    def __init__(self, bench):
        self.b = bench
        self.failed = 0
        self.MIN_UNITS = bench.mix["check_steps"]

    def _weights(self) -> tuple[dict, dict, dict]:
        b, cfg = self.b, self.b.cfg
        g = b.weights(generator_shapes(cfg), "weights.G")
        d = b.weights(reft.d_shapes(cfg["network_D"]["nf"], self.b.mix["hr_size"]), "weights.D")
        for k in list(d):
            if k.startswith("bn") and k.endswith(".weight"):
                d[k].fill_(1.0)
                name = k[: -len(".weight")]
                d[f"{name}.running_mean"] = torch.zeros_like(d[k])
                d[f"{name}.running_var"] = torch.ones_like(d[k])
                d[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=b.device)
        f = b.weights(reft.vgg_shapes(cfg["train"]["feature_layer"]), "weights.F")
        return g, d, f

    def setup(self) -> None:
        from esr_tpu_torch.models import create_model

        b, cfg, mix = self.b, self.b.cfg, self.b.mix
        self.manual_seed = sub_seed(b.seed, "train") % 2**31
        opt = port_options(cfg)
        opt.update(is_train=True, path={}, logger={"print_freq": mix["print_freq"]},
                   datasets={"train": {"HR_size": mix["hr_size"], "batch_size": mix["batch"],
                                       "use_flip": True, "use_rot": True}})
        opt["train"] = dict(cfg["train"], manual_seed=self.manual_seed)
        self.model = m = create_model(opt, device=b.device)
        self.sd = self._weights()
        for net, sd in zip((m.g_module, m.d_module, m.f_module), self.sd):
            net.load_state_dict(sd, strict=True)
        gen = b.generator("inputs")
        self.pool = [(lr_tiles(gen, mix["batch"], mix["hr_size"], b.device) * 255.0).round().to(torch.uint8)
                     .cpu().numpy() for _ in range(mix["pool"])]
        self.names = {"G": [k for k, _ in m.g_module.named_parameters()],
                      "D": [k for k, _ in m.d_module.named_parameters()]}
        self.step, self.last, self.kept = 0, None, []
        self.unit(-1)  # step 1: captures the step's graph
        self.m1 = {"G": [t.clone() for t in m.g_opt.mu], "D": [t.clone() for t in m.d_opt.mu]}
        self.drain()

    def unit(self, i: int) -> None:
        m, mix = self.model, self.b.mix
        self.step += 1
        with self.b.span("feed"):
            m.feed_data({"HR": self.pool[(self.step - 1) % len(self.pool)]})
        with self.b.span("optimize_parameters"):
            m.optimize_parameters(self.step)
        if self.step % mix["print_freq"] == 0:
            with self.b.span("log"):
                m.get_current_losses()
        if i == 0:  # the window's first step: it and the next check_steps - 1 are checked
            self.last = self.step + mix["check_steps"] - 1
        if self.last is None or self.step <= self.last:  # a step to check: its losses, copied on the card
            self.kept.append(torch.stack([m._losses["l_g"], m._losses["l_d"]]).float())
        if self.step == self.last:
            self.after = {"G": {k: v.detach().clone() for k, v in m.g_module.named_parameters()},
                          "D": {k: v.detach().clone() for k, v in m.d_module.state_dict().items()
                                if k.endswith(BUFFERS) or k in self.names["D"]}}

    def drain(self) -> None:
        self.b.sync()

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"train_step_ms": (1e3 * window_s / units, "ms")}

    def counts(self, units: int) -> dict:
        return {"steps": units, "batch": self.b.mix["batch"], "hr_size": self.b.mix["hr_size"]}

    def release(self) -> None:
        del self.model

    def reference(self, prec: str = "f32", batch_keep: int | None = None) -> list[dict]:
        """The reference's steps from the same weights and batches
        (``prec``: ``"fp8"`` is the control; ``batch_keep``: a planted fault)."""
        g, d, f = self.sd
        batches = [self.pool[(s - 1) % len(self.pool)] for s in range(1, self.last + 1)]
        with torch.no_grad():
            return reft.train_steps(self.b.cfg, g, d, f, batches, self.manual_seed + 3, self.b.device, prec,
                                    batch_keep)

    @functools.cached_property
    def expected(self) -> list[dict]:
        """The f32 reference's steps, which every check compares with."""
        return self.reference()

    def judge(self) -> list[tuple[str, float, float]]:
        b1 = {"G": self.b.cfg["train"]["beta1_G"], "D": self.b.cfg["train"]["beta1_D"]}
        grads = {net: dict(zip(self.names[net], (t / (1 - b1[net]) for t in self.m1[net]))) for net in ("G", "D")}
        if self.last is None or len(self.kept) < self.last:  # the window ended before its checked steps did
            self.failed = 1
            return [(k, float("inf"), v) for k, v in self.b.workload["limits"].items()]
        losses = [dict(zip(("l_g", "l_d"), t.tolist())) for t in self.kept]
        return self._check(losses, grads, self.after)

    def control(self) -> list[tuple[str, float, float]]:
        """The check with the reference in fp8 (and TF32 CEM) in the program's place."""
        return self._check_reference(self.reference("fp8"))

    def faults(self) -> dict[str, list]:
        """The check against a planted fault: the loss over half the batch."""
        return {"half_batch": self._check_reference(self.reference(batch_keep=self.b.mix["batch"] // 2))}

    def _check_reference(self, run: list[dict]) -> list[tuple[str, float, float]]:
        last = run[-1]
        after = {"G": last["params_G"], "D": {**last["params_D"], **last["stats_D"]}}
        return self._check([{"l_g": r["l_g"], "l_d": r["l_d"]} for r in run],
                           {"G": run[0]["grads_G"], "D": run[0]["grads_D"]}, after)

    def _check(self, losses: list, grads: dict, after: dict) -> list[tuple[str, float, float]]:
        limits, ref = self.b.workload["limits"], self.expected
        scale = {k: abs(ref[0][k]) for k in ("l_g", "l_d")}
        loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), scale[k]) for p, r in zip(losses, ref) for k in scale)
        ref_grads = {"G": ref[0]["grads_G"], "D": ref[0]["grads_D"]}
        last = ref[-1]
        ref_after = {"G": last["params_G"], "D": {**last["params_D"], **last["stats_D"]}}
        before = {"G": self.sd[0], "D": self.sd[1]}
        grad_gap = grad_diff = change_gap = 0.0
        for net in ("G", "D"):
            rn = {k: v.double().norm().item() for k, v in ref_grads[net].items()}
            gn = {k: grads[net][k].double().norm().item() for k in rn}
            med = float(torch.tensor(list(rn.values())).median())
            live = [k for k in rn if rn[k] >= 1e-3 * med]
            grad_gap = max(grad_gap, max(abs(gn[k] - rn[k]) / max(rn[k], med) for k in live))
            diff = [(grads[net][k].double() - ref_grads[net][k].double()).norm().item() / rn[k] for k in live]
            grad_diff = max(grad_diff, float(torch.tensor(diff).median()))
            moved = live + [k for k in ref_after[net] if k not in rn]
            rc = {k: (ref_after[net][k].double() - before[net][k].double()).norm().item() for k in moved}
            pc = {k: (after[net][k].double() - before[net][k].double()).norm().item() for k in moved}
            med_c = float(torch.tensor(list(rc.values())).median())
            change_gap = max(change_gap, max(abs(pc[k] - rc[k]) / max(rc[k], med_c) for k in moved))
        numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "grad_diff": grad_diff, "change_gap": change_gap}
        self.failed = int(any(v > limits[k] for k, v in numbers.items()))
        return [(k, v, limits[k]) for k, v in numbers.items()]
