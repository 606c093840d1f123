"""A stand-in for CUDA graph capture on the CPU, for the tests of the port's
graphed paths (``esr_tpu_torch/utils/graphs.py``).

``install(monkeypatch)`` turns every ``GraphedStep`` on and replaces its
capture: the first call runs the step (the warm-up, a real step) and keeps
empty outputs of the same shapes as the "captured" ones; each later call
(a replay) runs the step again and writes its results into those outputs in
place, as a replay writes a graph's static outputs. An answer that the next
replay overwrites then shows on the CPU; a Python value that a capture
would freeze does not (the stand-in reruns the step). Returns the list of
captured steps.
"""

import torch

from esr_tpu_torch.utils.graphs import GraphedStep


def _empty_like(out):
    if isinstance(out, torch.Tensor):
        return torch.empty_like(out)
    return {k: _empty_like(v) for k, v in out.items()}


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for k in dst:
            _copy_into(dst[k], src[k])


class FakeGraph:
    def __init__(self, step: GraphedStep):
        self.step = step

    def replay(self) -> None:
        _copy_into(self.step.out, self.step.fn())


def install(monkeypatch) -> list:
    captured = []
    init = GraphedStep.__init__

    def enabled_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.enabled = True

    def capture(self):
        out = self.fn()
        self.out = _empty_like(out)
        self.graph = FakeGraph(self)
        captured.append(self)
        return out

    monkeypatch.setattr(GraphedStep, "__init__", enabled_init)
    monkeypatch.setattr(GraphedStep, "_warm_up_and_capture", capture)
    return captured
