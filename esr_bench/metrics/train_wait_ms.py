"""Milliseconds a GAN step in which the host waits on the card: the time
the port's ``waits`` spans cover inside its ``train.step`` spans (on the
H100, ``resize.upload`` and ``graphs.replay``), over the traced window's
steps. With ``train_host_ms`` it splits the traced step (98% of it on the
H100). The profiler lengthens the traced step, and the wait with it: 75.56
ms a step traced against 65.26 in an untraced window with recording on
(PERF.md). Moves ``train_step_ms``."""

from esr_bench import program

UNIT = "ms"


def read(ctx):
    recorded = program.spans() if ctx.kind == "train" else None
    roots = program.window_roots(recorded or [], "train.step", ctx.units)
    if not roots:
        return None
    _, wait = program.host_and_wait_ns(recorded, roots)
    return wait / 1e6 / len(roots)
