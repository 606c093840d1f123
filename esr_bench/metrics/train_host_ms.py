"""Host milliseconds a GAN step: the port's ``train.step`` spans over the
traced window's steps, less the time their ``waits`` spans cover. On the
H100 the wait is the pipeline's synchronising upload of ``imresize``'s
matrices (``resize.upload``), which waits for the step before to end, and
the graph's launch (``graphs.replay``), which returns as the card drains
it; the HR upload (``train.upload``) is non-blocking and waits well under
a millisecond. Read from the traced window, whose profiler slows the
host's launches: on the H100 it read 2.91 ms a step there against 2.36 in
an untraced window with recording on, ~23% high (PERF.md). Moves
``train_step_ms``."""

from esr_bench import program

UNIT = "ms"


def read(ctx):
    recorded = program.spans() if ctx.kind == "train" else None
    roots = program.window_roots(recorded or [], "train.step", ctx.units)
    if not roots:
        return None
    host, _ = program.host_and_wait_ns(recorded, roots)
    return host / 1e6 / len(roots)
