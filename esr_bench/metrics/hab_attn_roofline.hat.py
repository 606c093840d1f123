"""``hat_attn_kernel<16>``'s share of its roofline in a ``hat`` cell: the
HABs' window-16 attention. The bound of one launch
(``roofline_hat.attention_bound_s``: q, k, v read and the output written
once in bf16, against 4 x 256 C FLOP a token) times the launches the port
counted in the traced window's forwards (the ``hab_attn`` counter's deltas
on its ``eval.forward`` roots), over the kernel's device time in the trace.
Against a port without the kernel or the counter, None. Moves
``eval_hr_mp_per_s``."""

from esr_bench import program, roofline_hat

UNIT = "%"


def read(ctx):
    recorded = program.spans() if ctx.kind == "hat" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    launches = sum((r.counts or {}).get("hab_attn", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "hat_attn_kernel<16>" in name]
    if not launches or not times:
        return None
    bound = roofline_hat.attention_bound_s(ctx.cfg, *ctx.counts["lr_shape"], oca=False)
    return 100.0 * launches * bound / (sum(times) / 1e6)
