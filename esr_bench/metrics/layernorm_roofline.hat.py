"""``layernorm_kernel``'s share of its roofline in a ``hat`` cell: the
bound of one launch times the launches the port counted in the traced
window's forwards (the ``layernorm`` counter's deltas on its
``eval.forward`` roots: the patch norm, two a HAB or OCAB and the final
norm), over the kernel's device time in the trace. One launch normalises
every token of the padded LR map once: bytes 2 x 2 x ``embed_dim`` a token
(read and written once in bf16), FLOPs ~8 ``embed_dim`` a token, counted
but never deciding. Against a port without the kernel or the counter,
None. Moves ``eval_hr_mp_per_s``."""

from esr_bench import program, roofline, roofline_hat

UNIT = "%"


def bound_s(cfg: dict, n: int, h: int, w: int) -> float:
    """The least time one LayerNorm launch could take on the H100."""
    hp, wp = roofline_hat.padded(cfg, h, w)
    elems = float(cfg["network_G"]["embed_dim"]) * n * hp * wp
    return roofline.bound_s(8.0 * elems, 2.0 * 2 * elems)


def read(ctx):
    recorded = program.spans() if ctx.kind == "hat" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    launches = sum((r.counts or {}).get("layernorm", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "layernorm_kernel" in name]
    if not launches or not times:
        return None
    return 100.0 * launches * bound_s(ctx.cfg, *ctx.counts["lr_shape"]) / (sum(times) / 1e6)
