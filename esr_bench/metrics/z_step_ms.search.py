"""Device milliseconds a Z step of the Z search alone: the card's busy time
inside the port's ``zopt.search`` spans (the search's buffers loaded, its
replays, the losses fetched), over the Z steps the port counted in the
traced window's clicks (``z_steps``, each ``explore.tool`` root's delta).
``z_step_ms`` also holds the crop, the objective's upload and the paste.
The spans are put on the card's clock by the harness's ``tool.*`` spans
that enclose them (``program.card_offset_us``). Moves ``click_ms``."""

from esr_bench import program

UNIT = "ms"


def read(ctx):
    recorded = program.spans() if ctx.kind == "clicks" and ctx.busy else None
    roots = program.window_roots(recorded or [], "explore.tool", ctx.units)
    offset = program.card_offset_us([s for s in ctx.spans if s[0].startswith("tool.")], roots)
    steps = sum(r.counts.get("z_steps", 0) for r in roots)
    if offset is None or not steps:
        return None
    searches = [s for below in program.under(recorded, roots) for s in below if s.name == "zopt.search"]
    busy_us = sum(program.overlap_us(ctx.busy, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
                  for s in searches)
    return busy_us / 1e3 / steps if busy_us > 0 else None
