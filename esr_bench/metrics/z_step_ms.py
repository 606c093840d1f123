"""Device milliseconds a Z step in the click cell: the card's busy time
inside the harness's ``tool.*`` spans (a tool call ends with the Z map
fetched, so its replays finish inside its span), over the Z steps those
clicks ran. Moves ``click_ms``."""

UNIT = "ms"


def _overlap(busy, a, b):
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


def read(ctx):
    if ctx.kind != "clicks" or not ctx.counts["z_steps"]:
        return None
    tools = [(a, b) for name, a, b in ctx.spans if name.startswith("tool.")]
    if not tools:
        return None
    busy_us = sum(_overlap(ctx.busy, a, b) for a, b in tools)
    return busy_us / 1e3 / ctx.counts["z_steps"] if busy_us > 0 else None
