"""The port's own spans in a traced window, for the metrics that read them.

The port (``esr_tpu_torch/utils/profiler.py``) records its spans in memory
while a ``torch.profiler`` profile runs, so in a ``--trace 1`` run it holds
the spans of the traced window, of the units run under the profiler before
it, and of a traced window that failed and was traced once more. A unit is
one root span of a name (a GAN step ``train.step``, a click ``explore.tool``
and ``explore.render``, a forward ``eval.forward``), so the window's roots
are the last ``ctx.units`` of their name.

A span's times are the host's ``perf_counter_ns``, the clock the harness
times its own spans on; ``ctx.spans`` holds those on the card's clock,
shifted by one offset. Each program root begins inside the harness span
that called it, so the offset is at least that span's start on the card
less the root's start on the host; the largest such bound over the
window's pairs errs, early, by the least time the host spent between the
two starts (microseconds).

Against a port without the recorder, :func:`spans` returns None, and so
does every metric that reads it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from esr_bench.harness import _merge


def spans() -> list | None:
    """The port's recorded spans, oldest first (None: the port has no recorder)."""
    try:
        from esr_tpu_torch.utils.profiler import recorded
    except ImportError:
        return None
    return recorded().spans


def window_roots(recorded: list, name: str, n: int) -> list:
    """The last ``n`` root spans named ``name``, oldest first ([] when fewer)."""
    roots = [s for s in recorded if s.parent == -1 and s.name == name]
    return roots[-n:] if n and len(roots) >= n else []


def under(recorded: list, roots: list) -> list[list]:
    """For each of ``roots``, the spans below it (by their parents)."""
    parent = {s.id: s.parent for s in recorded}
    index = {r.id: i for i, r in enumerate(roots)}
    out: list[list] = [[] for _ in roots]
    for s in recorded:
        top = s.parent
        while top in parent and top not in index:
            top = parent[top]
        if top in index:
            out[index[top]].append(s)
    return out


def covered_ns(intervals) -> int:
    """The time a set of (start, end) intervals covers, overlaps counted once."""
    return sum(b - a for a, b in _merge(intervals))


def host_and_wait_ns(recorded: list, roots: list) -> tuple[int, int]:
    """Over ``roots``: the time the host worked (the roots' time less what
    their ``waits`` descendants cover) and the time it waited on the card."""
    host = wait = 0
    for root, below in zip(roots, under(recorded, roots)):
        w = covered_ns([(s.start_ns, s.end_ns) for s in below if s.waits])
        host += root.end_ns - root.start_ns - w
        wait += w
    return host, wait


def card_offset_us(harness: list, roots: list) -> float | None:
    """The offset (us) that puts a host time ``t_ns`` on the card's clock at
    ``t_ns / 1e3 + offset``, from ``harness`` spans ``(name, start_us,
    end_us)`` on the card's clock each enclosing the root of the same place
    in ``roots``; None when they do not pair (unequal counts, or a root that
    would not fit inside its harness span)."""
    if not roots or len(harness) != len(roots):
        return None
    offset = max(a - r.start_ns / 1e3 for (_, a, _), r in zip(harness, roots))
    if any(r.end_ns / 1e3 + offset > b + 1.0 for (_, _, b), r in zip(harness, roots)):
        return None
    return offset


def overlap_us(busy: list, a: float, b: float) -> float:
    """The card's busy time (merged intervals, us) inside ``[a, b)``."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


def idle_by_span(busy: list, window: tuple[float, float], harness: list, program: list) -> dict[str, float]:
    """The card's idle seconds in ``window`` (us on the card's clock) put
    down to what the host was in when each gap began: ``"<harness
    span>/<program span>"`` for the innermost program span open then,
    ``"<harness span>"`` where none was, ``"(no span)"`` outside the harness
    spans. ``harness``: ``(name, start_us, end_us)``, not nested;
    ``program``: ``(name, start_us, end_us)`` on the card's clock, nested."""
    w0, w1 = window
    h = sorted((a, b, n) for n, a, b in harness)
    h_starts = [a for a, _, _ in h]
    p = sorted((a, -b, n) for n, a, b in program)  # an enclosing span before the spans it holds
    p_starts = [a for a, _, _ in p]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    out: dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        j = bisect.bisect_right(h_starts, a) - 1
        label = h[j][2] if j >= 0 and a < h[j][1] else "(no span)"
        k = bisect.bisect_right(p_starts, a) - 1
        while k >= 0 and -p[k][1] <= a:  # the latest begun that is still open: the innermost
            k -= 1
        if k >= 0 and label != "(no span)":
            label = f"{label}/{p[k][2]}"
        out[label] += (b - a) / 1e6
    return dict(out)
