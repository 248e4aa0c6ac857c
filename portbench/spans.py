"""The port's own spans, for the per-layer metrics that read them.

A reader marks the server's tracer in ``at_window(env)``: at the
window's open and at its close, ``mark`` takes the wall time, the count
of root spans closed and of those the tracer's ring let go, and the
ring's roots. From the two marks, ``window_roots`` gives the roots that
closed in the window and ``setup_roots`` those that closed before it,
or None where the ring no longer holds all of them: a reader then reads
nothing rather than a part. A program whose tracer keeps no such ring
(``mark`` absent) gives None too.

Span times are Unix seconds (``Span.start``/``end``), the clock the
profiler's events are on (``devtrace.Events``, nanoseconds).
``breakdown`` (self-time shares, time by span name), ``idle_by_span``
(device-idle time by the innermost open span) and ``clock_offsets``
(profiler range against span start) read a traced run's window for a
caller that holds its roots and events.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple

from portbench import devtrace

# The spans inside which the server runs the executor: the dispatcher's
# flush, a pipelined batch's drain, and a request on the direct path.
EXECUTOR_SPANS = ("Coalescer.flush", "Coalescer.finish", "API.Query")

Mark = Tuple[float, int, int, list]


def mark(env: Any) -> Optional[Mark]:
    """(Unix time, roots closed, roots evicted, the ring's roots oldest
    first) of the server's tracer, or None where it keeps no such
    ring."""
    take = getattr(getattr(env.api, "tracer", None), "mark", None)
    return take() if take is not None else None


def window_roots(snap: Optional[tuple]
                 ) -> Optional[Tuple[list, float, float]]:
    """(roots closed between the marks, open time, close time), or None
    where a mark is missing or the ring let go of a root closed after
    the open."""
    if snap is None or snap[0] is None or snap[1] is None:
        return None
    (t_open, closed0, _, _), (t_close, _, evicted1, roots) = snap
    if evicted1 > closed0:
        return None
    return roots[closed0 - evicted1:], t_open, t_close


def setup_roots(snap: Optional[tuple]) -> Optional[list]:
    """The roots closed before the window's open, or None where a mark
    is missing or the ring had let any go by then."""
    if snap is None or snap[0] is None:
        return None
    _, _, evicted0, roots = snap[0]
    return None if evicted0 else roots


def walk(roots: Sequence[Any]) -> Iterator[Any]:
    stack = list(reversed(roots))
    while stack:
        s = stack.pop()
        yield s
        stack.extend(reversed(s.children))


def outermost(roots: Sequence[Any], name: str) -> List[Any]:
    """The spans named ``name`` with no ancestor of that name."""
    out, stack = [], list(roots)
    while stack:
        s = stack.pop()
        if s.name == name:
            out.append(s)
        else:
            stack.extend(s.children)
    return out


def duration(span: Any) -> float:
    return span.end - span.start


def self_time(span: Any) -> float:
    """The span's seconds that no child covers."""
    covered = union([(max(c.start, span.start), min(c.end, span.end))
                     for c in span.children])
    return duration(span) - sum(b - a for a, b in covered)


def union(ivs: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, sorted, the empty ones dropped."""
    return devtrace.merged([("", a, b) for a, b in sorted(ivs)],
                           float("-inf"), float("inf"))


def span_ns(span: Any) -> Tuple[int, int]:
    return int(span.start * 1e9), int(span.end * 1e9)


def minus(ivs: Sequence[Tuple[int, int]], holes: Sequence[Tuple[int, int]]
          ) -> List[Tuple[int, int]]:
    """``ivs`` less ``holes``, both sorted unions of disjoint
    intervals."""
    out, j = [], 0
    for a, b in ivs:
        while j < len(holes) and holes[j][1] <= a:
            j += 1
        k, t = j, a
        while k < len(holes) and holes[k][0] < b:
            if holes[k][0] > t:
                out.append((t, holes[k][0]))
            t = max(t, holes[k][1])
            k += 1
        if t < b:
            out.append((t, b))
    return out


def median(xs: Sequence[float]) -> Optional[float]:
    if not xs:
        return None
    ys = sorted(xs)
    m = len(ys) // 2
    return ys[m] if len(ys) % 2 else (ys[m - 1] + ys[m]) / 2


def breakdown(got: Tuple[list, float, float], events: Any = None,
              window_ns: Optional[Tuple[int, int]] = None) -> dict:
    """Of the spans that closed in the window (``window_roots``'s
    value): the median self-time share of the outermost
    ``Executor.call`` and of ``Coalescer.flush`` (the part of a span no
    child covers, over its duration); each name's count, summed
    duration and summed self time; and, given the profiler's events and
    the traced part of the window, ``idle_by_span`` and
    ``clock_offsets``."""
    roots, t_open, t_close = got
    closed = [s for s in walk(roots) if t_open <= s.end <= t_close]
    by = {}
    for s in closed:
        n, d, own = by.get(s.name, (0, 0.0, 0.0))
        by[s.name] = (n + 1, d + duration(s), own + self_time(s))

    def share(group):
        return median([self_time(s) / duration(s) for s in group
                       if duration(s) > 0])
    calls = [s for s in outermost(roots, "Executor.call")
             if t_open <= s.end <= t_close]
    out = {
        "self_share": {
            "Executor.call": share(calls),
            "Coalescer.flush": share([s for s in closed
                                      if s.name == "Coalescer.flush"])},
        "by_name": {k: {"n": n, "s": d, "self_s": own}
                    for k, (n, d, own) in sorted(
                        by.items(), key=lambda kv: -kv[1][2])},
    }
    if events is not None and window_ns is not None:
        out["idle_by_span"] = idle_by_span(roots, events, *window_ns)
        out["clock_offset_us"] = clock_offsets(roots, events)
    return out


def clock_offsets(roots: Sequence[Any], events: Any) -> dict:
    """For a few span names, how far (us) the profiler's last range of
    that name starts from the nearest span's wall-clock start: the join
    of spans and device events rests on this being small."""
    out = {}
    for name in ("HTTP.request", "Coalescer.flush", "Executor.call"):
        rng = events.ranges.get(name)
        starts = [span_ns(s)[0] for s in walk(roots) if s.name == name]
        if rng is not None and starts:
            out[name] = min(abs(rng[0] - t) for t in starts) / 1e3
    return out


def idle_by_span(roots: Sequence[Any], events: Any, lo: int, hi: int,
                 n: int = 10) -> list:
    """The ``n`` span names under which the card idled longest in
    [lo, hi), in seconds: at each idle moment the innermost open span
    of an executor tree (``EXECUTOR_SPANS`` and below) where one is
    open, else the innermost of any other (a request waiting in the
    handler), else "no span"."""
    flat = []  # (start, end, depth, in an executor tree, name)

    def add(s, depth, exe):
        exe = exe or s.name in EXECUTOR_SPANS
        a, b = span_ns(s)
        if b > lo and a < hi:
            flat.append((a, b, depth, exe, s.name))
        for c in s.children:
            add(c, depth + 1, exe)
    for r in roots:
        add(r, 0, False)
    idle = minus([(lo, hi)], devtrace.merged(events.device, lo, hi))
    cuts = sorted({t for a, b in idle for t in (a, b)}
                  | {t for a, b, *_ in flat for t in (a, b) if lo < t < hi})
    total = {}
    j = 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j == len(idle) or idle[j][0] >= b:
            continue
        open_ = [f for f in flat if f[0] <= a and f[1] >= b]
        best = max(open_, key=lambda f: (f[3], f[2]), default=None)
        name = best[4] if best is not None else "no span"
        total[name] = total.get(name, 0) + (b - a)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]
