"""Spans and counters inside the program, and the attribution of a
profiler's device activity to them.

A span is a row (name, start_ns, end_ns, parent): `parent` is the index of
the span open around it, -1 at the top. Its times are `time.time_ns()`,
the clock of torch.profiler's host events, so a CUDA runtime launch event
falls inside the spans open when it was made. `span(name)` is a context
manager and `traced(name)` a decorator; a span opened directly inside one
of the same name adds no row, since either row would take the same
kernels. `count(name, n)` adds to a counter, on the device where `n` is a
tensor, with no synchronization. `take()` returns the rows and counters
and clears them; it synchronizes once, reading the counters.

Off (the default), `span` returns one shared no-op context, `traced`
calls straight through and `count` returns at once: no kernel,
synchronization or allocation. `enabled(spans, counters)` turns either on
for a block: `render_tiles(profile=True)` turns on the spans for its
frame; nothing in the program turns on the counters, as each adds a
reduction kernel where it counts. State is per process: one tracer, on
one thread.

The program's spans are a fixed set, each where its work is enqueued:
render (`render_tiles`), camera, tile, sss, generation, refract (the
rough-refraction spawn), march (the shadow march through non-opaque
surfaces), surface, material, bsdf, light, rng, query and splat. Its
counters: `lanes` (rays of every shaded generation) and `live_lanes`
(those that hit a surface); `refr_lanes` (rays of every refraction spawn)
and `refr_live_lanes` (those still carrying weight after roulette).

`device_events` reads a torch.profiler run of the card and `attribute`
charges each kernel, copy and fill to the innermost span open at its
launch (the runtime event of the same correlation id), and each idle gap
of the card to the span open at the launch of the kernel that ended it,
or to `queued` where that launch came before the gap began (the card
then idled between two kernels it already held). `host_table` gives each
span's host time less its children's, for a CPU scene.
"""
from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from typing import NamedTuple

# label of device work launched outside every span, and of kernels the
# profiler recorded no launch for
OUTSIDE = "outside"
UNMATCHED = "unmatched"
QUEUED = "queued"
# the stages whose idle gaps are the tile's own; the rest are the frame
# driver's (`render_tiles`, the camera, the splat)
STAGES = ("tile", "sss")
# the profiler's activity types of device work
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# slices of the card's time over which its clock's offset from the host's
# is taken as constant: on an H100 host it drifted by up to 0.85 us a ms
SLICE_NS = 50_000_000
# the CUDA runtime calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("tracer", "name", "index")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        t = self.tracer
        self.index = len(t.rows)
        t.rows.append([self.name, time.time_ns(), 0,
                       t.open[-1] if t.open else -1])
        t.open.append(self.index)

    def __exit__(self, *exc):
        t = self.tracer
        t.rows[self.index][2] = time.time_ns()
        t.open.pop()
        return False


class Tracer:
    def __init__(self):
        self.spans_on = False
        self.counters_on = False
        self.rows = []
        self.open = []
        self.counters = {}

    def span(self, name: str):
        if not self.spans_on or (
                self.open and self.rows[self.open[-1]][0] == name):
            return _NOOP
        return _Span(self, name)

    def count(self, name: str, n) -> None:
        """Add `n` to counter `name`: an int, or a tensor whose sum is
        added on its device."""
        if not self.counters_on:
            return
        if not isinstance(n, int):
            n = n.sum()
        c = self.counters.get(name)
        self.counters[name] = n if c is None else c + n

    def take(self):
        """(rows, counters) since the last take, as tuples and ints."""
        if self.open:
            raise RuntimeError(f"take() inside open spans: "
                               f"{[self.rows[i][0] for i in self.open]}")
        rows = [tuple(r) for r in self.rows]
        names = [k for k, v in self.counters.items() if not isinstance(v, int)]
        counters = {k: v for k, v in self.counters.items()
                    if isinstance(v, int)}
        if names:
            import torch

            vals = torch.stack([self.counters[k].to(torch.int64)
                                for k in names]).tolist()
            counters.update(zip(names, vals))
        self.rows, self.counters = [], {}
        return rows, counters


TRACER = Tracer()


def span(name: str):
    """A span around a block: `with span("light"): ...`."""
    return TRACER.span(name)


def traced(name: str):
    """A span around every call of the decorated function."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not TRACER.spans_on:
                return fn(*args, **kwargs)
            with TRACER.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n) -> None:
    TRACER.count(name, n)


def take():
    return TRACER.take()


@contextmanager
def enabled(spans: bool = False, counters: bool = False):
    """Turn the spans and/or the counters on inside the block (a False
    leaves that part as it was)."""
    before = TRACER.spans_on, TRACER.counters_on
    TRACER.spans_on = before[0] or spans
    TRACER.counters_on = before[1] or counters
    try:
        yield
    finally:
        TRACER.spans_on, TRACER.counters_on = before


def host_table(rows) -> dict:
    """{name: [self ns, rows]}: each span's time on the host less its
    child spans'."""
    out = {}
    for name, s, e, parent in rows:
        r = out.setdefault(name, [0, 0])
        r[0] += e - s
        r[1] += 1
        if parent >= 0:
            out[rows[parent][0]][0] -= e - s
    return out


# ---------------------------------------------------------------------------
# Attribution of the card's activity
# ---------------------------------------------------------------------------

def innermost(rows, times) -> list:
    """For each host time, the index of the innermost span open then (a
    span holds [start, end)), or -1: one sorted sweep."""
    ev = []
    for i, (_, s, e, _) in enumerate(rows):
        if e > s:     # an empty span holds no time
            ev.append((s, 1, i))
            ev.append((e, 0, -i))     # children (higher index) close first
    ev.extend((t, 2, j) for j, t in enumerate(times))
    ev.sort()
    out = [-1] * len(times)
    stack = []
    for _, kind, i in ev:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            i = -i
            if stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        else:
            out[i] = stack[-1] if stack else -1
    return out


def device_events(prof):
    """(kernels, launches, syncs) of a finished torch.profiler run that
    recorded the card: kernels [(start_ns, end_ns, correlation id)] of
    every kernel, copy and fill; launches {correlation id: host start_ns of
    the earliest host event of that id} (the CUDA runtime calls); and the
    host start_ns of each runtime call that waits for the card."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, syncs = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            # older torch names no activity type: every device event counts
            kind = getattr(e, "activity_type", None)
            if kind is None or kind() in DEVICE_KINDS:
                s = e.start_ns()
                kernels.append((s, s + e.duration_ns(),
                                e.correlation_id()
                                or e.linked_correlation_id()))
        elif e.name() in SYNC_CALLS:
            syncs.append(e.start_ns())
        else:
            host.append(e)
    ids = {k[2] for k in kernels}
    launches = {}
    for e in host:
        c = e.correlation_id()
        if c in ids:
            t = e.start_ns()
            if t < launches.get(c, t + 1):
                launches[c] = t
    return kernels, launches, syncs


class Attribution(NamedTuple):
    """The card's time by span, in ns. `device_ns` and `launches` are
    keyed by span name, OUTSIDE or UNMATCHED; `idle_ns` and `gaps` (the
    count of idle gaps) by those and QUEUED; `syncs` counts the runtime
    calls that waited for the card by the span they were made in.
    `driver_idle_ns` is the idle time of gaps whose late launch was in a
    span outside every tile and sss span. `skew_ns` is the least offset
    of the card's clock from the host's over the window's slices
    (`attribute`)."""

    device_ns: dict
    launches: dict
    idle_ns: dict
    gaps: dict
    syncs: dict
    driver_idle_ns: int
    kernel_ns: int        # the window's device work, summed
    busy_ns: int          # its union
    window_ns: int        # from the window's start to its last end
    kernels: int
    unmatched: int        # kernels with no launch recorded
    skew_ns: int


def attribute(rows, kernels, launches, syncs=(), since_ns=None
              ) -> Attribution:
    """Charge `kernels`, `launches` and `syncs` (`device_events`) to the
    spans `rows` (`take`).

    The profiler stamps the card's work on a clock that stands apart from
    the host's and drifts against it: some kernels then seem to start
    before their launch. In each SLICE_NS of the card's time, the least
    start less launch of the kernels in it and in the slices on either
    side is taken as the offset there (a kernel launched onto an idle card
    starts within microseconds), and a gap is `queued` where its kernel's
    launch came before the gap's start on the host's clock.

    With `since_ns`, the work and syncs before it are left out: the window
    opens at the end on the card of the last kernel launched before it,
    so the gap from there to the next kernel counts. A kernel with no
    launch is left out if it started before that end."""
    start = None
    keep = []
    for k in kernels:
        t = launches.get(k[2])
        if since_ns is not None and t is not None and t < since_ns:
            start = k[1] if start is None else max(start, k[1])
        else:
            keep.append((k[0], k[1], t))
    if start is not None:
        keep = [k for k in keep if k[2] is not None or k[0] >= start]
    keep.sort(key=lambda k: (k[0], k[2] is None, k[2] or 0))
    syncs = [t for t in syncs if since_ns is None or t >= since_ns]
    low = {}
    for s, _, t in keep:
        if t is not None:
            b = s // SLICE_NS
            low[b] = min(low.get(b, s - t), s - t)
    in_stage = []
    for name, _, _, parent in rows:
        in_stage.append(name in STAGES or (parent >= 0 and in_stage[parent]))
    at = innermost(rows, [k[2] for k in keep if k[2] is not None] + syncs)
    waits = {}
    for i in at[len(at) - len(syncs):]:
        lab = rows[i][0] if i >= 0 else OUTSIDE
        waits[lab] = waits.get(lab, 0) + 1
    at = iter(at)
    idx = [-2 if k[2] is None else next(at) for k in keep]
    device, count, idle, gaps = {}, {}, {}, {}
    driver = busy = total = 0
    cur = start if start is not None else (keep[0][0] if keep else 0)
    first = cur
    for (s, e, t), i in zip(keep, idx):
        lab = UNMATCHED if i == -2 else rows[i][0] if i >= 0 else OUTSIDE
        total += e - s
        device[lab] = device.get(lab, 0) + (e - s)
        count[lab] = count.get(lab, 0) + 1
        if s > cur:
            g = s - cur
            if t is not None and t < cur - min(
                    low.get(s // SLICE_NS + j, s - t) for j in (-1, 0, 1)):
                gl = QUEUED
            else:
                gl = lab
                if i >= 0 and not in_stage[i]:
                    driver += g
            idle[gl] = idle.get(gl, 0) + g
            gaps[gl] = gaps.get(gl, 0) + 1
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    return Attribution(device, count, idle, gaps, waits, driver, total, busy,
                       cur - first, len(keep),
                       sum(1 for k in keep if k[2] is None),
                       min(low.values(), default=0))
