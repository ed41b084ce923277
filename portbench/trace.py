"""``torch.profiler`` over part of a run's window, reduced to a timeline.

The method is the one the repository's chip smoke script uses: the
profiler records the host's operators and the card's kernels and copies
(CUPTI); kernel time is summed by name; the idle share is the part of the
window in which nothing ran on the card; and a trace that holds none of
the card's events, as ``torch.profiler`` now and then returns, is taken
again.  Here the timeline is kept, not only the sums, so that device time
can be split by request (each request is a ``record_function`` span of the
benchmark's own) and the card's idle gaps named by what the host was
doing in them.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

#: The benchmark's span around each request.
REQUEST_SPAN = "portbench.request"
#: The card's own work by the start of its name; any other name on the
#: card is a kernel.  (Annotations that mirror the host's spans on the
#: card's timeline are left out by name.)
_DEVICE_KINDS = (("Memcpy", "copy"), ("Memset", "memset"))


def _device_kind(name: str) -> str:
    for prefix, kind in _DEVICE_KINDS:
        if name.startswith(prefix):
            return kind
    return "kernel"


@dataclasses.dataclass
class Timeline:
    """One trace: the card's work, the host's operators and the request
    spans, each as (start_ns, end_ns, name), sorted by start; ``kinds``
    gives each device interval's kind (kernel, copy or memset), and
    ``origins`` the host time at which the operator that issued it
    started (its own start where no operator is linked to it), which puts
    it in the request that issued it whatever the skew between the host's
    and the card's clocks."""

    device: list
    kinds: list
    origins: list
    host: list
    spans: list

    @property
    def window(self) -> tuple[int, int]:
        return self.spans[0][0], self.spans[-1][1]

    def __post_init__(self):
        # _reach[i]: the latest end among device[:i + 1].
        self._reach, reach = [], 0
        for _, b, _ in self.device:
            reach = max(reach, b)
            self._reach.append(reach)
        # The device intervals in the order they were issued.
        self._issued = sorted(range(len(self.device)),
                              key=self.origins.__getitem__)
        self._issued_at = [self.origins[i] for i in self._issued]

    def busy_ns(self, lo: int, hi: int, kinds=None) -> int:
        """Nanoseconds of [lo, hi) in which the card ran something (of
        ``kinds``): the union of its intervals, clipped."""
        i = bisect.bisect_left(self.device, (lo,))
        while i > 0 and self._reach[i - 1] > lo:
            i -= 1
        total, end = 0, lo
        for j in range(i, len(self.device)):
            a, b, _ = self.device[j]
            if a >= hi:
                break
            if b <= end or (kinds is not None and self.kinds[j] not in kinds):
                continue
            a, b = max(a, end), min(b, hi)
            if b > a:
                total += b - a
                end = b
        return total

    def summed_ns(self, lo: int, hi: int, keep) -> int:
        """Summed device time of the intervals issued in [lo, hi) (by
        ``origins``) for which ``keep(name, kind)`` holds."""
        total = 0
        for k in range(bisect.bisect_left(self._issued_at, lo),
                       bisect.bisect_left(self._issued_at, hi)):
            a, b, name = self.device[self._issued[k]]
            if keep(name, self.kinds[self._issued[k]]):
                total += b - a
        return total

    def per_span(self, fn) -> list:
        """``fn(lo, hi)`` for each request span."""
        return [fn(a, b) for a, b, _ in self.spans]

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the card's operations in the window that
        took most time, summed by name."""
        lo, hi = self.window
        sums: dict[str, int] = {}
        for a, b, name in self.device:
            if lo <= a < hi:
                sums[name] = sums.get(name, 0) + b - a
        rows = sorted(sums.items(), key=lambda r: -r[1])[:top]
        return [[name, ns / 1e9] for name, ns in rows]

    def idle_gaps(self, top: int = 10) -> list:
        """[host activity, seconds]: the window's idle time on the card,
        gap by gap named by the innermost host operation running at the
        gap's middle, summed by name, the largest first."""
        lo, hi = self.window
        starts = [h[0] for h in self.host]
        sums: dict[str, int] = {}
        end = lo
        edges = [(a, b) for a, b, _ in self.device if b > lo and a < hi]
        for a, b in edges + [(hi, hi)]:
            if a > end:
                mid = (a + end) // 2
                name = "between requests"
                k = bisect.bisect_right(starts, mid) - 1
                for j in range(k, max(k - 4000, -1), -1):
                    if self.host[j][1] >= mid:
                        name = self.host[j][2]
                        break
                if name == REQUEST_SPAN:
                    name = "in a request, outside any recorded operator"
                sums[name] = sums.get(name, 0) + a - end
            end = max(end, b)
        rows = sorted(sums.items(), key=lambda r: -r[1])[:top]
        return [[name, ns / 1e9] for name, ns in rows]


def timeline(prof) -> Timeline:
    """The timeline of a finished ``torch.profiler.profile``.  A device
    event is tied to the host operator that issued it as ``torch.profiler``
    ties them: its linked correlation id is that operator's id."""
    from torch.autograd import DeviceType
    device, host, spans, issued_at = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        item = (start, start + e.duration_ns(), name)
        if e.device_type() == DeviceType.CUDA:
            if name != REQUEST_SPAN and not _annotation(e):
                device.append((*item, _device_kind(name),
                               e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
            if e.linked_correlation_id() == 0:
                issued_at[e.correlation_id()] = start
            if name == REQUEST_SPAN:
                spans.append(item)
    device.sort()
    host.sort()
    spans.sort()
    return Timeline([d[:3] for d in device], [d[3] for d in device],
                    [issued_at.get(d[4], d[0]) for d in device], host, spans)


def _annotation(e) -> bool:
    """Whether ``e`` is a user annotation (where the event says so)."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


class Tracer:
    """Profiles the requests between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> Timeline:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        return timeline(prof)

    @staticmethod
    def span():
        return torch.profiler.record_function(REQUEST_SPAN)
