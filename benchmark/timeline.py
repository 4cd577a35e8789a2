"""What a traced run reads from torch.profiler: the benchmark's spans,
the device operations and what launched them, and the host's
operations, as arrays on one clock (ns).

A device operation belongs to a `bench.call` span when the CUDA runtime
call that launched it (same correlation id) started inside the span. Busy
time is the union of the device operations' intervals inside the
`bench.window` span. Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

CALL, WINDOW = "bench.call", "bench.window"
# the CUDA runtime and driver calls that launch or copy (cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernel, ...): their correlation ids are the
# device operations'
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# how many earlier host events to search back for the one that covers a
# point (host events nest, so the innermost is the latest that covers it)
_LOOKBACK = 64


@dataclasses.dataclass
class Timeline:
    window: tuple[int, int]          # the window span, ns
    calls: np.ndarray                # (c, 2) the call spans, ns
    dev_name: list                   # device operations: name,
    dev: np.ndarray                  # (d, 2) start, end ns,
    dev_call: np.ndarray             # (d,) bool: launched inside a call
    host_name: list                  # host events (ops, runtime calls,
    host: np.ndarray                 # spans) (h, 2), sorted by start

    @classmethod
    def from_profile(cls, prof) -> "Timeline":
        """From a finished torch.profiler.profile. Spans (user
        annotations) also appear on the device's side; they are no
        device operations and are left out of them."""
        window = None
        calls, spans, devs, hosts, launch = [], set(), [], [], {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            kind = getattr(e, "activity_type", lambda: "")() or ""
            if e.device_type().name != "CPU":
                if not (e.is_user_annotation() or "annotation" in kind):
                    devs.append((name, t0, t1, e.correlation_id()))
                continue
            if e.is_user_annotation() or kind == "user_annotation":
                spans.add(name)
            if name == CALL:
                calls.append((t0, t1))
            elif name == WINDOW:
                window = (t0, t1)
            elif kind in ("cuda_runtime", "cuda_driver") or _RUNTIME.match(
                    name):
                launch[e.correlation_id()] = t0
            hosts.append((t0, t1, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        devs = [d for d in devs if d[0] not in spans]
        hosts.sort(key=lambda h: h[0])
        host = np.array([h[:2] for h in hosts], dtype=np.int64).reshape(-1, 2)
        calls = np.array(sorted(calls), dtype=np.int64).reshape(-1, 2)
        dev = np.array([d[1:3] for d in devs], dtype=np.int64).reshape(-1, 2)
        # the call span, if any, in which each operation was launched
        t = np.array([launch.get(d[3], -1) for d in devs], dtype=np.int64)
        j = np.searchsorted(calls[:, 0], t, side="right") - 1
        inside = (j >= 0) & (t >= 0)
        inside[inside] &= t[inside] <= calls[j[inside], 1]
        return cls(window, calls, [d[0] for d in devs], dev, inside,
                   [h[2] for h in hosts], host)

    def in_window(self) -> np.ndarray:
        """Mask of the device operations that overlap the window."""
        w0, w1 = self.window
        return (self.dev[:, 1] > w0) & (self.dev[:, 0] < w1)

    def busy(self) -> tuple[np.ndarray, float]:
        """(the merged busy intervals clipped to the window (b, 2), their
        total seconds)."""
        w0, w1 = self.window
        iv = np.clip(self.dev[self.in_window()], w0, w1)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        merged = []
        for a, b in iv.tolist():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        merged = np.array(merged, dtype=np.int64).reshape(-1, 2)
        return merged, float((merged[:, 1] - merged[:, 0]).sum()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def call_device_s(self) -> float:
        """Seconds of device operations launched inside the call spans."""
        iv = self.dev[self.dev_call]
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: the device operations in the window
        that took the most time, summed by name."""
        tot: dict = {}
        for i in np.flatnonzero(self.in_window()).tolist():
            a, b = self.dev[i]
            tot[self.dev_name[i]] = tot.get(self.dev_name[i], 0) + int(b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds], ...]: the window's idle device time,
        each gap named by the innermost host event running at its middle
        ("host: between events" where none runs), summed by name, the
        largest first."""
        busy, _ = self.busy()
        w0, w1 = self.window
        edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        starts = self.host[:, 0]
        tot: dict = {}
        for a, b in gaps.tolist():
            mid = (a + b) // 2
            j = int(np.searchsorted(starts, mid, side="right")) - 1
            name = "host: between events"
            for i in range(j, max(j - _LOOKBACK, -1), -1):
                if self.host[i, 1] >= mid:
                    name = self.host_name[i]
                    break
            tot[name] = tot.get(name, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]
