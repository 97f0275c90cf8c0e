"""The traced stretch of a run: torch.profiler over a fixed number of the
window's steps, reduced to what the per-layer metrics read.

Device time is grouped by kernel name (the groups of ``chip_smoke.py``'s
``PROFILE_GROUPS``, plus copies). The device is busy where any operation
ran, the union of the device intervals; the idle share is 1 - busy /
the stretch's wall time. A second stretch, with host activity, names
each idle gap after the harness range (``record_function``) the host was
in when it began.
"""

from __future__ import annotations

import math
import time

import torch

GROUPS = (('K2 conv_int8', ('conv_int8',)),
          ('K1 nms_suppress', ('nms_suppress',)),
          ('copy', ('memcpy', 'memset')),
          ('cuDNN/cuBLAS conv, gemm', ('conv', 'cudnn', 'xmma', 'gemm',
                                       'sm90')),
          ('sort', ('sort', 'radix')),
          ('elementwise', ('elementwise', 'vectorized', 'unrolled',
                           'launch_clamp', 'where')),
          ('cat, gather, index', ('cat', 'gather', 'index', 'copy')),
          ('reduce', ('reduce',)))
STRETCH = 'stretch'


def group_of(name):
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)),
                'other')


class Stretch:
    """Profiles the steps between ``start`` and ``stop``. Device activity
    alone (``host=False``) for the metrics, so that the profiler adds no
    host work to the stretch; host activity too (``host=True``) for the
    harness's ranges that name the idle gaps."""

    def __init__(self, ranges, host):
        self.ranges = set(ranges) | {STRETCH}
        self.host = host
        self.cuda = torch.cuda.is_available()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] * self.cuda
        if self.host or not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def _events(self):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == cuda and e.name not in self.ranges:
                dev.append((tr.start, tr.end, e.name))
            elif e.device_type == cpu and e.name in self.ranges:
                host.append((tr.start, tr.end, e.name))
        return sorted(dev), host

    def device(self, top=10):
        """Device time by group, kernel launches, and the busy seconds (the
        union of the device intervals) over the stretch's wall time."""
        dev, _ = self._events()
        groups, kernels, busy, cur = {}, 0, 0.0, -math.inf
        for s, t, name in dev:
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + (t - s) / 1e6
            kernels += g != 'copy'
            if t > cur:
                busy += t - max(s, cur)
                cur = t
        return {'window_s': self.wall_s, 'busy_s': busy / 1e6,
                'groups_s': groups, 'kernels': kernels,
                'device_ops': sorted(([g, v] for g, v in groups.items()),
                                     key=lambda g: -g[1])[:top]}

    def idle_gaps(self, top=10):
        """The longest device idle gaps of the stretch, each named after
        the innermost harness range the host was in when it began."""
        dev, host = self._events()
        span = next(h for h in host if h[2] == STRETCH)
        inner = sorted((h for h in host if h[2] != STRETCH),
                       key=lambda h: h[1] - h[0])
        gaps, cur = [], span[0]
        for s, t, _ in dev:
            if s > cur:
                gaps.append((cur, min(s, span[1])))
            cur = max(cur, t)
        if span[1] > cur:
            gaps.append((cur, span[1]))

        def doing(at):
            return next((h[2] for h in inner if h[0] <= at < h[1]),
                        'between calls')
        return sorted(([doing(s), (t - s) / 1e6] for s, t in gaps if t > s),
                      key=lambda g: -g[1])[:top]
