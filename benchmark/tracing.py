"""Spans, the profiled sub-window, and what is read from its trace.

Spans are recorded from the benchmark's own files, around its calls into
the program's layers: `Spans.timed` takes host-clock time between
synchronizes; `label` names a host span in the profiler's trace (the
traced run only). `Profile` holds the raw kineto events of one bounded
sub-window and reduces them without building a Python event per launch:
the device's busy time (the union of its operations' intervals), the
operations per name, and the idle gaps named by the benchmark's host span
that was open when each began.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"


def sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


class Spans:
  """Host-clock seconds of each named span, the device synchronized at its
  start and end."""

  def __init__(self, device: torch.device):
    self.device = device
    self.seconds: Dict[str, List[float]] = {}

  @contextlib.contextmanager
  def timed(self, name: str):
    sync(self.device)
    t0 = time.perf_counter()
    with label(name):
      yield
    sync(self.device)
    self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def label(name: str):
  """A host span in the profiler's trace."""
  return torch.profiler.record_function(PREFIX + name)


def wrap_span(owner, attr: str, name: str) -> Callable[[], None]:
  """Put a labelled span around every call of `owner.attr`; returns the
  function that takes it off again."""
  own = attr in vars(owner)
  fn = getattr(owner, attr)

  def spanned(*a, **kw):
    with label(name):
      return fn(*a, **kw)

  setattr(owner, attr, spanned)
  return (lambda: setattr(owner, attr, fn)) if own else \
      (lambda: delattr(owner, attr))


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
  out: List[List[int]] = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return [(s, e) for s, e in out]


class Profile:
  """The device operations and the benchmark's host spans of one profiled
  sub-window, and its wall time on the host clock."""

  def __init__(self, device: torch.device):
    self.device = device
    self.ops: List[Tuple[int, int, str]] = []      # (start ns, end ns, name)
    self.spans: List[Tuple[int, int, str]] = []
    self.wall_s = 0.0

  def run(self, fn: Callable[[], None]) -> None:
    """Run `fn` under the profiler and keep its events."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if self.device.type == "cuda":
      acts.append(ProfilerActivity.CUDA)
    sync(self.device)
    with profile(activities=acts) as prof:
      t0 = time.perf_counter()
      fn()
      sync(self.device)
      self.wall_s = time.perf_counter() - t0
    for e in prof.profiler.kineto_results.events():
      start, dur = e.start_ns(), e.duration_ns()
      if e.name().startswith(PREFIX):
        # a host span; the trace also shows it on the device's timeline,
        # where it is no operation
        if e.device_type() != torch.autograd.DeviceType.CUDA:
          self.spans.append((start, start + dur, e.name()[len(PREFIX):]))
      elif e.device_type() == torch.autograd.DeviceType.CUDA:
        self.ops.append((start, start + dur, e.name()))

  @property
  def n_ops(self) -> int:
    return len(self.ops)

  def busy_s(self) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in _merge([(s, e) for s, e, _ in self.ops])
               ) / 1e9

  def device_ops(self, n: int = 10) -> List[List]:
    """The `n` operation names that took most device time, with seconds."""
    by: Dict[str, int] = {}
    for s, e, name in self.ops:
      by[name] = by.get(name, 0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]

  def idle_gaps(self, n: int = 10) -> List[List]:
    """Idle seconds of the device between its operations, summed by the
    innermost benchmark span open on the host where each gap began ("none"
    outside every span); the `n` largest."""
    busy = _merge([(s, e) for s, e, _ in self.ops])
    # the host spans nest (one thread), so a stack swept along the gaps
    # holds the open ones, the innermost on top
    spans = sorted(self.spans, key=lambda x: (x[0], -x[1]))
    stack: List[Tuple[int, int, str]] = []
    j = 0
    by: Dict[str, int] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
      while j < len(spans) and spans[j][0] <= e0:
        while stack and stack[-1][1] < spans[j][0]:
          stack.pop()
        stack.append(spans[j])
        j += 1
      while stack and stack[-1][1] < e0:
        stack.pop()
      name = stack[-1][2] if stack else "none"
      by[name] = by.get(name, 0) + (s1 - e0)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def cuda_ms(fn: Callable[[], object], n: int, device: torch.device
            ) -> Optional[float]:
  """Mean milliseconds per call of `fn` over `n` calls by CUDA events,
  after one call to warm up; None off the card."""
  if device.type != "cuda":
    return None
  fn()
  torch.cuda.synchronize(device)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize(device)
  return start.elapsed_time(end) / n
