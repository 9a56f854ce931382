"""Observability: render stats, structured run logs, profiler hooks.

The reference's only instrumentation is a chrono frame timer whose consumer
is commented out, and a debug.log ofstream that is opened and never written
(CSVersion/DxCSApp.cpp:460-471,415,455; SURVEY.md §5).  Here:

- :class:`RenderStats` — wall-time + rays/sec accounting around any render
  call (``block_until_ready`` walls so device async doesn't lie);
- :func:`log_run` — append one JSON line per run to a structured run log;
- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import jax

from raytpu.config import RenderConfig


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render (or train) invocation."""

    wall_s: float
    primary_rays: int
    rays_per_sec: float
    config: str
    label: str = "fwd"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def timed(fn, cfg: RenderConfig, label: str = "fwd",
          iters: int = 1) -> tuple[object, RenderStats]:
    """Run ``fn()`` ``iters`` times (after one warmup) and wall it.

    Returns (last_result, stats).  ``primary_rays`` counts
    width*height*spp per invocation — the BASELINE.json workload unit.
    """
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / iters
    rays = cfg.width * cfg.height * cfg.spp
    return out, RenderStats(
        wall_s=wall, primary_rays=rays, rays_per_sec=rays / wall,
        config=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth}",
        label=label)


def log_run(path: str, stats: RenderStats, **extra) -> None:
    """Append one structured JSON line to the run log."""
    rec = {"ts": time.time(), **stats.as_dict(), **extra}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (view in TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# trace process names whose events ran on the default device's platform:
# on a GPU, one per card (its stream threads hold the kernels); on the
# CPU, XLA's events land on the host process
_DEVICE_PLANES = {"gpu": "/device:GPU:", "cpu": "/host:CPU"}


def device_events(run_once, pid_match: str | None = None) -> list:
    """All device-side complete events of one traced dispatch.

    Runs ``run_once()`` (ONE blocking dispatch) under ``jax.profiler``
    and returns ``[(name, start_ms, dur_ms), ...]`` for every
    ``ph == "X"`` event on trace processes whose name contains
    ``pid_match`` (default: the default device's plane, see
    ``_DEVICE_PLANES``), sorted by duration descending.  On a GPU these
    are the kernels, one event each: a program has no event of its own.
    """
    import glob
    import gzip
    import tempfile

    if pid_match is None:
        pid_match = _DEVICE_PLANES[jax.devices()[0].platform]
    d = tempfile.mkdtemp()
    with trace(d):
        run_once()
    out = []
    for path in glob.glob(d + "/plugins/profile/*/*.trace.json.gz"):
        with gzip.open(path) as fh:
            tr = json.load(fh)
        ev = tr.get("traceEvents", [])
        pids = {e["pid"] for e in ev
                if e.get("ph") == "M"
                and e.get("name") == "process_name"
                and pid_match in str(e.get("args", {}).get("name", ""))}
        for e in ev:
            if e.get("ph") == "X" and e.get("pid") in pids:
                out.append((str(e.get("name", "")), e.get("ts", 0) / 1e3,
                            e.get("dur", 0) / 1e3))
    out.sort(key=lambda t: -t[2])
    return out


def busy_ms(events) -> float:
    """Length of the union of the events' ``[start, start + dur)``
    intervals: the time in which at least one of them ran."""
    total, end = 0.0, float("-inf")
    for _, start, dur in sorted(events, key=lambda t: t[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_ms(run_once, pid_match: str | None = None) -> float:
    """Device busy time of one dispatch, from a ``jax.profiler`` trace:
    the union of its events on the device's trace process (see
    :func:`device_events`).  ``run_once()`` must execute ONE blocking
    dispatch.
    """
    busy = busy_ms(device_events(run_once, pid_match))
    if busy <= 0:
        raise RuntimeError(
            f"no events on a pid matching {pid_match!r} in the trace")
    return busy
