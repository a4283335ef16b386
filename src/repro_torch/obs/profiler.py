"""``torch.profiler`` wiring: device traces from the same run as the span
timeline (port of ``repro.obs.profiler``).

The span tracer (:mod:`repro_torch.obs.trace`) explains host-visible
time; ``torch.profiler`` explains what the card did inside a step. The
launch entry point (``repro_torch.launch.serve``) accepts ``--profile
DIR`` and wraps its serving region in :func:`profile_region`, which
writes a Chrome trace of the host's ops and the card's kernels into
``DIR`` (or ``DIR/host<k>``), to be opened in Perfetto beside the span
timeline. One process: the cross-host merge comes with the multi-host
slice (ROADMAP module 8). Profiling is best-effort, as in the reference:
a profiler that fails to start or stop logs a one-line note instead of
failing the run.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from repro_torch.obs import trace as _trace


@contextlib.contextmanager
def profile_region(profile_dir: Optional[str],
                   host: Optional[int] = None) -> Iterator[bool]:
    """Run the enclosed block under ``torch.profiler`` and write its
    Chrome trace (``<pid>.<ms>.pt.trace.json``) into ``profile_dir``, or
    ``profile_dir/host<host>`` (a no-op context when ``profile_dir`` is
    falsy). Yields True when the profiler actually started. Start and stop
    land as instants on the span timeline, so the profiled window shows in
    the Chrome trace of the spans."""
    if not profile_dir:
        yield False
        return
    target = profile_dir if host is None \
        else os.path.join(profile_dir, f"host{host}")
    os.makedirs(target, exist_ok=True)
    prof, started = None, False
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        started = True
    except Exception as e:  # pragma: no cover - build dependent
        print(f"[obs] torch.profiler unavailable ({type(e).__name__}: "
              f"{e}); continuing without a device trace")
    _trace.instant("profiler_start", stage="events", dir=target,
                   active=started)
    try:
        yield started
    finally:
        if started:
            path = os.path.join(
                target, f"{os.getpid()}.{int(time.time() * 1e3)}"
                        f".pt.trace.json")
            try:
                prof.stop()
                prof.export_chrome_trace(path)
            except Exception as e:  # pragma: no cover
                print(f"[obs] torch.profiler stop or export failed "
                      f"({type(e).__name__}: {e})")
        _trace.instant("profiler_stop", stage="events", dir=target)
