"""Phase timing and profiler traces: the port's copy of
``mfar_tpu/utils/timing.py``, with ``torch.profiler`` in place of the JAX
profiler.

:class:`Timer` sums host-clock seconds per named phase.  Device work is
asynchronous, so a phase that only launches kernels measures the launches;
the phase that waits for the device (a ``.item()``, a synchronize) carries
the rest.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class Timer:
    """Accumulates named phase durations; one Timer per pipeline run."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, with_counts: bool = False) -> str:
        """Total seconds per phase; ``with_counts`` appends 'name_n' call
        counts (so per-call averages are derivable from one report)."""
        out = {name: round(self.phases[name], 4) for name in sorted(self.phases)}
        if with_counts:
            out.update({f"{name}_n": self.counts[name] for name in sorted(self.counts)})
        return json.dumps(out)


@contextlib.contextmanager
def torch_profile(out_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host and, with a card, its
    kernels) into ``out_dir/trace.json`` (Chrome trace format) when
    ``out_dir`` is set."""
    if out_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
