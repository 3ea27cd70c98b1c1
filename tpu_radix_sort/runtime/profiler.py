"""Tracing / profiling hooks (reference counterpart: timestamp queries).

The reference's only profiling is WebGPU `timestamp-query` wrapped by
`createTimestampQuery` (`example/tests.ts:247-285`). The equivalents here:

- :func:`trace` — context manager around `jax.profiler` emitting an XPlane
  trace viewable in TensorBoard/Perfetto (device + host timeline, per-kernel
  HLO ops — strictly more than begin/end pass timestamps).
- :func:`annotate` — named TraceAnnotation so individual dispatches show up
  as labeled spans inside a trace.
- :func:`time_call` (re-exported in runtime) — host-clock timing around
  `block_until_ready` for headline numbers where a trace is overkill.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import jax


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a jax.profiler trace for the enclosed block.

    Writes to `log_dir` (default $TRS_TRACE_DIR, else `trs_trace` in the
    temp directory). View with TensorBoard's profile plugin or xprof.
    """
    log_dir = log_dir or os.environ.get(
        "TRS_TRACE_DIR", os.path.join(tempfile.gettempdir(), "trs_trace"))
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span annotation: `with annotate('reorder-pass-3'): ...`."""
    return jax.profiler.TraceAnnotation(name)
