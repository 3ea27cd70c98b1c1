"""Runtime layer: host-clock timing, device facts, profiling, native CPU
baseline."""
from .profiler import annotate, trace
from .timing import Timing, time_call

__all__ = ["Timing", "time_call", "trace", "annotate"]
