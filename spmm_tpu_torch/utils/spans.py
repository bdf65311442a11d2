"""``span``: a named part of the program's work, as a range of the
``torch.profiler`` trace while one collects (re-exported by
``utils.profiling``).

The module imports no torch, so the host tokenizer can name its work
without it: a span looks torch up among the loaded modules, and where it is
not loaded nothing can be profiling.
"""

from __future__ import annotations

import contextlib
import sys

_OFF = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A named range of the program's work, ``spmm.<layer>.<what>``: while
    a ``torch.profiler`` profile collects, a host range of the same trace
    as the device's kernels, on its clock, whose parent is the span
    enclosing it on the thread; otherwise one shared no-op, at the cost of
    a flag read.

    The range is the profiler's fast record function, the one
    ``torch.compile``'s code records: ``record_function`` costs about ten
    times as much a span under the profiler, much of it inside the range.
    No span goes inside a step body captured into a CUDA graph: a replay
    runs none of its Python."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
