"""The port's profiler ranges: ``torch.profiler`` ranges, opened only while
a profiler records.

A range shares the profiler's clock with the device trace, and the kernels
launched inside a synchronous range carry its name on the device's
timeline. With no profiler recording, a call costs one flag check and
opens nothing.

``span`` is a context manager, for a range that opens and closes in one
call. ``open_span`` and ``close_span`` are for a range that opens in one
call and closes in a later one (a request's wait on a queue): such a range
need not nest with the others. One still open when the profiler stops
reads as ending where the range it was opened in ended, or at the stop if
it was opened in none; a handle freed unclosed ends its range then.

``args`` is a mapping, formatted only while a profiler records as
``key=value`` pairs, a list as comma-separated items
(``{"rids": [3, 4]}`` → ``"rids=3,4"``), a None value left out; it reaches
the profiler as the range's string argument.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Mapping, Optional

import torch

_OFF = nullcontext()


def _format(args: Optional[Mapping]) -> Optional[str]:
    pairs = [f"{k}={','.join(map(str, v)) if isinstance(v, list) else v}"
             for k, v in (args or {}).items() if v is not None]
    return " ".join(pairs) or None


def span(name: str, args: Optional[Mapping] = None):
    """A range named ``name`` around a ``with`` block while a profiler
    records; otherwise a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, _format(args))


def open_span(name: str, args: Optional[Mapping] = None):
    """Open a range named ``name`` and return its handle for
    ``close_span``; None when no profiler records."""
    if not torch.autograd._profiler_enabled():
        return None
    return torch.ops.profiler._record_function_enter_new(name, _format(args))


def close_span(handle) -> None:
    """Close a range ``open_span`` opened; ``close_span(None)`` does
    nothing."""
    if handle is not None:
        torch.ops.profiler._record_function_exit._RecordFunction(handle)
