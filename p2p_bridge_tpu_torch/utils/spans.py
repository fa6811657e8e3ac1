"""Named ranges of the port's work in a ``torch.profiler`` trace.

``span(name)`` is a context manager. While a profiler records this thread
it is ``torch.profiler.record_function("p2pb." + name)``: the range lands
in the profiler's trace on the profiler's clock, beside the kernels and
copies launched inside it (linked to them by correlation ids). With no
profiler it is one shared no-op context, so a span on the hot path costs
one check. The profiler is the only switch: ``train.py --profile_dir``,
``denoise_room --profile_dir`` and any ``torch.profiler`` window see the
ranges; nothing is recorded otherwise.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

PREFIX = "p2pb."
_OFF = nullcontext()


def span(name: str):
    """The range ``p2pb.<name>`` while a profiler records this thread
    (``prof.start()`` or ``with profile(...)``), else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
