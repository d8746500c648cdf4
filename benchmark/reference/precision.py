"""The control: the reference computed one precision below the cell's.

The cells state float32. ``lower_precision()`` rounds the result of every
floating-point torch operation to bfloat16 (kept in float32 storage), so
the reference's arithmetic runs at bfloat16's 8-bit mantissa. A comparison
that cannot tell this control from the reference cannot tell a program that
computes in bfloat16 either.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class _Bf16Results(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return tree_map(_round, func(*args, **(kwargs or {})))


@contextlib.contextmanager
def lower_precision(enabled: bool = True):
    """Inside: every float32 result rounded to bfloat16."""
    if not enabled:
        yield
        return
    with _Bf16Results():
        yield
