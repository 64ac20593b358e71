"""Numerical-safety tooling; port of meshrecon/utils/debug.py.

The JAX package rests on ``jax_debug_nans`` (raise at the first operation
that makes a NaN) and ``checkify`` (return the error instead of raising).
Here both are a ``TorchDispatchMode`` that looks at every floating output
of every aten operation:

- :func:`enable_nan_checks` ``(True)`` installs it for the process: the
  first operation whose output holds a NaN raises ``FloatingPointError``
  naming the operation (e.g. ``aten.sqrt.default``); ``(False)`` removes it.
- :func:`checked` ``(fn)`` returns a function that runs ``fn`` under the
  mode and returns ``(err, out)`` without raising: ``err`` is None, or a
  message naming the first such operation.

The check reads each output back (a host sync a CUDA operation), so it is
for debugging only. The hand-written kernels launch through the CPython
binding (``meshrecon_torch.kernels``), outside the dispatcher: the mode does
not see their outputs, only what aten operations later make of them.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class NanCheckMode(TorchDispatchMode):
    """Checks every floating output of each aten operation for NaN. With
    ``raise_`` each one raises FloatingPointError; otherwise the first
    message is kept in ``error`` and the run goes on."""

    def __init__(self, raise_: bool = True):
        super().__init__()
        self.raise_ = raise_
        self.error = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.raise_ or self.error is None:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(t.isnan().any())):
                    message = f"NaN in the output of {func}"
                    if self.raise_:
                        raise FloatingPointError(message)
                    self.error = message
                    break
        return out


_ENABLED: list[NanCheckMode] = []


def enable_nan_checks(enable: bool = True) -> None:
    """Raise FloatingPointError at the first aten operation that makes a
    NaN (``True``), or stop checking (``False``)."""
    if enable and not _ENABLED:
        mode = NanCheckMode(raise_=True)
        mode.__enter__()
        _ENABLED.append(mode)
    elif not enable and _ENABLED:
        _ENABLED.pop().__exit__(None, None, None)


def checked(fn, *, errors=None):
    """Wrap ``fn``: the wrapper returns ``(err, out)``, ``err`` None or the
    message naming the first aten operation that made a NaN. ``errors``:
    the checks to make; NaN is the only one (None selects it)."""
    if errors is not None and set(errors) != {"nan"}:
        raise ValueError(f"checked: only the 'nan' check exists, not "
                         f"{set(errors)}")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mode = NanCheckMode(raise_=False)
        with mode:
            out = fn(*args, **kwargs)
        return mode.error, out

    return wrapper
