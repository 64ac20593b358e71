"""The reference's arithmetic: float32 with TF32 off, or TF32 (the control).

TF32 keeps float32's exponent and 10 of its 23 mantissa bits. A GPU in
TF32 mode rounds the operands of a matrix product to it and accumulates in
float32; :func:`matmul` does the same explicitly, so the control does not
depend on whether a library picks tensor cores for a small product.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Arith:
    """The precision of one reference run."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}: "
                             f"{precision!r}")
        self.precision = precision

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = round_tf32(a.to(torch.float32)), round_tf32(
                b.to(torch.float32))
        return a @ b

    @contextlib.contextmanager
    def backend(self):
        """The backends' TF32 switches for the run, restored after it."""
        on = self.precision == "tf32"
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
