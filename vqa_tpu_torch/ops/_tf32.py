"""The numerics of the float32 kernels' tensor-core products, in plain torch.

The float32 ``relation_attend`` and ``lstm_seq`` kernels run their products
on the tensor cores as 3xTF32: each float32 operand x is split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: 10 mantissa
bits, to nearest, ties away from zero), and ``a @ b`` is taken as
``a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi`` with fp32 sums. The dropped
``a_lo @ b_lo`` and the rounding of the lo halves are ~2^-22 relative, so
the result keeps float32's accuracy where one TF32 pass keeps ~3 decimal
digits.

These functions reproduce that arithmetic on any device for the tests and
for ``chip_smoke.py``; the port's main path does not call them.
"""

from __future__ import annotations

import torch

_DROPPED = 13  # float32's 23 mantissa bits less tf32's 10
_HALF = 1 << (_DROPPED - 1)
_KEEP = ~((1 << _DROPPED) - 1)
_EXPONENT = 0x7F800000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to tf32 (kept as float32): to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does. Adding half a unit of the kept
    last place to the bits rounds the magnitude (the sign bit stands apart),
    a carry into the exponent being the right result; inf and NaN pass."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.view(torch.int32)
    rounded = (bits + _HALF) & _KEEP
    finite = (bits & _EXPONENT) != _EXPONENT
    return torch.where(finite, rounded, bits).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): ``hi = tf32(x)``, ``lo = tf32(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: both operands rounded to tf32, fp32 sums."""
    return tf32_round(a) @ tf32_round(b)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32: ``a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi``,
    each product of tf32 halves exact in fp32, the sums in fp32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
