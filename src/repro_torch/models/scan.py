"""A parallel prefix scan with an associative combine, in the order of
``jax.lax.associative_scan``.

The SSM and RWKV recurrences are affine maps ``h -> a h + b`` composed along
time.  The reference composes them with ``jax.lax.associative_scan``; this
copies that function's recursion (pairs combined at stride 2, the scan of the
reduced half by recursion, then the even elements from the odd ones, the
first element prepended, even and odd interleaved), so the float32 states
come out bit for bit as the reference's.  A sequential loop or a log-space
cumulative product would round differently, and the latter can overflow
for large decays.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["associative_scan"]

Elems = Tuple[torch.Tensor, ...]


def _sl(x: torch.Tensor, axis: int, start, stop=None, step: int = 1
        ) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along ``axis``; ``even`` holds as many
    elements as ``odd`` or one more."""
    n_odd = odd.shape[axis]
    pairs = torch.stack([_sl(even, axis, 0, n_odd), odd], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, _sl(even, axis, n_odd)], dim=axis)
    return out


def associative_scan(fn: Callable[[Elems, Elems], Elems],
                     elems: Sequence[torch.Tensor], axis: int = 0) -> Elems:
    """Inclusive scan of ``elems`` (tensors of one length along ``axis``)
    under the associative ``fn(a, b)``, which combines tuples of tensors
    elementwise: element k of the result is ``fn`` folded over elements
    0..k."""
    elems = tuple(elems)
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn(tuple(_sl(e, axis, 0, -1, 2) for e in elems),
                 tuple(_sl(e, axis, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn(tuple(_sl(e, axis, 0, -1) for e in odd),
                  tuple(_sl(e, axis, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(_sl(e, axis, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_sl(e, axis, 0, 1), r], dim=axis)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))
