"""SoA and unrolled-iteration utilities (counterpart of
``raycore_tpu/utils/soa.py``).

Tensors are already structs of arrays, so ``soa_get``/``soa_set``/
``similar_soa`` are plain functions over dicts of tensors; Python loops
stand in for the unrolled iterations; ``switch_apply`` is the runtime
index into a heterogeneous tuple, with ``lax.switch``'s semantics (the
index clipped; a batched index selects per lane).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..collections.multitypeset import _switch


def soa_get(soa: dict, idx, *fields):
    """Per-field indexing of a dict of tensors: a tuple, or one value for
    one field."""
    out = tuple(soa[f][idx] for f in fields)
    return out[0] if len(out) == 1 else out


def soa_set(soa: dict, idx, **values):
    """Functional update: a new dict whose named fields are copies with
    ``[idx]`` set; the input is not modified."""
    out = dict(soa)
    for f, v in values.items():
        a = out[f].clone()
        a[idx] = torch.as_tensor(v, dtype=a.dtype, device=a.device)
        out[f] = a
    return out


def similar_soa(template: dict, n: int, dtypes=None) -> dict:
    """A same-field dict of zeros with leading dim n, on each template
    field's device."""
    out = {}
    for f, a in template.items():
        dt = dtypes.get(f) if dtypes else a.dtype
        out[f] = torch.zeros((n,) + tuple(a.shape[1:]), dtype=dt,
                             device=a.device)
    return out


def for_unrolled(fn: Callable, items: Sequence) -> None:
    for i, it in enumerate(items):
        fn(i, it)


def map_unrolled(fn: Callable, items: Sequence) -> tuple:
    return tuple(fn(it) for it in items)


def reduce_unrolled(fn: Callable, items: Sequence, init):
    acc = init
    for it in items:
        acc = fn(acc, it)
    return acc


def sum_unrolled(fn: Callable, items: Sequence):
    return reduce_unrolled(lambda a, it: a + fn(it), items, 0.0)


def switch_apply(idx, fns_or_items: Sequence, *args):
    """Runtime index into a heterogeneous tuple. Items may be callables
    (invoked with *args) or values (returned); the index is clipped into
    range."""
    items = list(fns_or_items)
    if items and callable(items[0]):
        return _switch(idx, len(items), lambda k: items[k](*args))
    return _switch(idx, len(items), lambda k: items[k])
