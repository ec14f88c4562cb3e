"""Heterogeneous collections: the MultiTypeSet (counterpart of
``raycore_tpu/collections/multitypeset.py``).

- a ``SetKey`` is an int32 (type_idx, row_idx) pair; ``(-1, -1)`` is the
  invalid sentinel;
- the static form is a tuple of per-type tables, each a dict of tensors
  with a power-of-two padded leading dimension;
- ``with_index`` dispatches on the key's type slot, as ``lax.switch``
  does: a scalar key runs its one branch, a batched key runs every slot's
  branch on every lane and selects per lane (``lax.switch`` under
  ``vmap``), so a branch function takes and returns batched tensors;
- textures live in one flat float32 pool plus (offset, h, w, c) int32
  records; a texture handle is an int32 index into the records, and
  ``deref`` and the samplers are clipped gathers computed from uv.

The mutable ``MultiTypeSet`` keeps the items on the host and rebuilds
the static form on ``get_static()`` after a mutation, on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import default_device

INVALID_KEY = (-1, -1)


def SetKey(type_idx: int, row_idx: int, device=None) -> torch.Tensor:
    """Key into a (Static)MultiTypeSet: an int32 (type, row) pair on
    ``device``, the CUDA card by default."""
    return torch.tensor([type_idx, row_idx], dtype=torch.int32,
                        device=default_device(device))


def is_invalid(key) -> torch.Tensor:
    key = torch.as_tensor(key)
    return (key[..., 0] < 0) | (key[..., 1] < 0)


def is_valid_key(key) -> torch.Tensor:
    return ~is_invalid(key)


@dataclasses.dataclass
class TexturePool:
    """Flat texture storage: all texel data in one float32 buffer plus
    (offset, h, w, c) int32 records."""
    data: torch.Tensor      # (total_texels,) float32
    records: torch.Tensor   # (n_textures, 4) int32: offset, h, w, c

    @classmethod
    def empty(cls, device=None):
        device = default_device(device)
        return cls(data=torch.zeros((1,), device=device),
                   records=torch.zeros((1, 4), dtype=torch.int32,
                                       device=device))

    def shape_of(self, ref):
        r = self.records[torch.as_tensor(ref, device=self.records.device)
                         .long()]
        return r[..., 1], r[..., 2], r[..., 3]


def _ref_record(pool: TexturePool, ref):
    ref = torch.as_tensor(ref, dtype=torch.int32, device=pool.records.device)
    rec = pool.records[ref.clamp(0, pool.records.shape[0] - 1).long()]
    return rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3]


def _texel(pool: TexturePool, off, w, c, x, y):
    """4 channels of texel (x, y) (already clipped), zero past c."""
    base = off + (y * w + x) * c
    ch = torch.arange(4, dtype=torch.int32, device=base.device)
    idx = base[..., None] + torch.minimum(
        ch, torch.clamp(c[..., None] - 1, min=0))
    texel = pool.data[idx.clamp(0, pool.data.shape[0] - 1).long()]
    return torch.where(ch < c[..., None], texel, 0.0)


def sample_nearest(pool: TexturePool, ref, uv):
    """Point-sample texture ``ref`` at uv in [0,1]^2 -> (..., 4): the
    texture's channels, zero-padded to 4."""
    off, h, w, c = _ref_record(pool, ref)
    uv = torch.as_tensor(uv, dtype=torch.float32, device=pool.data.device)
    x = torch.minimum(torch.clamp((uv[..., 0] * w.float()).to(torch.int32),
                                  min=0), w - 1)
    y = torch.minimum(torch.clamp((uv[..., 1] * h.float()).to(torch.int32),
                                  min=0), h - 1)
    return _texel(pool, off, w, c, x, y)


def sample_bilinear(pool: TexturePool, ref, uv):
    off, h, w, c = _ref_record(pool, ref)
    uv = torch.as_tensor(uv, dtype=torch.float32, device=pool.data.device)
    fx = uv[..., 0] * w.float() - 0.5
    fy = uv[..., 1] * h.float() - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = fx - x0.float()
    ty = fy - y0.float()

    def tap(xi, yi):
        xc = torch.minimum(torch.clamp(xi, min=0), w - 1)
        yc = torch.minimum(torch.clamp(yi, min=0), h - 1)
        return _texel(pool, off, w, c, xc, yc)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    tx = tx[..., None]
    ty = ty[..., None]
    return (t00 * (1 - tx) + t10 * tx) * (1 - ty) \
        + (t01 * (1 - tx) + t11 * tx) * ty


@dataclasses.dataclass
class StaticMultiTypeSet:
    """Frozen form: per-type tables + texture pool + live counts."""
    tables: Tuple[Dict[str, torch.Tensor], ...]  # leading dim per type
    counts: torch.Tensor                          # (n_types,) int32
    textures: TexturePool

    @property
    def n_slots(self) -> int:
        return len(self.tables)


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_select(sel, outs):
    """Per-lane choice among the slots' outputs: lane i takes
    ``outs[sel[i]]``, leaf by leaf (``sel`` is (...,), a leaf (..., ...)
    or a scalar)."""
    def pick(leaves):
        acc = torch.as_tensor(leaves[0], device=sel.device)
        for k in range(1, len(leaves)):
            leaf = torch.as_tensor(leaves[k], device=sel.device)
            extra = max(max(acc.dim(), leaf.dim()) - sel.dim(), 0)
            cond = (sel == k).reshape(tuple(sel.shape) + (1,) * extra)
            acc = torch.where(cond, leaf, acc)
        return acc

    first = outs[0]
    if isinstance(first, dict):
        return {k: _tree_select(sel, [o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_select(sel, [o[i] for o in outs])
                           for i in range(len(first)))
    return pick(outs)


def gather_row(table, row_idx):
    """Row(s) of a per-type table, the index clipped into the table."""
    def take(a):
        r = torch.as_tensor(row_idx, device=a.device).to(torch.int64)
        return a[r.clamp(0, a.shape[0] - 1)]
    return _tree_map(take, table)


def _switch(idx, n: int, branch: Callable[[int], Any]):
    """``lax.switch`` over ``n`` slots: ``branch(k)`` for the clipped
    scalar index, or every branch selected per lane for a batched one."""
    idx = torch.as_tensor(idx).to(torch.int32).clamp(0, n - 1)
    if idx.dim() == 0:
        return branch(int(idx))
    return _tree_select(idx, [branch(k) for k in range(n)])


def with_index(fns: Sequence[Callable], sset: StaticMultiTypeSet, key,
               *args):
    """Dispatch on the key's type slot: ``fns[type](row_data, *args)``.
    ``fns`` may be one callable (applied to every type) or one per type.
    A key (2,) runs its slot's function on its row; a batched key
    (..., 2) runs every slot's function on the rows ``key[..., 1]`` and
    takes each lane's own slot, so the functions must take and return
    batched tensors. Invalid keys dispatch to slot 0's function on row
    0 (indices are clipped) — guard with ``is_invalid(key)`` at the call
    site for the reference's no-op contract."""
    key = torch.as_tensor(key).to(torch.int32)
    if callable(fns):
        fns = [fns] * len(sset.tables)
    if len(fns) != len(sset.tables):
        raise ValueError(f"{len(fns)} functions for {len(sset.tables)} "
                         f"type slots")
    return _switch(key[..., 0], len(fns), lambda k: fns[k](
        gather_row(sset.tables[k], key[..., 1]), *args))


def deref(pool: TexturePool, ref):
    """Texture record for a handle: (offset, h, w, c) int32."""
    return pool.records[torch.as_tensor(ref, device=pool.records.device)
                        .long()]


def texture_to_numpy(pool: TexturePool, ref):
    """Host-side full texture fetch as an (h, w, c) NumPy array."""
    rec = pool.records.cpu().numpy()[int(ref)]
    off, h, w, c = (int(x) for x in rec)
    return pool.data.cpu().numpy()[off:off + h * w * c].reshape(h, w, c)


def to_tuple(sset: StaticMultiTypeSet):
    """The per-type table tuple."""
    return sset.tables


def maybe_convert_field(mts: "MultiTypeSet", value):
    """Array-valued fields (ndim >= 2) become texture handles; anything
    else passes through."""
    if isinstance(value, np.ndarray) and value.ndim >= 2:
        return mts.store_texture(value)
    return value


def n_slots(sset) -> int:
    return sset.n_slots


def foreach_type(fn: Callable, sset: StaticMultiTypeSet):
    """``fn(type_idx, table, count)`` per type slot."""
    return [fn(i, t, sset.counts[i]) for i, t in enumerate(sset.tables)]


def mapreduce_set(map_fns, reduce_fn, init, sset: StaticMultiTypeSet):
    """Map over every row of every type, reduced with
    ``reduce_fn(acc, values, live)``. A map function takes the whole
    table (rows batched along the leading dimension), as the JAX
    package's ``vmap`` of it sees them; ``live`` marks the rows below the
    type's count."""
    if callable(map_fns):
        map_fns = [map_fns] * len(sset.tables)
    acc = init
    for i, (tbl, fn) in enumerate(zip(sset.tables, map_fns)):
        n = next(iter(tbl.values())).shape[0]
        vals = fn(tbl)
        live = torch.arange(n, device=sset.counts.device) < sset.counts[i]
        acc = reduce_fn(acc, vals, live)
    return acc


class MultiTypeSet:
    """Mutable host-side registry of heterogeneous items.

    Items are dicts of: python scalars (packed inline as f32/i32
    columns), short vectors (inline (cap, K) float32 columns) or NumPy
    arrays of ndim >= 2 (stored in the texture pool; the column holds the
    int32 handle). Type slots are keyed by an explicit type name, in
    first-seen order. ``get_static()`` puts the static form on
    ``device``, the CUDA card by default; keys live there too.
    """

    def __init__(self, device=None):
        self.device = default_device(device)
        self._type_names: List[str] = []
        self._items: Dict[str, List[Optional[dict]]] = {}
        self._schemas: Dict[str, Dict[str, str]] = {}   # field -> kind
        self._textures: List[np.ndarray] = [np.zeros((1, 1, 1), np.float32)]
        self._static: Optional[StaticMultiTypeSet] = None
        self._dirty = True

    # -- mutation ---------------------------------------------------------
    def _schema_of(self, item: dict) -> Dict[str, str]:
        sch = {}
        for k, v in item.items():
            if isinstance(v, np.ndarray) and v.ndim >= 2:
                sch[k] = "texture"
            elif isinstance(v, (bool, np.bool_, int, np.integer)):
                sch[k] = "int"
            elif isinstance(v, (np.ndarray, list, tuple)):
                n = int(np.asarray(v).size)
                if n == 0:
                    raise ValueError(f"empty vector field '{k}'")
                sch[k] = f"vec{n}"
            else:
                sch[k] = "float"
        return sch

    @staticmethod
    def _as_texture(arr) -> np.ndarray:
        arr = np.asarray(arr, np.float32)
        return arr[..., None] if arr.ndim == 2 else arr

    def store_texture(self, arr: np.ndarray) -> int:
        """Add a texture to the pool; returns its int handle."""
        self._textures.append(self._as_texture(arr))
        self._dirty = True
        return len(self._textures) - 1

    def update_texture(self, handle: int, arr: np.ndarray) -> None:
        """Overwrite a pool slot (the pool is rebuilt on get_static)."""
        self._textures[handle] = self._as_texture(arr)
        self._dirty = True

    def _key(self, type_name: str, row: int) -> torch.Tensor:
        return SetKey(self._type_names.index(type_name), row,
                      device=self.device)

    def push(self, item: dict, type_name: str):
        """Insert an item; returns its SetKey. Array-valued fields are
        converted to texture handles; a freed row is reused."""
        if type_name not in self._items:
            self._type_names.append(type_name)
            self._items[type_name] = []
            self._schemas[type_name] = self._schema_of(item)
        sch = self._schemas[type_name]
        if set(item) != set(sch):
            raise ValueError(f"fields {set(item)} != schema {set(sch)} "
                             f"for '{type_name}'")
        conv = {k: self.store_texture(v) if sch[k] == "texture" else v
                for k, v in item.items()}
        rows = self._items[type_name]
        self._dirty = True
        for ri, r in enumerate(rows):
            if r is None:
                rows[ri] = conv
                return self._key(type_name, ri)
        rows.append(conv)
        return self._key(type_name, len(rows) - 1)

    def update(self, key, item: dict) -> None:
        """Overwrite the item at key, reusing texture slots when shapes
        match. An invalid key is a silent no-op."""
        ti, ri = int(key[0]), int(key[1])
        if ti < 0 or ri < 0:
            return
        tname = self._type_names[ti]
        sch = self._schemas[tname]
        old = self._items[tname][ri]
        conv = {}
        for k, v in item.items():
            if sch[k] == "texture":
                h = old[k]
                v3 = self._as_texture(v)
                if v3.shape == self._textures[h].shape:
                    self.update_texture(h, v3)
                    conv[k] = h
                else:
                    conv[k] = self.store_texture(v3)
            else:
                conv[k] = v
        self._items[tname][ri] = conv
        self._dirty = True

    def delete(self, key) -> None:
        ti, ri = int(key[0]), int(key[1])
        if ti < 0 or ri < 0:
            return
        self._items[self._type_names[ti]][ri] = None
        self._dirty = True

    def free(self) -> None:
        """Drop everything."""
        self.__init__(self.device)

    # -- static form --------------------------------------------------------
    def get_static(self) -> StaticMultiTypeSet:
        if self._static is not None and not self._dirty:
            return self._static
        dev = self.device
        offsets = np.cumsum([0] + [t.size for t in self._textures[:-1]])
        data = np.concatenate([t.ravel() for t in self._textures])
        recs = np.array([[o, t.shape[0], t.shape[1], t.shape[2]]
                         for o, t in zip(offsets, self._textures)], np.int32)
        pool = TexturePool(data=torch.tensor(data, device=dev),
                           records=torch.tensor(recs, device=dev))

        tables, counts = [], []
        for tname in self._type_names:
            rows = self._items[tname]
            n = len(rows)
            cap = max(1, 1 << (max(n, 1) - 1).bit_length())
            cols = {}
            for f, kind in self._schemas[tname].items():
                if kind == "float":
                    col = np.zeros((cap,), np.float32)
                elif kind.startswith("vec"):
                    col = np.zeros((cap, int(kind[3:])), np.float32)
                else:
                    col = np.zeros((cap,), np.int32)
                for ri, r in enumerate(rows):
                    if r is not None:
                        col[ri] = np.asarray(r[f], col.dtype).reshape(
                            col.shape[1:])
                cols[f] = torch.tensor(col, device=dev)
            tables.append(cols)
            counts.append(n)

        self._static = StaticMultiTypeSet(
            tables=tuple(tables),
            counts=torch.tensor(counts, dtype=torch.int32, device=dev),
            textures=pool)
        self._dirty = False
        return self._static

    @property
    def n_slots(self) -> int:
        return len(self._type_names)

    def __len__(self):
        return sum(sum(1 for r in rows if r is not None)
                   for rows in self._items.values())

    def __repr__(self):
        parts = [f"{t}: {sum(1 for r in self._items[t] if r is not None)}"
                 for t in self._type_names]
        return f"MultiTypeSet({', '.join(parts)})"
