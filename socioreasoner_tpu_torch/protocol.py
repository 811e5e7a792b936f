"""BatchProto — the universal batch container of the framework.

The port's own copy of socioreasoner_tpu/protocol.py, kept as it is there
(host-only code: the port imports nothing of the JAX package).

Plays the role of the reference's ``DataProto``
(``roll/distributed/scheduler/protocol.py:146``): a batch of N samples made of

* ``batch``       — dict of numeric ``np.ndarray`` (or tensors), leading dim N
* ``non_tensor``  — dict of ``np.ndarray(dtype=object)`` columns, leading dim N
                    (PIL images, strings, parsed prompts, ragged data)
* ``meta``        — free-form metadata dict (not per-sample)

Unlike the reference there is no TensorDict / torch dependency: numeric columns are
numpy on the host and are moved to device (with shardings) only at the jit boundary.
All ops are pure (return new BatchProto; underlying arrays may be shared).

Reference ops mirrored: from_dict (:244), select (:312), select_idxs (:346),
slice (:384), pop (:430), rename (:476), union (:493), make_iterator (:511),
chunk (:550), concat (:594), reorder (:619), group_by (:627), repeat (:673),
pad_to_divisor/unpad (:28,54).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Array = np.ndarray


def _as_object_array(values: Sequence[Any]) -> np.ndarray:
    """Build a 1-D object array without numpy trying to broadcast nested lists."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def _is_numeric(value: Any) -> bool:
    return isinstance(value, np.ndarray) and value.dtype != object or hasattr(value, "dtype") and not isinstance(value, np.ndarray)


@dataclass
class BatchProto:
    batch: Dict[str, Array] = field(default_factory=dict)
    non_tensor: Dict[str, np.ndarray] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------ basics
    def __post_init__(self):
        self.check_consistency()

    def check_consistency(self):
        """Shape sanity (ref protocol.py:223): all columns share the leading dim."""
        n = None
        for key, val in list(self.batch.items()):
            if not hasattr(val, "shape"):
                val = np.asarray(val)
                self.batch[key] = val
            if n is None:
                n = val.shape[0]
            elif val.shape[0] != n:
                raise ValueError(f"batch[{key!r}] leading dim {val.shape[0]} != {n}")
        for key, val in list(self.non_tensor.items()):
            if not isinstance(val, np.ndarray) or val.dtype != object:
                val = _as_object_array(list(val))
                self.non_tensor[key] = val
            if n is None:
                n = val.shape[0]
            elif val.shape[0] != n:
                raise ValueError(f"non_tensor[{key!r}] leading dim {val.shape[0]} != {n}")

    def __len__(self) -> int:
        for v in self.batch.values():
            return int(v.shape[0])
        for v in self.non_tensor.values():
            return int(v.shape[0])
        return 0

    @property
    def keys(self) -> List[str]:
        return list(self.batch.keys()) + list(self.non_tensor.keys())

    def __contains__(self, key: str) -> bool:
        return key in self.batch or key in self.non_tensor

    def __getitem__(self, key: str):
        if key in self.batch:
            return self.batch[key]
        return self.non_tensor[key]

    # ------------------------------------------------------------- constructors
    @classmethod
    def from_dict(
        cls,
        tensors: Optional[Dict[str, Any]] = None,
        non_tensors: Optional[Dict[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> "BatchProto":
        tensors = {k: np.asarray(v) if not hasattr(v, "shape") else v for k, v in (tensors or {}).items()}
        nt = {}
        for k, v in (non_tensors or {}).items():
            if isinstance(v, np.ndarray) and v.dtype == object:
                nt[k] = v
            else:
                nt[k] = _as_object_array(list(v))
        return cls(batch=tensors, non_tensor=nt, meta=dict(meta or {}))

    @classmethod
    def from_single_dict(cls, data: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> "BatchProto":
        """Split a flat dict into numeric/object columns by dtype (ref :244)."""
        tensors, non_tensors = {}, {}
        for k, v in data.items():
            arr = v if hasattr(v, "dtype") else np.asarray(v)
            if getattr(arr, "dtype", None) == object:
                non_tensors[k] = arr
            else:
                tensors[k] = arr
        return cls.from_dict(tensors=tensors, non_tensors=non_tensors, meta=meta)

    # ------------------------------------------------------------------- select
    def select(self, batch_keys: Optional[Sequence[str]] = None,
               non_tensor_keys: Optional[Sequence[str]] = None,
               meta_keys: Optional[Sequence[str]] = None,
               deepcopy_meta: bool = False) -> "BatchProto":
        batch = {k: self.batch[k] for k in (batch_keys if batch_keys is not None else self.batch)}
        nt = {k: self.non_tensor[k] for k in (non_tensor_keys if non_tensor_keys is not None else self.non_tensor)}
        meta = {k: self.meta[k] for k in (meta_keys if meta_keys is not None else self.meta)}
        if deepcopy_meta:
            meta = copy.deepcopy(meta)
        return BatchProto(batch=batch, non_tensor=nt, meta=meta)

    def pop(self, batch_keys: Optional[Sequence[str]] = None,
            non_tensor_keys: Optional[Sequence[str]] = None,
            meta_keys: Optional[Sequence[str]] = None) -> "BatchProto":
        """Remove the given keys from self and return them as a new BatchProto."""
        batch = {k: self.batch.pop(k) for k in list(batch_keys or []) if k in self.batch}
        nt = {k: self.non_tensor.pop(k) for k in list(non_tensor_keys or []) if k in self.non_tensor}
        meta = {k: self.meta.pop(k) for k in list(meta_keys or []) if k in self.meta}
        return BatchProto(batch=batch, non_tensor=nt, meta=meta)

    def rename(self, old_keys: Union[str, Sequence[str]], new_keys: Union[str, Sequence[str]]) -> "BatchProto":
        if isinstance(old_keys, str):
            old_keys, new_keys = [old_keys], [new_keys]
        for old, new in zip(old_keys, new_keys):
            if old in self.batch:
                self.batch[new] = self.batch.pop(old)
            elif old in self.non_tensor:
                self.non_tensor[new] = self.non_tensor.pop(old)
            else:
                raise KeyError(old)
        return self

    def union(self, other: "BatchProto") -> "BatchProto":
        """Merge columns of ``other`` into self (ref :493). Conflicting keys must match len."""
        if len(other) and len(self) and len(other) != len(self):
            raise ValueError(f"union size mismatch {len(self)} vs {len(other)}")
        self.batch.update(other.batch)
        self.non_tensor.update(other.non_tensor)
        self.meta.update(other.meta)
        return self

    # ----------------------------------------------------------------- indexing
    def select_idxs(self, idxs) -> "BatchProto":
        idxs = np.asarray(idxs)
        if idxs.dtype == bool:
            idxs = np.nonzero(idxs)[0]
        batch = {k: np.asarray(v)[idxs] for k, v in self.batch.items()}
        nt = {k: v[idxs] for k, v in self.non_tensor.items()}
        return BatchProto(batch=batch, non_tensor=nt, meta=self.meta)

    def slice(self, start: int, end: Optional[int] = None, step: int = 1) -> "BatchProto":
        sl = slice(start, end, step)
        batch = {k: v[sl] for k, v in self.batch.items()}
        nt = {k: v[sl] for k, v in self.non_tensor.items()}
        return BatchProto(batch=batch, non_tensor=nt, meta=self.meta)

    def reorder(self, indices) -> "BatchProto":
        """In-place reorder by indices (ref :619)."""
        indices = np.asarray(indices)
        for k in self.batch:
            self.batch[k] = np.asarray(self.batch[k])[indices]
        for k in self.non_tensor:
            self.non_tensor[k] = self.non_tensor[k][indices]
        return self

    # ---------------------------------------------------------------- structure
    def chunk(self, chunks: int) -> List["BatchProto"]:
        """Split into `chunks` nearly-equal parts along the batch dim (ref :550)."""
        n = len(self)
        sizes = [n // chunks + (1 if i < n % chunks else 0) for i in range(chunks)]
        out, start = [], 0
        for s in sizes:
            out.append(self.slice(start, start + s))
            start += s
        return out

    @staticmethod
    def concat(protos: Sequence["BatchProto"]) -> "BatchProto":
        protos = [p for p in protos if p is not None]
        if not protos:
            return BatchProto()
        non_empty = [p for p in protos if len(p) > 0]
        if not non_empty:
            return protos[0]
        batch_keys = non_empty[0].batch.keys()
        nt_keys = non_empty[0].non_tensor.keys()
        batch = {k: np.concatenate([np.asarray(p.batch[k]) for p in non_empty], axis=0) for k in batch_keys}
        nt = {k: np.concatenate([p.non_tensor[k] for p in non_empty], axis=0) for k in nt_keys}
        meta = {}
        for p in protos:
            meta.update(p.meta)
        return BatchProto(batch=batch, non_tensor=nt, meta=meta)

    def repeat(self, repeat_times: int, interleave: bool = True) -> "BatchProto":
        """Repeat each sample (ref :673). interleave=True → aabb, else abab."""
        if interleave:
            idx = np.repeat(np.arange(len(self)), repeat_times)
        else:
            idx = np.tile(np.arange(len(self)), repeat_times)
        return self.select_idxs(idx)

    def group_by(self, key: str) -> Dict[Any, "BatchProto"]:
        col = self[key]
        col = np.asarray(col)
        out = {}
        for val in dict.fromkeys(col.tolist()):  # preserve first-seen order
            out[val] = self.select_idxs(col == val)
        return out

    def make_iterator(self, mini_batch_size: int, epochs: int = 1, *,
                      shuffle: bool = False, seed: int = 0,
                      dataloader_kwargs: Optional[dict] = None) -> Iterator["BatchProto"]:
        """Yield mini-batches for (ppo_)epochs passes over the batch (ref :511)."""
        n = len(self)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n, mini_batch_size):
                yield self.select_idxs(order[start:start + mini_batch_size])

    # ---------------------------------------------------------------- pad utils
    def pad_to_divisor(self, divisor: int) -> "BatchProto":
        """Pad by cycling samples so len % divisor == 0; records pad size in meta
        (ref pad_dataproto_to_divisor :28)."""
        n = len(self)
        pad = (-n) % divisor
        if pad == 0:
            out = self.select(deepcopy_meta=True)
            out.meta["_pad_size"] = 0
            return out
        idx = np.concatenate([np.arange(n), np.arange(pad) % max(n, 1)])
        out = self.select_idxs(idx)
        out.meta = dict(self.meta)
        out.meta["_pad_size"] = pad
        return out

    def unpad(self) -> "BatchProto":
        pad = self.meta.get("_pad_size", 0)
        if pad == 0:
            return self
        out = self.slice(0, len(self) - pad)
        out.meta = {k: v for k, v in self.meta.items() if k != "_pad_size"}
        return out

    # ------------------------------------------------------------------- device
    def to_numpy(self) -> "BatchProto":
        self.batch = {k: np.asarray(v) for k, v in self.batch.items()}
        return self

    def map_batch(self, fn: Callable[[str, Array], Array]) -> "BatchProto":
        return BatchProto(batch={k: fn(k, v) for k, v in self.batch.items()},
                          non_tensor=self.non_tensor, meta=self.meta)
