"""Data and state carried across from host arrays.

Both packages are fed the same numpy arrays: a table's host arrays (what
weights are to a model) become a port MemoryConnector, and a batch's
planes become a port Batch. Types travel by SQL type name and
dictionaries by their sorted values, so nothing here imports the JAX
package: a caller hands over numpy arrays and plain attributes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, dict_owner
from presto_tpu_torch.catalog.memory import MemoryConnector, MemoryTable
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import Type, parse_type


def _type(t: Union[Type, str]) -> Type:
    return t if isinstance(t, Type) else parse_type(str(t))


def _dictionary(d) -> Dictionary:
    """A port Dictionary from any object with sorted unique `.values`
    (or from the values themselves)."""
    return Dictionary(np.asarray(getattr(d, "values", d)))


def _tensor(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.array(a)).to(device)


def batch_from_arrays(names: Sequence[str], types: Sequence[Union[Type, str]],
                      values: Sequence[np.ndarray],
                      validity: Sequence[Optional[np.ndarray]],
                      hi: Sequence[Optional[np.ndarray]], live: np.ndarray,
                      dicts: Mapping[str, object],
                      device: Union[str, torch.device],
                      structural: Optional[Sequence[Optional[tuple]]] = None
                      ) -> Batch:
    """A port Batch on `device` from per-column numpy planes; a structural
    column's (sizes, evalid, keys) planes, where given, in `structural`."""
    structural = structural or [None] * len(values)
    cols = [Column(_tensor(v, device), _tensor(va, device), _tensor(h, device),
                   *(_tensor(p, device) for p in (st or (None,) * 3)))
            for v, va, h, st in zip(values, validity, hi, structural)]
    return Batch(names, [_type(t) for t in types], cols, _tensor(live, device),
                 {k: _dictionary(d) for k, d in dicts.items()})


def _host(a) -> Optional[np.ndarray]:
    """A plane of either package as numpy: a torch tensor through the CPU,
    anything else (a JAX array) through its array interface."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def batch_to_arrays(b) -> Dict[str, object]:
    """The reverse of batch_from_arrays: numpy planes at the batch's
    capacity, type names and dictionary values. Takes a Batch of either
    package, so the two compare array for array."""
    return {
        "names": list(b.names),
        "types": [str(t) for t in b.types],
        "values": [_host(c.values) for c in b.columns],
        "validity": [_host(c.validity) for c in b.columns],
        "hi": [_host(c.hi) for c in b.columns],
        "live": _host(b.live),
        "dicts": {k: np.asarray(d.values) for k, d in b.dicts.items()},
    }


def connector_from_tables(tables: Mapping[str, object],
                          name: str = "memory") -> MemoryConnector:
    """A port MemoryConnector over the host arrays of existing tables. Each
    table object carries `arrays`, `validity`, `hi`, `dicts`, `types` and
    optionally `primary_key`, `index_keys` and `struct` (an ARRAY or MAP
    column's sizes, element validity and key plane), keyed by column (the
    layout of a MemoryTable); arrays are shared, not copied."""
    conn = MemoryConnector(name)
    for tname, t in tables.items():
        mt = MemoryTable(tname, {})
        mt.primary_key = getattr(t, "primary_key", None)
        mt.index_keys = [list(k) for k in getattr(t, "index_keys", [])]
        for col, planes in getattr(t, "struct", {}).items():
            mt.struct[col] = tuple(None if p is None else np.asarray(p)
                                   for p in planes)
        for key, d in t.dicts.items():
            if dict_owner(key) != key:  # a map column's key dictionary
                mt.dicts[key] = _dictionary(d)
        for col, arr in t.arrays.items():
            mt.types[col] = _type(t.types[col])
            mt.arrays[col] = np.asarray(arr)
            mt.validity[col] = t.validity.get(col)
            h = t.hi.get(col)
            if h is not None:
                mt.hi[col] = np.asarray(h)
            if col in t.dicts:
                mt.dicts[col] = _dictionary(t.dicts[col])
        mt.num_rows = len(next(iter(mt.arrays.values()))) if mt.arrays else 0
        conn.tables[tname] = mt
    return conn
