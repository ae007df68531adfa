"""Order-preserving string dictionaries.

The device never sees string bytes. Every VARCHAR column is encoded as int32
codes into a sorted, deduplicated host-side dictionary, so that:

- equality / range comparison on codes == comparison on strings
- ORDER BY / min / max on codes is correct
- arbitrary string predicates (LIKE, substring, regexp) are evaluated ONCE on
  the host over the dictionary values, producing a boolean lookup table that
  the device applies as `lut[codes]` — a gather, which TPUs do well.

This replaces the per-row string machinery of the reference
(presto-spi/.../block/VariableWidthBlock.java, operator/scalar/StringFunctions.java,
joni regexps) with plan-time host work + O(|dict|) tables. Presto itself leans
on DictionaryBlock (spi/block/DictionaryBlock.java) for hot paths; we make it
the only representation.
"""

from __future__ import annotations

import numpy as np


def safe_str_array(values) -> np.ndarray:
    """Strings → numpy array WITHOUT the U-dtype trailing-NUL trap.

    numpy fixed-width unicode silently drops trailing NUL characters at
    conversion (np.asarray(['ab\\x00']) == 'ab'), which would collapse
    distinct VARBINARY / IPADDRESS canonical-byte entries onto one code.
    Entries that end with NUL keep object dtype (Python-string compares:
    O(|dict|) host work only — per-row device paths see codes either way)."""
    if not isinstance(values, np.ndarray):
        # a plain list would go straight to U dtype (NULs already lost)
        values = np.asarray(values, dtype=object)
    arr = np.asarray(values)
    if arr.dtype.kind == "O":
        if any(isinstance(v, str) and v.endswith("\x00") for v in arr.flat):
            return np.asarray([str(v) for v in arr.flat], dtype=object)
        # U-dtype is n * maxlen * 4 bytes: one long entry (a serialized
        # HLL/tdigest sketch is ~10 KB) in a capacity-sized column turns
        # the astype + np.unique sort into gigabytes of fixed-width
        # copies (measured: 245 s for ONE approx_set query). Past a
        # modest footprint, stay object-dtype — np.unique sorts it with
        # per-object compares, which mostly-duplicate sketch columns
        # finish in milliseconds.
        maxlen = max((len(v) for v in arr.flat if isinstance(v, str)),
                     default=0)
        if arr.size * maxlen * 4 > (1 << 24):
            return np.asarray(
                [v if isinstance(v, str) else str(v) for v in arr.flat],
                dtype=object)
        return arr.astype(str)
    return arr


def fnv64(s: str) -> int:
    """Deterministic 64-bit FNV-1a over utf-8 (process- and
    dictionary-independent, unlike Python's randomized hash())."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class Dictionary:
    """Sorted unique string values; identity-hashed so jit caches by object."""

    __slots__ = ("values", "_index", "_memo")

    def __init__(self, values: np.ndarray):
        # values must be sorted & unique (np.str_ / object array of str)
        self.values = np.asarray(values)
        self._index = None
        self._memo = {}

    @staticmethod
    def encode(strings) -> tuple["Dictionary", np.ndarray]:
        """Build a dictionary from raw strings; return (dict, int32 codes)."""
        arr = safe_str_array(strings)
        uniq, codes = np.unique(arr, return_inverse=True)
        return Dictionary(uniq), codes.astype(np.int32)

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int:
        """Exact-match code of a string, or -1 if absent."""
        i = int(np.searchsorted(self.values, s))
        if i < len(self.values) and self.values[i] == s:
            return i
        return -1

    def range_codes(self, s: str, side: str = "left") -> int:
        """searchsorted position for range predicates on codes."""
        return int(np.searchsorted(self.values, s, side=side))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes)
        out = np.empty(codes.shape, dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out

    def lut(self, predicate) -> np.ndarray:
        """Host-evaluate `predicate(str) -> bool` over dictionary values.

        Returns a bool table of shape (len+1,) indexed by code+1 so that
        code -1 (null) maps to slot 0 == False. Device applies as
        table[codes + 1].
        """
        table = np.zeros(len(self.values) + 1, dtype=bool)
        for i, v in enumerate(self.values):
            table[i + 1] = bool(predicate(str(v)))
        return table

    def map_to(self, other: "Dictionary") -> np.ndarray:
        """Code-remap table: self codes -> other codes (-1 if absent).

        Used when joining / unioning string columns encoded against different
        dictionaries (analog of DictionaryBlock id remapping).
        """
        pos = np.searchsorted(other.values, self.values)
        pos = np.clip(pos, 0, max(len(other.values) - 1, 0))
        if len(other.values):
            ok = other.values[pos] == self.values
        else:
            ok = np.zeros(len(self.values), dtype=bool)
        out = np.where(ok, pos, -1).astype(np.int32)
        # slot for null code (-1) — prepend so device indexes with codes+1
        return np.concatenate([np.array([-1], np.int32), out])

    def transform(self, key, fn) -> tuple["Dictionary", np.ndarray]:
        """String→string function applied over the dictionary (substr, upper,
        concat-with-constant, …). Returns (new_dict, remap) where
        remap[code+1] is the new code (remap[0] = -1 for null). `fn` may
        return None to signal SQL NULL (regexp_extract with no match,
        json_extract_scalar on absent paths) — those entries remap to -1 and
        the device evaluator clears validity where the new code is negative.
        The result is canonical: equal output strings collapse to one code,
        so grouping / equality on the output column stay exact. Memoized by
        `key` so repeated jit traces reuse the identical Dictionary object
        (identity hashing keeps the XLA cache warm)."""
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        outs = [fn(str(v)) for v in self.values]
        body = np.full(len(outs), -1, dtype=np.int32)
        notnull = [i for i, o in enumerate(outs) if o is not None]
        if notnull:
            uniq, inv = np.unique(
                safe_str_array(np.asarray(
                    [str(outs[i]) for i in notnull], dtype=object)),
                return_inverse=True,
            )
            body[notnull] = inv.astype(np.int32)
        else:
            uniq = np.asarray([], dtype=object)
        nd = Dictionary(uniq)
        remap = np.concatenate([np.array([-1], np.int32), body])
        self._memo[key] = (nd, remap)
        return nd, remap

    def int_lut(self, key, fn, dtype=np.int64) -> np.ndarray:
        """String→int function over the dictionary (length, strpos, …) as a
        code-indexed table; slot 0 (null) = 0. Memoized like transform()."""
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        table = np.zeros(len(self.values) + 1, dtype=dtype)
        for i, v in enumerate(self.values):
            table[i + 1] = fn(str(v))
        self._memo[key] = table
        return table

    def content_hash_lut(self) -> np.ndarray:
        """code+1-indexed table of 64-bit string-content hashes (slot 0 =
        NULL → 0). Partitioning/exchange MUST hash string keys by content,
        not by dictionary code: two sides of a join may be encoded against
        different dictionaries and equal strings must co-partition
        (reference InterpretedHashGenerator hashes the value bytes)."""
        return self.int_lut(
            "__content_hash",
            lambda s: np.int64(fnv64(s) & 0x7FFFFFFFFFFFFFFF),
        )

    @staticmethod
    def merge(a: "Dictionary", b: "Dictionary") -> "Dictionary":
        """Union dictionary, with identity stability: when one side already
        contains the other, that object is returned unchanged, and repeated
        merges of the same pair return the same object. Identity matters —
        Batches key jit caches by dictionary identity, so an accumulator
        loop that re-merged every step would otherwise retrace/recompile
        per batch."""
        if a is b:
            return a
        memo = a._memo.setdefault("__merge", {})
        hit = memo.get(id(b))
        if hit is not None:
            return hit[1]
        if len(b.values) <= len(a.values) and np.isin(
            b.values, a.values, assume_unique=True
        ).all():
            out = a
        elif len(a.values) < len(b.values) and np.isin(
            a.values, b.values, assume_unique=True
        ).all():
            out = b
        else:
            out = Dictionary(np.unique(np.concatenate([a.values, b.values])))
        # pin the partner object: the memo key is id(b), so b must not be
        # collected and have its id reused. Bounded FIFO — long-lived table
        # dictionaries in a server would otherwise accrete one entry per
        # novel partner forever
        def put(m, key, val):
            if len(m) >= 64:
                m.pop(next(iter(m)))
            m[key] = val

        put(memo, id(b), (b, out))
        put(b._memo.setdefault("__merge", {}), id(a), (a, out))
        return out

    # identity hash/eq: a Dictionary is immutable once built; jit static-arg
    # caching keys off the object, and reusing the same object per table
    # column avoids retraces.
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def content_digest(self) -> str:
        """16-hex digest of the values — stable across processes, unlike
        id()/default repr. Memoized (immutable once built)."""
        d = self._memo.get("__digest")
        if d is None:
            import hashlib

            h = hashlib.sha256()
            if self.values.dtype.kind == "U":
                h.update(str(self.values.dtype).encode())
                h.update(self.values.tobytes())
            else:
                for v in self.values.flat:
                    h.update(str(v).encode("utf-8", "surrogatepass"))
                    h.update(b"\x00")
            d = h.hexdigest()[:16]
            self._memo["__digest"] = d
        return d

    def __repr__(self):
        # Dictionaries ride in Batch pytree aux, so this repr reaches
        # repr(treedef) — which keys persisted program artifacts. It must
        # not contain process-specific state (the default repr's 0x
        # address broke cross-process artifact restore for every
        # dict-encoded column).
        return f"Dictionary({len(self.values)}@{self.content_digest()})"
