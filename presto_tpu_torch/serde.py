"""Page format: Batch <-> bytes for spill files and the exchange.

The JAX package's page format, byte for byte (reference:
execution/buffer/PagesSerde.java:44 and the per-block encodings): a
`PTP1` magic, a flags byte and two lengths, a JSON header (row count,
names, types, which columns carry validity, a long-decimal limb or
structural planes, the dictionaries inline, and an optional radix stamp),
then the live rows' flat little-endian column buffers, validity bit-packed.
zstd compresses payloads over 512 bytes when `zstandard` imports, as in
the JAX package; where it does not, pages are written uncompressed (a
reader without it refuses a compressed page).

Device tensors cross to the host with one `.cpu()` a plane;
`deserialize_batch` puts the batch on the device its caller names. On the
wire (`dict_refs=True`) a dictionary of more than `_DICT_INLINE_MAX`
values goes as its content digest; a consumer that has not interned it
resolves it once through the producer's `/v1/dict/{digest}`
(`lookup_dictionary`), as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, round_up_capacity
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import parse_type

_MAGIC = b"PTP1"
_FLAG_ZSTD = 1

# dictionaries at or under this many values are always inlined on the wire:
# the ref+fetch round trip costs more than the payload
_DICT_INLINE_MAX = 64

try:
    import zstandard as _zstd
except Exception:  # noqa: BLE001 — zstd is optional, as in the JAX package
    _zstd = None


class TaggedBatch(Batch):
    """A deserialized page carrying its producer's radix partition id,
    `radix` = (partition_id, num_partitions, key_names). Consumers that
    radix-partition read it through getattr and strip it to a plain
    Batch."""

    __slots__ = ("radix",)

    def __init__(self, names, types, columns, live, dicts, radix):
        super().__init__(names, types, columns, live, dicts)
        self.radix = radix


_TLS = threading.local()


def _zc():
    """Per-thread compressor (zstd objects are not safe to share)."""
    if _zstd is None:
        return None
    c = getattr(_TLS, "zc", None)
    if c is None:
        c = _TLS.zc = _zstd.ZstdCompressor(level=1)
    return c


def _zd():
    if _zstd is None:
        raise RuntimeError("page is zstd-compressed and zstandard is not "
                           "installed")
    d = getattr(_TLS, "zd", None)
    if d is None:
        d = _TLS.zd = _zstd.ZstdDecompressor()
    return d


# -- dictionary interning ----------------------------------------------------
# One canonical Dictionary object per content: pages read back carry the
# same logical dictionary, and codes coded against one object merge and
# join without a remap. Keys are sha256 content digests; the table is a
# bounded LRU (computed string columns make a fresh Dictionary a batch).

_DICT_INTERN: "OrderedDict[bytes, Dictionary]" = OrderedDict()
_DICT_INTERN_CAP = 4096
_DICT_INTERN_LOCK = threading.Lock()


def _dict_content_key(values: np.ndarray) -> bytes:
    h = hashlib.sha256()
    if values.dtype.kind not in ("O", "U", "S"):
        h.update(values.tobytes())
    else:
        h.update("\x00".join(map(str, values)).encode("utf-8", "surrogatepass"))
    return h.digest()


def _intern_put(key: bytes, make: Callable[[], Dictionary]) -> Dictionary:
    """Atomic get-or-insert with an LRU bump."""
    with _DICT_INTERN_LOCK:
        hit = _DICT_INTERN.get(key)
        if hit is not None:
            _DICT_INTERN.move_to_end(key)
            return hit
        d = make()
        _DICT_INTERN[key] = d
        while len(_DICT_INTERN) > _DICT_INTERN_CAP:
            _DICT_INTERN.popitem(last=False)
        return d


def intern_dictionary(values: np.ndarray) -> Dictionary:
    values = np.asarray(values)
    return _intern_put(_dict_content_key(values), lambda: Dictionary(values))


def register_dictionary(d: Dictionary) -> Dictionary:
    """Intern a producer-side dictionary before its pages are written, so
    pages read back resolve to the identical object. Memoized per
    Dictionary object."""
    if d._memo.get("__interned"):
        return d
    out = _intern_put(_dict_content_key(d.values), lambda: d)
    d._memo["__interned"] = True
    return out


def _intern_hit(key: bytes) -> Optional[Dictionary]:
    with _DICT_INTERN_LOCK:
        hit = _DICT_INTERN.get(key)
        if hit is not None:
            _DICT_INTERN.move_to_end(key)
        return hit


def lookup_dictionary(digest_hex: str) -> Optional[List[str]]:
    """The value list of an interned dictionary by its digest, for the
    /v1/dict endpoint; None when evicted or never seen (the producer
    interns every dictionary it sends by reference, so a miss means LRU
    eviction and the consumer fails the page)."""
    try:
        key = bytes.fromhex(digest_hex)
    except ValueError:
        return None
    d = _intern_hit(key)
    return None if d is None else [str(v) for v in d.values]


def _dict_ref_json(d: Dictionary) -> str:
    """A dictionary's by-reference entry of a wire page's header."""
    js = d._memo.get("__ref_json")
    if js is None:
        js = d._memo["__ref_json"] = json.dumps(
            {"ref": _dict_content_key(d.values).hex(), "len": len(d.values)},
            separators=(",", ":"))
    return js


def _dict_json(d: Dictionary) -> str:
    """A dictionary's entry of a page header, its values as a JSON list;
    made once a dictionary (a page of a string column carries its whole
    dictionary, and a spilled stream writes the same one page after
    page)."""
    js = d._memo.get("__page_json")
    if js is None:
        js = d._memo["__page_json"] = json.dumps(
            [str(v) for v in d.values], separators=(",", ":"))
    return js


# pages' dictionary sections by content digest -> {entry: Dictionary}:
# the replay of a spilled stream reads the same section page after page
_PAGE_DICTS: "OrderedDict[bytes, dict]" = OrderedDict()
_PAGE_DICTS_CAP = 64


def _ref_dictionary(entry: dict, resolver) -> Dictionary:
    """A by-reference entry: the interned dictionary of its digest, or
    the values the resolver fetches for it (once; they are interned)."""
    key = bytes.fromhex(entry["ref"])
    d = _intern_hit(key)
    if d is not None:
        return d
    if resolver is None:
        raise ValueError(f"page references dictionary {entry['ref'][:12]} "
                         "with no resolver available")
    vals = np.asarray(resolver(entry["ref"]), dtype=object)
    return _intern_put(key, lambda: Dictionary(vals))


def _page_dicts(section: bytes, resolver=None) -> dict:
    """The dictionaries of a page's `dicts` JSON object, interned."""
    key = hashlib.sha256(section).digest()
    with _DICT_INTERN_LOCK:
        hit = _PAGE_DICTS.get(key)
        if hit is not None:
            _PAGE_DICTS.move_to_end(key)
            return hit
    out = {k: (_ref_dictionary(v, resolver) if isinstance(v, dict)
               else intern_dictionary(np.asarray(v, dtype=object)))
           for k, v in json.loads(section).items()}
    with _DICT_INTERN_LOCK:
        _PAGE_DICTS[key] = out
        while len(_PAGE_DICTS) > _PAGE_DICTS_CAP:
            _PAGE_DICTS.popitem(last=False)
    return out


def _pack_bits(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(np.uint8)).tobytes()


def _unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), count=n).astype(bool)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def serialize_batch(b: Batch, compress: bool = True,
                    radix: Optional[tuple] = None,
                    dict_refs: bool = False) -> bytes:
    """Compact the live rows and serialize them. `radix` =
    (partition_id, num_partitions, key_names) stamps the page (it reads
    back as a TaggedBatch). `dict_refs` sends dictionaries past
    `_DICT_INLINE_MAX` values as their digest (wire pages only: spill
    files stay self-contained)."""
    live = _host(b.live)
    n = int(live.sum())
    header = {"n": n, "names": list(b.names), "types": [str(t) for t in b.types],
              "validity": [], "limbs": [], "struct": []}
    dicts = []
    buffers: List[bytes] = []
    for name, c in zip(b.names, b.columns):
        vals = _host(c.values)[live]
        buffers.append(np.ascontiguousarray(vals).tobytes())
        if c.validity is not None:
            header["validity"].append(True)
            buffers.append(_pack_bits(_host(c.validity)[live]))
        else:
            header["validity"].append(False)
        if c.hi is not None:
            # the long-decimal high limb rides as a second int64 buffer
            header["limbs"].append(True)
            buffers.append(np.ascontiguousarray(_host(c.hi)[live]).tobytes())
        else:
            header["limbs"].append(False)
        if c.sizes is not None:
            # structural planes: [w, has_evalid, has_keys, keys_dtype]; the
            # values buffer above is the [n, w] element plane, row-major
            w = int(c.values.shape[1])
            has_ev = c.evalid is not None
            has_k = c.keys is not None
            header["struct"].append(
                [w, has_ev, has_k,
                 str(_host(c.keys).dtype) if has_k else None])
            buffers.append(
                np.ascontiguousarray(_host(c.sizes)[live]).tobytes())
            if has_ev:
                buffers.append(_pack_bits(_host(c.evalid)[live].reshape(-1)))
            if has_k:
                buffers.append(
                    np.ascontiguousarray(_host(c.keys)[live]).tobytes())
        else:
            header["struct"].append(None)
        for dk in (name, name + "#keys"):
            if dk in b.dicts:
                dicts.append((dk, register_dictionary(b.dicts[dk])))
    payload = b"".join(buffers)
    flags = 0
    zc = _zc()
    if compress and zc is not None and len(payload) > 512:
        payload = zc.compress(payload)
        flags |= _FLAG_ZSTD
    # the header's JSON, keys in the JAX package's order, with each
    # dictionary's cached list spliced in
    parts = [json.dumps(header, separators=(",", ":"))[:-1], ',"dicts":{',
             ",".join(json.dumps(k) + ":" + (
                 _dict_ref_json(d) if dict_refs and len(d.values)
                 > _DICT_INLINE_MAX else _dict_json(d)) for k, d in dicts),
             "}"]
    if radix is not None:
        r, num, keys = radix
        parts.append(',"radix":' + json.dumps([int(r), int(num), list(keys)],
                                              separators=(",", ":")))
    hj = ("".join(parts) + "}").encode()
    return _MAGIC + struct.pack("<BII", flags, len(hj), len(payload)) + hj + payload


def _page_header(data: bytes):
    """(flags, header without its dicts, raw dicts bytes, payload offset,
    payload length) of a page. The `dicts` object is parsed apart
    (`_page_dicts`): no string of the header holds an unescaped quote, so
    its key and the `radix` key after it are found by their text."""
    if data[:4] != _MAGIC:
        raise ValueError("bad page magic")
    flags, hlen, plen = struct.unpack_from("<BII", data, 4)
    off = 4 + 9
    hb = data[off:off + hlen]
    start = hb.index(b'"dicts":')
    end = hb.rfind(b',"radix":[')
    if end < start:
        end = len(hb) - 1
    header = json.loads(hb[:start] + b'"dicts":{}' + hb[end:])
    return flags, header, hb[start + len(b'"dicts":'):end], off + hlen, plen


def page_rows(data: bytes) -> int:
    """The live rows a page carries, from its header alone (no decode, no
    device)."""
    return int(_page_header(data)[1]["n"])


def deserialize_batch(data: bytes, capacity: Optional[int] = None,
                      device: Union[str, torch.device] = "cpu",
                      dict_resolver: Optional[Callable[[str], List[str]]]
                      = None) -> Batch:
    """A page back as a Batch on `device`, its n rows live and padded to
    `capacity` (default: n's power-of-two bucket). `dict_resolver(digest)`
    fetches the values of a by-reference dictionary this process has not
    interned."""
    flags, header, raw_dicts, poff, plen = _page_header(data)
    dicts = _page_dicts(raw_dicts, dict_resolver)
    payload = data[poff:poff + plen]
    if flags & _FLAG_ZSTD:
        payload = _zd().decompress(payload)
    n = header["n"]
    cap = capacity or round_up_capacity(max(n, 1))
    names = header["names"]
    types = [parse_type(s) for s in header["types"]]

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    cols = []
    pos = 0
    limbs = header.get("limbs") or [False] * len(names)
    structs = header.get("struct") or [None] * len(names)
    for t, has_valid, has_hi, st in zip(types, header["validity"], limbs,
                                        structs):
        dt = np.dtype(str(t.dtype))
        w = st[0] if st is not None else None
        count = n * w if w is not None else n
        vals = np.frombuffer(payload, dt, count=count, offset=pos)
        pos += count * dt.itemsize
        if w is not None:
            buf = np.zeros((cap, w), dtype=dt)
            buf[:n] = vals.reshape(n, w)
        else:
            buf = np.zeros(cap, dtype=dt)
            buf[:n] = vals
        valid_arr = None
        if has_valid:
            vb = (n + 7) // 8
            vbuf = np.zeros(cap, dtype=bool)
            vbuf[:n] = _unpack_bits(payload[pos:pos + vb], n)
            pos += vb
            valid_arr = put(vbuf)
        hi_arr = None
        if has_hi:
            hbuf = np.zeros(cap, dtype=np.int64)
            hbuf[:n] = np.frombuffer(payload, np.int64, count=n, offset=pos)
            pos += n * 8
            hi_arr = put(hbuf)
        sizes_arr = evalid_arr = keys_arr = None
        if st is not None:
            _, has_ev, has_k, kdt = st
            sbuf = np.zeros(cap, np.int32)
            sbuf[:n] = np.frombuffer(payload, np.int32, count=n, offset=pos)
            pos += n * 4
            sizes_arr = put(sbuf)
            if has_ev:
                eb = (n * w + 7) // 8
                ebuf = np.zeros((cap, w), bool)
                ebuf[:n] = _unpack_bits(payload[pos:pos + eb],
                                        n * w).reshape(n, w)
                pos += eb
                evalid_arr = put(ebuf)
            if has_k:
                kd = np.dtype(kdt)
                kbuf = np.zeros((cap, w), kd)
                kbuf[:n] = np.frombuffer(payload, kd, count=n * w,
                                         offset=pos).reshape(n, w)
                pos += n * w * kd.itemsize
                keys_arr = put(kbuf)
        cols.append(Column(put(buf), valid_arr, hi_arr, sizes_arr,
                           evalid_arr, keys_arr))
    live = np.zeros(cap, dtype=bool)
    live[:n] = True
    rd = header.get("radix")
    if rd is not None:
        return TaggedBatch(names, types, cols, put(live), dicts,
                           (int(rd[0]), int(rd[1]), tuple(rd[2])))
    return Batch(names, types, cols, put(live), dicts)
