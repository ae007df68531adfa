"""IPADDRESS / IPPREFIX host-side value functions.

Reference surface: presto-main/src/main/java/com/facebook/presto/type/
IpAddressType.java, IpAddressOperators.java and
operator/scalar/IpPrefixFunctions.java.

Design (TPU-first): an IPADDRESS is dictionary-encoded exactly like
VARCHAR, but the dictionary ENTRY is the canonical 16-byte IPv6 form of
the address mapped through the latin-1 bijection (the same trick
types.VarbinaryType uses).  Byte order on the canonical form IS address
order (the reference compares the 16-byte value too), so comparisons,
joins, grouping, sorting and range predicates all ride the existing
order-preserving code machinery with zero new device code.  An IPPREFIX
entry is the 16-byte canonical NETWORK address plus one trailing
prefix-length byte, which sorts by (address, length) — the reference's
IPPREFIX ordering.

Every function here is host-side, evaluated once per dictionary entry
and applied on device as a gather (see expr/compile.py _STR_TO_STR).
Malformed text yields None → SQL NULL, the engine's documented
deviation from the reference's row-level cast errors.
"""

from __future__ import annotations

import ipaddress


def _from_latin1(s: str) -> bytes:
    return s.encode("latin-1")


def _to_latin1(b: bytes) -> str:
    return b.decode("latin-1")


def _as_obj(b16: bytes):
    """16-byte canonical form → IPv4Address (if v4-mapped) or IPv6Address."""
    v6 = ipaddress.IPv6Address(b16)
    v4 = v6.ipv4_mapped
    return v4 if v4 is not None else v6


def _canon_bytes(addr) -> bytes:
    """Address object → canonical 16 bytes (v4 → v4-mapped v6)."""
    if isinstance(addr, ipaddress.IPv4Address):
        return bytes(10) + b"\xff\xff" + addr.packed
    return addr.packed


def parse_address(s: str) -> str | None:
    """Text ('1.2.3.4' or any v6 form) → canonical entry, None if invalid."""
    try:
        return _to_latin1(_canon_bytes(ipaddress.ip_address(s.strip())))
    except ValueError:
        return None


def address_from_bytes(s: str) -> str | None:
    """VARBINARY entry (4 or 16 bytes) → canonical entry (cast varbinary →
    ipaddress; reference IpAddressOperators.castFromVarbinaryToIpAddress)."""
    b = _from_latin1(s)
    if len(b) == 4:
        return _to_latin1(bytes(10) + b"\xff\xff" + b)
    if len(b) == 16:
        return s
    return None


def format_address(entry: str) -> str | None:
    """Canonical entry → display text ('1.2.3.4' for v4-mapped, compressed
    lowercase v6 otherwise — reference castFromIpAddressToVarchar)."""
    b = _from_latin1(entry)
    if len(b) != 16:
        return None
    return str(_as_obj(b))


def parse_prefix(s: str) -> str | None:
    """Text 'addr/len' → canonical prefix entry (network address is masked:
    '192.168.255.255/9' canonicalizes to '192.128.0.0/9')."""
    try:
        net = ipaddress.ip_network(s.strip(), strict=False)
    except ValueError:
        return None
    return _to_latin1(_canon_bytes(net.network_address)
                      + bytes([net.prefixlen]))


def _prefix_obj(b: bytes):
    """Prefix entry bytes → the network's ADDRESS object. Family comes
    from the prefix LENGTH, not the address bytes: a v6 prefix like
    ::ffff:1.2.3.0/120 has a v4-mapped network address but must stay v6
    (lengths > 32 are meaningless for v4)."""
    v6 = ipaddress.IPv6Address(b[:16])
    v4 = v6.ipv4_mapped
    return v4 if (v4 is not None and b[16] <= 32) else v6


def format_prefix(entry: str) -> str | None:
    b = _from_latin1(entry)
    if len(b) != 17:
        return None
    return f"{_prefix_obj(b)}/{b[16]}"


def ip_prefix(entry: str, bits: int) -> str | None:
    """Canonical IPADDRESS entry → IPPREFIX with the given length, masked
    to the network address. v4 addresses take v4 lengths (0-32), v6 take
    0-128 (reference IpPrefixFunctions.ipPrefix). Text input must be
    parsed by the caller first — a 16-char address TEXT is
    indistinguishable from 16 canonical bytes."""
    b = _from_latin1(entry)
    if len(b) != 16:
        return None
    addr = _as_obj(b)
    maxlen = 32 if isinstance(addr, ipaddress.IPv4Address) else 128
    if not 0 <= bits <= maxlen:
        return None
    net = ipaddress.ip_network((addr, bits), strict=False)
    return _to_latin1(_canon_bytes(net.network_address) + bytes([bits]))


def _as_network(entry: str):
    b = _from_latin1(entry)
    if len(b) != 17:
        return None
    try:
        return ipaddress.ip_network((_prefix_obj(b), b[16]), strict=False)
    except ValueError:
        return None


def subnet_min(entry: str) -> str | None:
    """IPPREFIX → lowest address (the network address itself)."""
    net = _as_network(entry)
    if net is None:
        return None
    return _to_latin1(_canon_bytes(net.network_address))


def subnet_max(entry: str) -> str | None:
    """IPPREFIX → highest address (v4 broadcast / v6 last address)."""
    net = _as_network(entry)
    if net is None:
        return None
    return _to_latin1(_canon_bytes(net.broadcast_address))


def _v6_bits(b: bytes) -> int | None:
    """Prefix entry → its length in the 128-bit universe: a v4 prefix
    (/n over a v4-mapped network, n ≤ 32) masks the same bit set as the
    v6 prefix /n+96, so containment can compare raw bits across
    families (the reference compares the 16-byte values directly)."""
    n = b[16]
    if n <= 32 and b[:12] == bytes(10) + b"\xff\xff":
        return n + 96
    return n if n <= 128 else None


def is_subnet_of(prefix_entry: str, entry: str) -> bool:
    """Does `prefix` contain the address (16-byte entry) or the whole
    prefix (17-byte entry)?  Pure bit-level containment over the
    canonical 128-bit forms — ::ffff:1.2.3.0/120 and 1.2.3.0/24 denote
    the same set. Distinct v4/v6 regions are naturally disjoint (a v4
    prefix's mask pins the ::ffff:0:0/96 marker bits)."""
    pb = _from_latin1(prefix_entry)
    if len(pb) != 17:
        return False
    plen = _v6_bits(pb)
    if plen is None:
        return False
    xb = _from_latin1(entry)
    if len(xb) == 16:
        xlen = 128
    elif len(xb) == 17:
        xlen = _v6_bits(xb)
        if xlen is None:
            return False
        xb = xb[:16]
    else:
        return False
    if xlen < plen:
        return False
    mask = ((1 << plen) - 1) << (128 - plen) if plen else 0
    pa = int.from_bytes(pb[:16], "big")
    xa = int.from_bytes(xb, "big")
    return (pa & mask) == (xa & mask)
