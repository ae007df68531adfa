"""TPC-H data-generator connector.

Analog of presto-tpch (TpchConnectorFactory / TpchMetadata over
io.airlift.tpch): an in-process, deterministic, scale-factor-parameterized
TPC-H dataset served directly as columnar batches.

The generator follows the TPC-H schema, cardinalities and value domains
(dates 1992-01-01..1998-12-31, DECIMAL(15,2) money columns, the standard
enum vocabularies) using seeded numpy, vectorized — it is not bit-compatible
with dbgen (correctness is checked against a pandas oracle over the same
data, the H2QueryRunner pattern, not against published answer sets).

Referential integrity is exact: l_orderkey ⊆ o_orderkey, (l_partkey,
l_suppkey) ⊆ partsupp, o_custkey ⊆ customer, etc., and o_totalprice is
consistent with the order's lineitems, so every TPC-H query shape is
meaningful.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from presto_tpu_torch.catalog.memory import MemoryConnector, MemoryTable
from presto_tpu_torch.types import DATE, DecimalType, INTEGER, BIGINT, VARCHAR

_D = DecimalType(15, 2)

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
_CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
    "white", "yellow",
]

_EPOCH_1992 = 8035  # days from 1970-01-01 to 1992-01-01
_EPOCH_1998_END = 10591  # 1998-12-31
_CURRENT_DATE = 9298  # 1995-06-17, the TPC-H "currentdate"


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """DECIMAL(15,2) unscaled cents."""
    return rng.integers(int(lo * 100), int(hi * 100) + 1, n, dtype=np.int64)


def _keyed_names(prefix: str, keys: np.ndarray) -> np.ndarray:
    """Vectorized f"{prefix}{key:09d}" (np.char, no per-row Python)."""
    return np.char.add(prefix, np.char.zfill(keys.astype("U9"), 9)).astype(object)


def _vocab_codes(prefix: str, rng, n: int, vocab_size: int = 9973):
    """Rotating comment vocabulary as (Dictionary, codes) — the engine's
    dictionary-encoded string form, generated without any per-row Python.
    (Comments are uniform filler in the spec; a bounded sorted vocabulary
    keeps generation and IO linear in vocab size, not row count.)"""
    from presto_tpu_torch.dictionary import Dictionary

    vocab = np.sort(np.array([f"{prefix} {i}" for i in range(vocab_size)]))
    return Dictionary(vocab), rng.integers(0, vocab_size, n).astype(np.int32)


def _phones(keys: np.ndarray, nat: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized phone strings "{cc}-{nnn}-{nnnn}" (purely key-derived)."""
    i = keys.astype(np.int64)
    cc = (10 + (nat if nat is not None else i % 25)).astype("U2")
    mid = (i % 900 + 100).astype("U3")
    last = (i % 9000 + 1000).astype("U4")
    return np.char.add(np.char.add(np.char.add(np.char.add(cc, "-"), mid), "-"),
                       last).astype(object)


class TpchGenerator:
    def __init__(self, sf: float = 1.0, seed: int = 19920101):
        self.sf = sf
        self.seed = seed

    def _rng(self, salt: int):
        return np.random.default_rng(self.seed + salt)

    # cardinalities (TPC-H spec §4.2.5)
    @property
    def n_supplier(self):
        return max(1, int(10_000 * self.sf))

    @property
    def n_part(self):
        return max(1, int(200_000 * self.sf))

    @property
    def n_customer(self):
        return max(1, int(150_000 * self.sf))

    @property
    def n_orders(self):
        return max(1, int(1_500_000 * self.sf))

    def region(self) -> Dict[str, np.ndarray]:
        return {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(_REGIONS, dtype=object),
            "r_comment": np.array([f"region comment {i}" for i in range(5)], dtype=object),
        }

    def nation(self) -> Dict[str, np.ndarray]:
        return {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.array([n for n, _ in _NATIONS], dtype=object),
            "n_regionkey": np.array([r for _, r in _NATIONS], dtype=np.int64),
            "n_comment": np.array([f"nation comment {i}" for i in range(25)], dtype=object),
        }

    def supplier(self) -> Dict[str, np.ndarray]:
        n = self.n_supplier
        rng = self._rng(1)
        keys = np.arange(1, n + 1, dtype=np.int64)
        # spec: ~5/10000 suppliers carry the "Customer Complaints" marker
        # (Q16's filter); the rest draw from the comment vocabulary
        cd, cc = _vocab_codes("supplier comment", rng, n)
        from presto_tpu_torch.dictionary import Dictionary

        marked = rng.random(n) < 0.0005
        vocab = np.sort(np.append(cd.values, "Customer Complaints"))
        d2 = Dictionary(vocab)
        remap = np.searchsorted(vocab, cd.values)
        codes = np.where(marked, np.searchsorted(vocab, "Customer Complaints"),
                         remap[cc]).astype(np.int32)
        return {
            "s_suppkey": keys,
            "s_name": _keyed_names("Supplier#", keys),
            "s_address": _keyed_names("addrsup#", keys),
            "s_nationkey": rng.integers(0, 25, n, dtype=np.int64),
            "s_phone": _phones(keys),
            "s_acctbal": _money(rng, -999.99, 9999.99, n),
            "s_comment": (d2, codes),
        }

    def customer(self) -> Dict[str, np.ndarray]:
        n = self.n_customer
        rng = self._rng(2)
        nat = rng.integers(0, 25, n, dtype=np.int64)
        keys = np.arange(1, n + 1, dtype=np.int64)
        return {
            "c_custkey": keys,
            "c_name": _keyed_names("Customer#", keys),
            "c_address": _keyed_names("addrcust#", keys),
            "c_nationkey": nat,
            "c_phone": _phones(keys, nat),
            "c_acctbal": _money(rng, -999.99, 9999.99, n),
            "c_mktsegment": np.asarray(rng.choice(_SEGMENTS, n), dtype=object),
            "c_comment": _vocab_codes("customer comment", rng, n),
        }

    def part(self) -> Dict[str, np.ndarray]:
        from presto_tpu_torch.dictionary import Dictionary

        n = self.n_part
        rng = self._rng(3)
        # enum-product columns generate as dictionary codes over the full
        # cross-product vocabulary (150 types, 40 containers, 8464 names) —
        # no per-row Python string construction at any scale factor
        type_vocab = np.sort(np.array(
            [f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2 for c in _TYPE_S3]))
        t_d = Dictionary(type_vocab)
        s123 = rng.integers(0, len(type_vocab), n).astype(np.int32)
        cont_vocab = np.sort(np.array(
            [f"{a} {b}" for a in _CONTAINER_S1 for b in _CONTAINER_S2]))
        c_d = Dictionary(cont_vocab)
        c12 = rng.integers(0, len(cont_vocab), n).astype(np.int32)
        name_vocab = np.sort(np.array(
            [f"{a} {b}" for a in _COLORS for b in _COLORS if a != b]))
        n_d = Dictionary(name_vocab)
        nc = rng.integers(0, len(name_vocab), n).astype(np.int32)
        brand_vocab = np.sort(np.array(
            [f"Brand#{m}{x}" for m in range(1, 6) for x in range(1, 6)]))
        b_d = Dictionary(brand_vocab)
        bc = rng.integers(0, len(brand_vocab), n).astype(np.int32)
        mfgr_vocab = np.array([f"Manufacturer#{m}" for m in range(1, 6)])
        m_d = Dictionary(mfgr_vocab)
        mc = rng.integers(0, 5, n).astype(np.int32)
        # retail price formula per spec: 90000+((pk/10)%20001)+100*(pk%1000), in cents
        pk = np.arange(1, n + 1, dtype=np.int64)
        retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
        return {
            "p_partkey": pk,
            "p_name": (n_d, nc),
            "p_mfgr": (m_d, mc),
            "p_brand": (b_d, bc),
            "p_type": (t_d, s123),
            "p_size": rng.integers(1, 51, n, dtype=np.int64),
            "p_container": (c_d, c12),
            "p_retailprice": retail,
            "p_comment": _vocab_codes("part comment", rng, n),
        }

    def partsupp(self) -> Dict[str, np.ndarray]:
        npart = self.n_part
        nsupp = self.n_supplier
        rng = self._rng(4)
        pk = np.repeat(np.arange(1, npart + 1, dtype=np.int64), 4)
        j = np.tile(np.arange(4, dtype=np.int64), npart)
        # spec §4.2.5.4: supplier = (pk + j*(S/4 + (pk-1)/S)) % S + 1
        S = nsupp
        sk = (pk + j * (S // 4 + (pk - 1) // S)) % S + 1
        n = len(pk)
        return {
            "ps_partkey": pk,
            "ps_suppkey": sk,
            "ps_availqty": rng.integers(1, 10_000, n, dtype=np.int64),
            "ps_supplycost": _money(rng, 1.00, 1000.00, n),
            "ps_comment": _vocab_codes("partsupp comment", rng, n),
        }

    def orders_and_lineitem(self):
        """Full-table generation (single chunk, original RNG streams)."""
        return self.orders_lineitem_chunk(0, self.n_orders, _salt=(5, 6))

    def orders_lineitem_chunk(self, start: int, count: int, _salt=None):
        """Generate orders [start, start+count) plus their lineitems.

        Chunking keeps peak memory proportional to the chunk, letting
        SF100 (150M orders / 600M lineitems) stream to parquet without
        materializing the table (reference: dbgen's -S step/-C chunk
        options). Lines of an order always live in its chunk, so
        o_totalprice/o_orderstatus stay exact. Each chunk draws from its
        own deterministic RNG streams; foreign keys (customer, part,
        supplier) span the full SF domain."""
        n = count
        if _salt is None:
            _salt = (1000 + 2 * (start // max(count, 1)),
                     1001 + 2 * (start // max(count, 1)))
        rng = self._rng(_salt[0])
        # sparse orderkeys like dbgen (every 8-key block uses first 2... we
        # use *4 spacing for simplicity, keys still sparse + sorted)
        okey = np.arange(start + 1, start + n + 1, dtype=np.int64) * 4
        # only 2/3 of customers have orders (spec: custkey % 3 != 0)
        ncust = self.n_customer
        ckey = rng.integers(1, max(ncust // 3, 1) + 1, n, dtype=np.int64) * 3 - 2
        ckey = np.minimum(ckey, ncust)
        odate = rng.integers(_EPOCH_1992, _EPOCH_1998_END - 151, n, dtype=np.int64)

        nline = rng.integers(1, 8, n)  # 1..7 lines per order
        total_lines = int(nline.sum())
        l_order_idx = np.repeat(np.arange(n), nline)  # index into orders
        # linenumber = position within order, vectorized
        starts = np.cumsum(nline) - nline
        lnum_base = np.arange(total_lines) - starts[l_order_idx] + 1

        lrng = self._rng(_salt[1])
        m = total_lines
        lpart = lrng.integers(1, self.n_part + 1, m, dtype=np.int64)
        # one of the 4 partsupp suppliers for that part
        j = lrng.integers(0, 4, m, dtype=np.int64)
        S = self.n_supplier
        lsupp = (lpart + j * (S // 4 + (lpart - 1) // S)) % S + 1
        qty = lrng.integers(1, 51, m, dtype=np.int64)
        # extendedprice = qty * p_retailprice(part)
        retail = 90000 + (lpart // 10) % 20001 + 100 * (lpart % 1000)
        eprice = qty * retail
        disc = lrng.integers(0, 11, m, dtype=np.int64)  # 0.00..0.10 scale-2
        tax = lrng.integers(0, 9, m, dtype=np.int64)  # 0.00..0.08

        l_odate = odate[l_order_idx]
        shipdate = l_odate + lrng.integers(1, 122, m)
        commitdate = l_odate + lrng.integers(30, 91, m)
        receiptdate = shipdate + lrng.integers(1, 31, m)

        # string columns generate as dictionary codes directly (vocabularies
        # are sorted so codes are order-preserving) — no per-row python strs
        from presto_tpu_torch.dictionary import Dictionary

        rf_dict = Dictionary(np.array(["A", "N", "R"]))
        ra = np.where(lrng.integers(0, 2, m) == 0, 0, 2).astype(np.int32)  # A or R
        returnflag = (rf_dict, np.where(receiptdate <= _CURRENT_DATE, ra, 1).astype(np.int32))
        ls_dict = Dictionary(np.array(["F", "O"]))
        ls_codes = (shipdate > _CURRENT_DATE).astype(np.int32)
        linestatus = (ls_dict, ls_codes)

        smode = (Dictionary(np.array(_SHIP_MODES)),
                 lrng.integers(0, len(_SHIP_MODES), m).astype(np.int32))
        sinstr = (Dictionary(np.array(_INSTRUCTIONS)),
                  lrng.integers(0, len(_INSTRUCTIONS), m).astype(np.int32))

        # order totalprice = sum(extendedprice*(1+tax)*(1-disc)) per order —
        # computed exactly in cents with the same rounding as a decimal engine
        line_total = eprice * (100 - disc) * (100 + tax)  # scale 6
        line_total = (line_total + 5000) // 10000 * 1  # round to cents (scale 2)
        ototal = np.zeros(n, dtype=np.int64)
        np.add.at(ototal, l_order_idx, line_total)

        f_mask = ls_codes == 0
        all_f = np.ones(n, bool)
        any_f = np.zeros(n, bool)
        np.logical_and.at(all_f, l_order_idx, f_mask)
        np.logical_or.at(any_f, l_order_idx, f_mask)
        ostatus_codes = np.full(n, 2, dtype=np.int32)  # P
        ostatus_codes[all_f] = 0  # F
        ostatus_codes[~any_f] = 1  # O
        ostatus = (Dictionary(np.array(["F", "O", "P"])), ostatus_codes)

        n_clerk = max(1, int(1000 * self.sf))
        if not hasattr(self, "_clerk_dict"):
            self._clerk_dict = Dictionary(
                _keyed_names("Clerk#", np.arange(1, n_clerk + 1)).astype(str))
            self._ocomment_vocab = np.sort(
                np.array([f"order comment {i}" for i in range(9973)]))
            self._lcomment_dict = Dictionary(
                np.sort(np.array([f"line comment {i}" for i in range(9973)])))
            self._ocomment_dict = Dictionary(self._ocomment_vocab)
        clerk_dict = self._clerk_dict
        orders = {
            "o_orderkey": okey,
            "o_custkey": ckey,
            "o_orderstatus": ostatus,
            "o_totalprice": ototal,
            "o_orderdate": odate,
            "o_orderpriority": (
                Dictionary(np.array(_PRIORITIES)),
                rng.integers(0, len(_PRIORITIES), n).astype(np.int32),
            ),
            "o_clerk": (clerk_dict, rng.integers(0, n_clerk, n).astype(np.int32)),
            "o_shippriority": np.zeros(n, dtype=np.int64),
            "o_comment": (
                self._ocomment_dict,
                rng.integers(0, 9973, n).astype(np.int32),
            ),
        }
        lineitem = {
            "l_orderkey": okey[l_order_idx],
            "l_partkey": lpart,
            "l_suppkey": lsupp,
            "l_linenumber": lnum_base.astype(np.int64),
            "l_quantity": qty,
            "l_extendedprice": eprice,
            "l_discount": disc,
            "l_tax": tax,
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
            "l_shipdate": shipdate,
            "l_commitdate": commitdate,
            "l_receiptdate": receiptdate,
            "l_shipinstruct": sinstr,
            "l_shipmode": smode,
            "l_comment": (
                self._lcomment_dict,
                lrng.integers(0, 9973, m).astype(np.int32),
            ),
        }
        return orders, lineitem


_TYPES = {
    "region": {"r_regionkey": BIGINT},
    "nation": {"n_nationkey": BIGINT, "n_regionkey": BIGINT},
    "supplier": {"s_suppkey": BIGINT, "s_nationkey": BIGINT, "s_acctbal": _D},
    "customer": {"c_custkey": BIGINT, "c_nationkey": BIGINT, "c_acctbal": _D},
    "part": {"p_partkey": BIGINT, "p_size": BIGINT, "p_retailprice": _D},
    "partsupp": {"ps_partkey": BIGINT, "ps_suppkey": BIGINT, "ps_availqty": BIGINT, "ps_supplycost": _D},
    "orders": {
        "o_orderkey": BIGINT, "o_custkey": BIGINT, "o_totalprice": _D,
        "o_orderdate": DATE, "o_shippriority": BIGINT,
    },
    "lineitem": {
        "l_orderkey": BIGINT, "l_partkey": BIGINT, "l_suppkey": BIGINT,
        "l_linenumber": BIGINT, "l_quantity": BIGINT,
        "l_extendedprice": _D, "l_discount": DecimalType(15, 2), "l_tax": DecimalType(15, 2),
        "l_shipdate": DATE, "l_commitdate": DATE, "l_receiptdate": DATE,
    },
}

# l_discount / l_tax are stored as scale-2 unscaled values already
_PRESCALED = {
    ("supplier", "s_acctbal"), ("customer", "c_acctbal"),
    ("part", "p_retailprice"), ("partsupp", "ps_supplycost"),
    ("orders", "o_totalprice"), ("lineitem", "l_extendedprice"),
    ("lineitem", "l_discount"), ("lineitem", "l_tax"),
}

_PRIMARY_KEYS = {
    "region": ["r_regionkey"],
    "nation": ["n_nationkey"],
    "supplier": ["s_suppkey"],
    "customer": ["c_custkey"],
    "part": ["p_partkey"],
    "orders": ["o_orderkey"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
}


def _column_types(table: str, data: Dict[str, np.ndarray]) -> Dict[str, "Type"]:
    """Full name→Type map for a generated table (export path): explicit
    types from _TYPES, VARCHAR for dictionary/object columns, BIGINT rest."""
    explicit = _TYPES.get(table, {})
    out = {}
    for col, v in data.items():
        if col in explicit:
            out[col] = explicit[col]
        elif isinstance(v, tuple) or (
            isinstance(v, np.ndarray) and v.dtype == object
        ):
            out[col] = VARCHAR
        else:
            out[col] = BIGINT
    return out


class TpchConnector(MemoryConnector):
    """Lazy TPC-H connector: tables generate on first access and are cached.

    Reference: presto-tpch TpchConnectorFactory (data generated in-process,
    deterministically, per scale factor)."""

    def __init__(self, sf: float = 1.0, name: str = "tpch"):
        super().__init__(name)
        self.sf = sf
        self.gen = TpchGenerator(sf)

    def table_names(self) -> List[str]:
        return ["region", "nation", "supplier", "customer", "part",
                "partsupp", "orders", "lineitem"]

    def _ensure(self, name: str):
        if name in self.tables:
            return
        if name in ("orders", "lineitem"):
            orders, lineitem = self.gen.orders_and_lineitem()
            self._add("orders", orders)
            self._add("lineitem", lineitem)
        elif name in ("region", "nation", "supplier", "customer", "part", "partsupp"):
            self._add(name, getattr(self.gen, name)())
        else:
            raise KeyError(f"table not found: {name}")

    def _add(self, name: str, data: Dict[str, np.ndarray]):
        types = dict(_TYPES.get(name, {}))
        converted = {}
        for col, arr in data.items():
            ct = types.get(col)
            # pre-scaled decimal columns must not be rescaled by MemoryTable
            if (ct is not None and isinstance(ct, DecimalType)
                    and (name, col) in _PRESCALED):
                converted[col] = ("raw_decimal", ct, arr)
            else:
                converted[col] = arr
        self.add_generated(
            name, converted,
            types={c: t for c, t in types.items()
                   if (name, c) not in _PRESCALED},
            primary_key=_PRIMARY_KEYS.get(name),
        )

    def get_table(self, name: str):
        self._ensure(name)
        return super().get_table(name)

    def read_split(self, split, columns, device, capacity=None):
        self._ensure(split.table)
        return super().read_split(split, columns, device, capacity)


def tpch_catalog(sf: float = 1.0):
    from presto_tpu_torch.connector import Catalog

    cat = Catalog()
    cat.register("tpch", TpchConnector(sf), default=True)
    return cat
