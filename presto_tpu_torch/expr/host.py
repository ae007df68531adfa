"""Host-side expression helpers: the parts of expression lowering that
run on the host at plan time (string-function Python kernels, literal
parsing, calendar math). No device code lives here; the planner imports
it.
"""

from __future__ import annotations

import re

import numpy as np

from presto_tpu_torch.expr.ir import Call, Constant
from presto_tpu_torch.types import BOOLEAN, DecimalType, is_floating

# string→string functions evaluated host-side over the dictionary
# (reference: operator/scalar/StringFunctions.java — but O(|dict|) instead of
# O(rows), then one device gather)
# HyperLogLog register count (2^12 → ~1.6% standard error; the reference's
# approx_distinct default standard error is 2.3% at p=11)
HLL_M = 4096

_STR_TO_STR = {
    "substr", "upper", "lower", "trim", "ltrim", "rtrim", "replace",
    "reverse", "lpad", "rpad", "concat", "split_part",
    "regexp_extract", "regexp_replace", "json_extract_scalar",
    # URL / hash / encoding family (operator/scalar/UrlFunctions,
    # VarbinaryFunctions over utf-8 text) — host dictionary transforms
    "url_extract_host", "url_extract_path", "url_extract_query",
    "url_extract_protocol", "url_extract_fragment", "url_encode",
    "url_decode", "md5", "sha1", "sha256", "sha512", "to_base64",
    "from_base64", "normalize",
    # JSON family (operator/scalar/JsonFunctions.java): JSON values are
    # VARCHAR text; every function evaluates ONCE per dictionary entry
    "json_extract", "json_array_get", "json_format", "json_parse",
    # VARBINARY family (VarbinaryFunctions.java): bytes ride the latin-1
    # bijection (types.VarbinaryType), so these are dictionary transforms
    "to_hex", "from_hex", "to_utf8", "from_utf8",
    "__vb_md5", "__vb_sha1", "__vb_sha256", "__vb_sha512", "__vb_to_base64",
    # IPADDRESS/IPPREFIX family (expr/ip.py): canonical-byte dictionary
    # entries, so casts and prefix math are dictionary transforms too
    "__to_ipaddress", "__vb_to_ipaddress", "__ip_to_varchar",
    "__ip_to_bytes", "__to_ipprefix", "__ipprefix_to_varchar",
    "__addr_to_ipprefix", "__ipprefix_to_addr",
    "ip_prefix", "ip_subnet_min", "ip_subnet_max",
    # TDIGEST entries (expr/tdigest.py)
    "scale_tdigest",
}
# string→double functions over dictionary entries (float lut + null lut):
# the TDIGEST scalar family (expr/tdigest.py)
_STR_TO_FLOAT = {"value_at_quantile", "quantile_at_value", "trimmed_mean"}
# string→int functions (code-indexed int lut)
_STR_TO_INT = {"length", "strpos", "codepoint", "json_array_length",
               "json_size", "levenshtein_distance_c", "hamming_distance_c",
               "__hll_cardinality", "bit_length", "__vb_bit_length",
               "date_parse", "from_iso8601_date", "from_iso8601_timestamp"}
# int functions whose python fn may return None = SQL NULL (absent json
# path / non-array input) — carried via a parallel null lut
_STR_INT_NULLABLE = {"json_array_length", "json_size", "__hll_cardinality",
                     "date_parse", "from_iso8601_date",
                     "from_iso8601_timestamp"}

# MySQL date format specifiers → strptime (DateTimeFunctions.java's
# date_parse uses the MySQL vocabulary, not JodaTime's)
_MYSQL_FMT = {"Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d",
              "e": "%d", "H": "%H", "k": "%H", "h": "%I", "I": "%I",
              "l": "%I", "i": "%M", "s": "%S", "S": "%S", "f": "%f",
              "p": "%p", "M": "%B", "b": "%b", "a": "%a", "W": "%A",
              "j": "%j", "T": "%H:%M:%S", "r": "%I:%M:%S %p", "%": "%%"}


def mysql_format_to_strptime(fmt: str) -> str:
    """Translate a MySQL date format to strptime; unsupported specifiers
    raise ValueError (the builder surfaces it as an AnalysisError)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%":
            if i + 1 >= len(fmt):
                raise ValueError("trailing % in date format")
            spec = fmt[i + 1]
            if spec not in _MYSQL_FMT:
                raise ValueError(f"unsupported date format specifier %{spec}")
            out.append(_MYSQL_FMT[spec])
            i += 2
        else:
            # strptime treats bare % as special; everything else literal
            out.append(ch)
            i += 1
    return "".join(out)
# string→bool predicate functions (bool lut, like LIKE)
_STR_PRED = {"regexp_like", "starts_with", "ends_with", "contains",
             "json_array_contains", "is_json_scalar",
             "__is_subnet_of_c", "__prefix_contains_c"}


def _sql_substr(s: str, start: int, length: int | None) -> str:
    # SQL substr: 1-based; negative start counts from the end (Presto
    # StringFunctions.substr semantics)
    n = len(s)
    if start == 0:
        return ""
    if start > 0:
        i = start - 1
    else:
        i = n + start
        if i < 0:
            return ""
    if i >= n:
        return ""
    if length is None:
        return s[i:]
    if length <= 0:
        return ""
    return s[i : i + length]


def _str_xform_pyfn(fn: str, cargs: tuple):
    """Host python fn(str)->str for a string transform with constant args."""
    if fn == "substr":
        start = int(cargs[0])
        length = int(cargs[1]) if len(cargs) > 1 and cargs[1] is not None else None
        return lambda s: _sql_substr(s, start, length)
    if fn == "upper":
        return str.upper
    if fn == "lower":
        return str.lower
    if fn in ("url_extract_host", "url_extract_path", "url_extract_query",
              "url_extract_protocol", "url_extract_fragment"):
        from urllib.parse import urlparse

        attr = fn[len("url_extract_"):]
        attr = {"host": "hostname", "protocol": "scheme"}.get(attr, attr)

        def url_part(s, attr=attr):
            try:
                v = getattr(urlparse(s), attr)
            except ValueError:
                return None
            return v if v else None

        return url_part
    if fn == "url_encode":
        from urllib.parse import quote_plus

        return lambda s: quote_plus(s)
    if fn == "url_decode":
        from urllib.parse import unquote_plus

        return lambda s: unquote_plus(s)
    if fn in ("md5", "sha1", "sha256", "sha512"):
        import hashlib as _hl

        algo = fn

        def digest(s, algo=algo):
            return getattr(_hl, algo)(s.encode()).hexdigest()

        return digest
    if fn in ("__vb_md5", "__vb_sha1", "__vb_sha256", "__vb_sha512"):
        import hashlib as _hl

        algo = fn[5:]

        def vb_digest(s, algo=algo):
            raw = getattr(_hl, algo)(s.encode("latin-1")).digest()
            return raw.decode("latin-1")

        return vb_digest
    if fn == "__vb_to_base64":
        import base64 as _b64

        return lambda s: _b64.b64encode(s.encode("latin-1")).decode("ascii")
    if fn == "to_hex":
        return lambda s: s.encode("latin-1").hex().upper()
    if fn == "from_hex":
        def fh(s):
            try:
                return bytes.fromhex(s).decode("latin-1")
            except ValueError:
                return None
        return fh
    if fn == "to_utf8":
        return lambda s: s.encode("utf-8").decode("latin-1")
    if fn == "from_utf8":
        # invalid byte sequences replaced (FromUtf8Function's default)
        return lambda s: s.encode("latin-1").decode("utf-8", "replace")
    if fn == "to_base64":
        import base64 as _b64

        return lambda s: _b64.b64encode(s.encode()).decode()
    if fn == "from_base64":
        import base64 as _b64

        def fb64(s):
            try:
                return _b64.b64decode(s).decode("utf-8", "replace")
            except Exception:
                return None

        return fb64
    if fn == "normalize":
        import unicodedata as _ud

        return lambda s: _ud.normalize("NFC", s)
    if fn in ("__to_ipaddress", "__vb_to_ipaddress", "__ip_to_varchar",
              "__to_ipprefix", "__ipprefix_to_varchar", "__ip_to_bytes",
              "__addr_to_ipprefix", "__ipprefix_to_addr",
              "ip_prefix", "ip_subnet_min", "ip_subnet_max"):
        from presto_tpu_torch.expr import ip as _ip

        if fn == "ip_prefix":
            bits = int(cargs[0])
            return lambda s, _b=bits: _ip.ip_prefix(s, _b)
        if fn == "__addr_to_ipprefix":
            # full-length prefix: /32 for v4-mapped entries, /128 for v6
            def full_pfx(s):
                b = s.encode("latin-1")
                if len(b) != 16:
                    return None
                v4 = b[:12] == bytes(10) + b"\xff\xff"
                return _ip.ip_prefix(s, 32 if v4 else 128)

            return full_pfx
        if fn == "__ipprefix_to_addr":
            return lambda s: s[:16] if len(s) == 17 else None
        if fn == "__ip_to_bytes":
            return lambda s: s  # entries ARE the 16 bytes (latin-1)
        return {"__to_ipaddress": _ip.parse_address,
                "__vb_to_ipaddress": _ip.address_from_bytes,
                "__ip_to_varchar": _ip.format_address,
                "__to_ipprefix": _ip.parse_prefix,
                "__ipprefix_to_varchar": _ip.format_prefix,
                "ip_subnet_min": _ip.subnet_min,
                "ip_subnet_max": _ip.subnet_max}[fn]
    if fn == "scale_tdigest":
        from presto_tpu_torch.expr import tdigest as _td

        factor = float(cargs[0])
        return lambda s, _f=factor: _td.scale(s, _f)
    if fn == "trim":
        return str.strip
    if fn == "ltrim":
        return str.lstrip
    if fn == "rtrim":
        return str.rstrip
    if fn == "reverse":
        return lambda s: s[::-1]
    if fn == "replace":
        old = str(cargs[0])
        new = str(cargs[1]) if len(cargs) > 1 else ""
        return lambda s: s.replace(old, new)
    if fn == "lpad":
        n, fill = int(cargs[0]), str(cargs[1]) if len(cargs) > 1 else " "
        def lpad(s, n=n, fill=fill):
            if len(s) >= n:
                return s[:n]
            pad = (fill * n)[: n - len(s)]
            return pad + s
        return lpad
    if fn == "rpad":
        n, fill = int(cargs[0]), str(cargs[1]) if len(cargs) > 1 else " "
        def rpad(s, n=n, fill=fill):
            if len(s) >= n:
                return s[:n]
            return s + (fill * n)[: n - len(s)]
        return rpad
    if fn == "concat":
        pre, post = str(cargs[0]), str(cargs[1])
        return lambda s: pre + s + post
    if fn == "split_part":
        delim, idx = str(cargs[0]), int(cargs[1])
        def split_part(s, delim=delim, idx=idx):
            parts = s.split(delim)
            return parts[idx - 1] if 0 < idx <= len(parts) else ""
        return split_part
    if fn == "regexp_extract":
        rx = re.compile(str(cargs[0]))
        group = int(cargs[1]) if len(cargs) > 1 and cargs[1] is not None else 0
        def rex(s, rx=rx, group=group):
            m = rx.search(s)
            # Presto returns NULL on no match (and for an unmatched group)
            return m.group(group) if m else None
        return rex
    if fn == "regexp_replace":
        rx = re.compile(str(cargs[0]))
        repl = str(cargs[1]) if len(cargs) > 1 else ""
        # Presto uses $1 for backrefs; python re uses \1
        repl = re.sub(r"\$(\d+)", r"\\\1", repl)
        return lambda s: rx.sub(repl, s)
    if fn == "json_extract_scalar":
        import json as _json

        path = str(cargs[0])
        steps = _parse_json_path(path)
        def jes(s, steps=steps):
            try:
                v = _json.loads(s)
                for st in steps:
                    v = v[st]
            except Exception:
                return None
            if isinstance(v, (dict, list)) or v is None:
                return None  # non-scalar / absent → SQL NULL
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        return jes
    if fn in ("json_extract", "json_array_get"):
        import json as _json

        steps = ([int(cargs[0])] if fn == "json_array_get"
                 else _parse_json_path(str(cargs[0])))

        def jex(s, steps=steps):
            try:
                v = _json.loads(s)
                for st in steps:
                    v = v[st]
            except Exception:
                return None
            return _json.dumps(v, separators=(",", ":"))
        return jex
    if fn == "json_format":
        import json as _json

        def jfmt(s):
            try:
                return _json.dumps(_json.loads(s), separators=(",", ":"))
            except Exception:
                return None
        return jfmt
    if fn == "json_parse":
        import json as _json

        def jp(s):
            try:
                _json.loads(s)
                return s  # JSON is VARCHAR text here; parse = validate
            except Exception:
                # documented deviation: the reference RAISES on malformed
                # input, but dictionary-wide evaluation visits entries
                # that may belong to filtered-out rows — NULL instead
                return None
        return jp
    raise NotImplementedError(fn)


def _parse_json_path(path: str):
    """Subset of JSONPath used by json_extract_scalar: $.a.b[0]['c']."""
    steps = []
    i = 0
    if path.startswith("$"):
        i = 1
    while i < len(path):
        ch = path[i]
        if ch == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            steps.append(path[i + 1:j])
            i = j
        elif ch == "[":
            j = path.index("]", i)
            inner = path[i + 1:j].strip()
            if inner[:1] in ("'", '"'):
                steps.append(inner[1:-1])
            else:
                steps.append(int(inner))
            i = j + 1
        else:
            raise ValueError(f"bad json path: {path}")
    return steps


def _str_int_pyfn(fn: str, cargs: tuple):
    if fn == "length":
        return len
    if fn == "strpos":
        sub = str(cargs[0])
        return lambda s: s.find(sub) + 1
    if fn == "codepoint":
        return lambda s: ord(s[0]) if s else 0
    if fn == "json_array_length":
        import json as _json

        def jal(s):
            try:
                v = _json.loads(s)
            except Exception:
                return None
            return len(v) if isinstance(v, list) else None  # NULL
        return jal
    if fn == "json_size":
        import json as _json

        steps = _parse_json_path(str(cargs[0]))

        def jsz(s, steps=steps):
            try:
                v = _json.loads(s)
                for st in steps:
                    v = v[st]
            except Exception:
                return None  # absent path → NULL
            return len(v) if isinstance(v, (dict, list)) else 0
        return jsz
    if fn == "__hll_cardinality":
        from presto_tpu_torch.expr.hll import cardinality as _hll_card

        return _hll_card
    if fn == "bit_length":
        return lambda s: 8 * len(s.encode("utf-8"))
    if fn == "__vb_bit_length":
        return lambda s: 8 * len(s)  # latin-1 bijection: 1 char = 1 byte
    if fn == "date_parse":
        from datetime import datetime as _dt

        raw_fmt = str(cargs[0])
        pyfmt = mysql_format_to_strptime(raw_fmt)
        # strptime defaults missing fields to 1900-01-01; the reference
        # defaults to the 1970 epoch — patch the year when the format
        # carries no year directive (month/day already default to 1)
        has_year = any(f"%{c}" in raw_fmt for c in "Yy")
        epoch = _dt(1970, 1, 1)

        def dparse(s, _fmt=pyfmt, _ep=epoch, _hy=has_year):
            try:
                dt = _dt.strptime(s, _fmt)
            except ValueError:
                return None  # unparseable → NULL (documented deviation)
            if not _hy:
                dt = dt.replace(year=1970)
            td = dt - _ep
            return (td.days * 86_400_000_000 + td.seconds * 1_000_000
                    + td.microseconds)

        return dparse
    if fn == "from_iso8601_date":
        import datetime as _d

        def iso_date(s):
            try:
                return _d.date.fromisoformat(s.strip()).toordinal() - 719163
            except ValueError:
                return None

        return iso_date
    if fn == "from_iso8601_timestamp":
        import datetime as _d

        def iso_ts(s):
            try:
                dt = _d.datetime.fromisoformat(s.strip().replace("Z", "+00:00"))
            except ValueError:
                return None
            if dt.tzinfo is not None:
                dt = dt.astimezone(_d.timezone.utc).replace(tzinfo=None)
            td = dt - _d.datetime(1970, 1, 1)
            return (td.days * 86_400_000_000 + td.seconds * 1_000_000
                    + td.microseconds)

        return iso_ts
    if fn == "levenshtein_distance_c":
        other = str(cargs[0])

        def lev(s, other=other):
            if len(s) < len(other):
                s, other = other, s
            prev = list(range(len(other) + 1))
            for i, ca in enumerate(s):
                cur = [i + 1]
                for j, cb in enumerate(other):
                    cur.append(min(prev[j + 1] + 1, cur[j] + 1,
                                   prev[j] + (ca != cb)))
                prev = cur
            return prev[-1]
        return lev
    if fn == "hamming_distance_c":
        other = str(cargs[0])
        return lambda s: sum(a != b for a, b in zip(s, other)) if len(s) == len(other) else -1
    raise NotImplementedError(fn)


def _str_float_pyfn(fn: str, cargs: tuple):
    """TDIGEST scalar family: digest entry → double (None = SQL NULL)."""
    from presto_tpu_torch.expr import tdigest as _td

    if fn == "value_at_quantile":
        q = float(cargs[0])
        return lambda s, _q=q: _td.value_at_quantile(s, _q)
    if fn == "quantile_at_value":
        v = float(cargs[0])
        return lambda s, _v=v: _td.quantile_at_value(s, _v)
    lo, hi = float(cargs[0]), float(cargs[1])
    return lambda s, _lo=lo, _hi=hi: _td.trimmed_mean(s, _lo, _hi)


def _str_pred_pyfn(fn: str, cargs: tuple):
    if fn == "regexp_like":
        rx = re.compile(str(cargs[0]))
        return lambda s: rx.search(s) is not None
    if fn == "starts_with":
        p = str(cargs[0])
        return lambda s: s.startswith(p)
    if fn == "ends_with":
        p = str(cargs[0])
        return lambda s: s.endswith(p)
    if fn == "contains":
        p = str(cargs[0])
        return lambda s: p in s
    if fn == "json_array_contains":
        import json as _json

        want = cargs[0]

        def jac(s, want=want):
            try:
                v = _json.loads(s)
            except Exception:
                return False
            if not isinstance(v, list):
                return False
            for e in v:
                if isinstance(e, bool) or isinstance(want, bool):
                    if e is want:
                        return True
                elif isinstance(e, str) and isinstance(want, str):
                    if e == want:
                        return True
                elif isinstance(e, (int, float)) and isinstance(
                        want, (int, float)):
                    if float(e) == float(want):
                        return True
            return False
        return jac
    if fn == "__is_subnet_of_c":
        # is_subnet_of(<constant prefix>, column): cargs[0] is the
        # canonical 17-byte prefix entry (builder folds the text form)
        from presto_tpu_torch.expr import ip as _ip

        pfx = str(cargs[0])
        return lambda s, _p=pfx: _ip.is_subnet_of(_p, s)
    if fn == "__prefix_contains_c":
        # is_subnet_of(column, <constant address/prefix>): the operand is
        # the prefix column, the constant the contained value
        from presto_tpu_torch.expr import ip as _ip

        inner = str(cargs[0])
        return lambda s, _i=inner: _ip.is_subnet_of(s, _i)
    if fn == "is_json_scalar":
        import json as _json

        def ijs(s):
            try:
                return not isinstance(_json.loads(s), (dict, list))
            except Exception:
                return False
        return ijs
    raise NotImplementedError(fn)


def _xform_parts(e: Call):
    """Split a string-function call into (string_operand, const_args_key).
    For concat, the single non-constant operand with (prefix, suffix)."""
    if e.fn == "concat":
        pre, post, operand = [], [], None
        for a in e.args:
            if isinstance(a, Constant):
                (pre if operand is None else post).append(
                    None if a.value is None else str(a.value)
                )
            elif operand is None:
                operand = a
            else:
                raise NotImplementedError(
                    "concat of two non-constant strings (cross-product "
                    "dictionary) not supported"
                )
        if operand is None:
            raise NotImplementedError("all-constant concat should fold")
        if any(p is None for p in pre + post):
            return operand, None  # NULL operand poisons the whole concat
        return operand, ("".join(pre), "".join(post))
    consts = []
    for a in e.args[1:]:
        if not isinstance(a, Constant):
            raise NotImplementedError(
                f"{e.fn}: non-constant argument {a} not supported "
                "(dictionary transforms need plan-time constants)"
            )
        consts.append(a.value)
    return e.args[0], tuple(consts)


def regexp_split_pieces(pattern: str):
    """Splitter matching the reference: capture groups in the pattern
    must NOT leak into the result (Python re.split interleaves them at
    positions that are not multiples of groups+1)."""
    rx = re.compile(pattern)
    if not rx.groups:
        return rx.split
    step = rx.groups + 1
    return lambda s, _rx=rx, _st=step: _rx.split(s)[::_st]


def parse_string_to(tt, s: str):
    """SQL text → the internal value of type `tt`, or None when
    unparseable (shared by varchar-cast LUTs and constant folding)."""
    from presto_tpu_torch.types import DATE as _DATE

    def _time_micros(txt: str) -> int:
        hms, _, frac = txt.partition(".")
        parts = list(map(int, hms.split(":")))
        while len(parts) < 3:
            parts.append(0)
        hh, mm, ss = parts[:3]
        micros = (hh * 3600 + mm * 60 + ss) * 1_000_000
        if frac:
            micros += int(frac[:6].ljust(6, "0"))
        return micros

    try:
        s = s.strip()
        if tt is _DATE:
            y, m, dd = map(int, s.split("-"))
            return days_from_civil(y, m, dd)
        if tt.name == "timestamp":
            datepart, _, timepart = s.partition(" ")
            y, m, dd = map(int, datepart.split("-"))
            micros = days_from_civil(y, m, dd) * 86_400_000_000
            if timepart:
                micros += _time_micros(timepart)
            return micros
        if tt.name == "time":
            return _time_micros(s)
        if tt is BOOLEAN:
            if s.lower() in ("true", "t", "1"):
                return 1
            if s.lower() in ("false", "f", "0"):
                return 0
            return None
        if isinstance(tt, DecimalType):
            import decimal as _dec

            return int(_dec.Decimal(s).scaleb(tt.scale)
                       .to_integral_value(rounding=_dec.ROUND_HALF_UP))
        if is_floating(tt):
            return float(s)
        return int(float(s)) if "." in s or "e" in s.lower() else int(s)
    except Exception:
        return None



def _civil_from_days(z):
    """days-since-epoch → (year, month, day). Howard Hinnant's algorithm,
    branch-free integer math over numpy arrays or Python ints."""
    z = np.asarray(z, dtype=np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side date literal → days since epoch."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
