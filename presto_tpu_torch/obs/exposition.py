"""Prometheus text-exposition validator.

Lints the /v1/metrics documents this engine renders (and anything else in
text format 0.0.4): HELP/TYPE declared at most once per family and before
samples, sample names consistent with the declared type (histogram series
must be `_bucket`/`_sum`/`_count`), label syntax with proper escaping,
`le` bucket bounds sorted with cumulative counts monotone, `+Inf` bucket
present and equal to `_count`.

Usable as a library (`lint_exposition(text) -> [errors]`) and as a CLI for
CI smoke steps: `python -m presto_tpu_torch.obs.exposition [file]` (stdin when no
file) exits 1 and prints one error per line when the document is invalid.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_labels(s: str) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """Parse `a="b",c="d\\""` respecting \\\\, \\", \\n escapes. Returns
    (labels, error)."""
    labels: Dict[str, str] = {}
    i = 0
    n = len(s)
    while i < n:
        m = re.match(r"[a-zA-Z_][a-zA-Z0-9_]*", s[i:])
        if not m:
            return None, f"bad label name at ...{s[i:i+20]!r}"
        name = m.group(0)
        i += len(name)
        if i >= n or s[i] != "=":
            return None, f"expected '=' after label {name!r}"
        i += 1
        if i >= n or s[i] != '"':
            return None, f"label {name!r} value not quoted"
        i += 1
        val = []
        while i < n and s[i] != '"':
            if s[i] == "\\":
                if i + 1 >= n:
                    return None, f"dangling escape in label {name!r}"
                esc = s[i + 1]
                if esc not in ('"', "\\", "n"):
                    return None, (f"invalid escape \\{esc} in label "
                                  f"{name!r}")
                val.append("\n" if esc == "n" else esc)
                i += 2
            else:
                val.append(s[i])
                i += 1
        if i >= n:
            return None, f"unterminated label value for {name!r}"
        i += 1  # closing quote
        labels[name] = "".join(val)
        if i < n:
            if s[i] != ",":
                return None, f"expected ',' between labels at ...{s[i:]!r}"
            i += 1
    return labels, None


def _split_sample(line: str):
    """'name{labels} value' | 'name value' -> (name, labelstr, value)."""
    if "{" in line:
        m = re.match(r"^(\S+?)\{(.*)\}\s+(\S+)(?:\s+-?\d+)?$", line)
        if not m:
            return None
        return m.group(1), m.group(2), m.group(3)
    m = re.match(r"^(\S+)\s+(\S+)(?:\s+-?\d+)?$", line)
    if not m:
        return None
    return m.group(1), "", m.group(2)


def _family_of(sample_name: str, histogram_families: set) -> str:
    for suf in _HISTOGRAM_SUFFIXES:
        if sample_name.endswith(suf) and sample_name[:-len(suf)] \
                in histogram_families:
            return sample_name[:-len(suf)]
    return sample_name


def lint_exposition(text: str) -> List[str]:
    errors: List[str] = []
    helps: set = set()
    types: Dict[str, str] = {}
    sampled: set = set()  # families with at least one sample seen
    # histogram series: (family, labels-minus-le) -> list of (le, value)
    hist_buckets: Dict[tuple, List[Tuple[float, float]]] = {}
    hist_counts: Dict[tuple, float] = {}
    hist_sums: set = set()

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(r"^# (HELP|TYPE) (\S+)(?: (.*))?$", line)
            if not m:
                if re.match(r"^# ?(HELP|TYPE)\b", line):
                    errors.append(f"line {lineno}: malformed comment: {line}")
                continue  # plain comment
            kind, fam = m.group(1), m.group(2)
            if not _NAME_RE.match(fam):
                errors.append(f"line {lineno}: invalid metric name {fam!r}")
                continue
            if kind == "HELP":
                if fam in helps:
                    errors.append(
                        f"line {lineno}: duplicate HELP for family {fam}")
                helps.add(fam)
            else:
                if fam in types:
                    errors.append(
                        f"line {lineno}: duplicate TYPE for family {fam}")
                if fam in sampled:
                    errors.append(
                        f"line {lineno}: TYPE for {fam} after its samples")
                t = (m.group(3) or "").strip()
                if t not in _VALID_TYPES:
                    errors.append(
                        f"line {lineno}: invalid type {t!r} for {fam}")
                types[fam] = t
            continue
        parsed = _split_sample(line)
        if parsed is None:
            errors.append(f"line {lineno}: unparseable sample: {line}")
            continue
        name, labelstr, value = parsed
        if not _NAME_RE.match(name):
            errors.append(f"line {lineno}: invalid sample name {name!r}")
            continue
        labels: Dict[str, str] = {}
        if labelstr:
            labels, err = _parse_labels(labelstr)
            if err:
                errors.append(f"line {lineno}: {err}")
                continue
        for ln in labels:
            if not _LABEL_NAME_RE.match(ln):
                errors.append(f"line {lineno}: invalid label name {ln!r}")
        try:
            fval = float(value)
        except ValueError:
            if value not in ("+Inf", "-Inf", "NaN"):
                errors.append(
                    f"line {lineno}: non-numeric value {value!r}")
                continue
            fval = float(value.replace("Inf", "inf"))
        histogram_families = {f for f, t in types.items() if t == "histogram"}
        fam = _family_of(name, histogram_families)
        if fam not in types:
            errors.append(
                f"line {lineno}: sample {name} has no # TYPE declaration")
            sampled.add(fam)
            continue
        sampled.add(fam)
        ftype = types[fam]
        if ftype == "histogram":
            if name == fam + "_bucket":
                if "le" not in labels:
                    errors.append(
                        f"line {lineno}: histogram bucket without le label")
                    continue
                le = labels["le"]
                lef = float("inf") if le == "+Inf" else None
                if lef is None:
                    try:
                        lef = float(le)
                    except ValueError:
                        errors.append(
                            f"line {lineno}: unparseable le bound {le!r}")
                        continue
                key = (fam, tuple(sorted((k, v) for k, v in labels.items()
                                         if k != "le")))
                hist_buckets.setdefault(key, []).append((lef, fval))
            elif name == fam + "_count":
                key = (fam, tuple(sorted(labels.items())))
                hist_counts[key] = fval
            elif name == fam + "_sum":
                hist_sums.add((fam, tuple(sorted(labels.items()))))
            else:
                errors.append(
                    f"line {lineno}: sample {name} invalid for histogram "
                    f"family {fam}")
        else:
            if name != fam:
                errors.append(
                    f"line {lineno}: sample {name} does not match declared "
                    f"family {fam} of type {ftype}")

    for fam in sampled:
        if fam not in helps:
            errors.append(f"family {fam}: missing # HELP")
    for (fam, lkey), buckets in hist_buckets.items():
        series = f"{fam}{{{','.join(f'{k}={v}' for k, v in lkey)}}}"
        in_order = sorted(buckets, key=lambda b: b[0])
        if [b[0] for b in buckets] != [b[0] for b in in_order]:
            errors.append(f"{series}: le bounds not sorted ascending")
        counts = [b[1] for b in in_order]
        if any(counts[i] > counts[i + 1] for i in range(len(counts) - 1)):
            errors.append(f"{series}: bucket counts not monotone "
                          f"non-decreasing")
        if not in_order or in_order[-1][0] != float("inf"):
            errors.append(f"{series}: missing le=\"+Inf\" bucket")
        else:
            cnt = hist_counts.get((fam, lkey))
            if cnt is None:
                errors.append(f"{series}: missing _count sample")
            elif cnt != in_order[-1][1]:
                errors.append(
                    f"{series}: _count {cnt} != +Inf bucket "
                    f"{in_order[-1][1]}")
        if (fam, lkey) not in hist_sums:
            errors.append(f"{series}: missing _sum sample")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as fh:
            text = fh.read()
    else:
        text = sys.stdin.read()
    errors = lint_exposition(text)
    for e in errors:
        print(e, file=sys.stderr)
    if not errors:
        print("exposition OK "
              f"({len([l for l in text.splitlines() if l and not l.startswith('#')])} samples)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
