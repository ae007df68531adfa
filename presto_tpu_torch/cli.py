"""Interactive SQL console over the statement protocol.

Reference: presto-cli (Console.java, StatusPrinter, aligned table output).

    python -m presto_tpu_torch.cli --server http://localhost:8080
    python -m presto_tpu_torch.cli --server ... --execute "select 1"

The JAX package's cli.py over the port's statement client: the same
table output and statement splitting.
"""

from __future__ import annotations

import argparse
import sys
import time

from presto_tpu_torch.client import ClientSession, QueryError, StatementClient


def format_table(columns, rows, max_width: int = 40) -> str:
    """ASCII-aligned output (AlignedTablePrinter analog)."""
    if not columns:
        return "(no columns)"

    def cell(v):
        s = "NULL" if v is None else str(v)
        return s if len(s) <= max_width else s[: max_width - 1] + "…"

    table = [[cell(v) for v in row] for row in rows]
    widths = [len(c) for c in columns]
    for row in table:
        for i, s in enumerate(row):
            widths[i] = max(widths[i], len(s))
    sep = "-+-".join("-" * w for w in widths)
    head = " | ".join(c.ljust(w) for c, w in zip(columns, widths))
    lines = [head, sep]
    for row in table:
        lines.append(" | ".join(s.ljust(w) for s, w in zip(row, widths)))
    return "\n".join(lines)


def _progress_printer(client, stop, interval_s: float = 0.5):
    """StatusPrinter analog: redraw one live status line from the server's
    lifecycle progress estimate while the main thread drains rows."""
    drew = False
    while not stop.wait(interval_s):
        doc = client.progress()
        if not doc:
            continue
        frac = doc.get("fraction") or 0.0
        filled = int(max(0.0, min(1.0, frac)) * 20)
        bar = "=" * filled + " " * (20 - filled)
        sys.stderr.write(
            f"\r[{bar}] {frac * 100.0:5.1f}%  {doc.get('state', '')}"
            f"  rows={doc.get('rows', 0)}  ({doc.get('provenance', '')})  ")
        sys.stderr.flush()
        drew = True
    if drew:
        sys.stderr.write("\r" + " " * 70 + "\r")
        sys.stderr.flush()


def run_statement(server: str, sql: str, session: ClientSession,
                  out=None, progress: bool = False) -> bool:
    import threading

    out = out or sys.stdout
    t0 = time.perf_counter()
    stop = threading.Event()
    printer = None
    try:
        client = StatementClient(server, sql, session)
        if progress and client.progress_uri:
            printer = threading.Thread(
                target=_progress_printer, args=(client, stop), daemon=True)
            printer.start()
        rows = list(client.rows())
    except QueryError as e:
        print(f"Query failed: {e}", file=sys.stderr)
        return False
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return False
    finally:
        stop.set()
        if printer is not None:
            printer.join(timeout=2)
    cols = [c["name"] for c in (client.columns or [])]
    if cols:
        print(format_table(cols, rows), file=out)
    n = len(rows)
    dt = time.perf_counter() - t0
    print(f"({n} row{'s' if n != 1 else ''}, {dt:.2f}s)", file=out)
    return True


def split_statements(text: str):
    """Split a script on ';' outside string literals."""
    stmts, buf = [], []
    in_str = False
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if in_str:
            buf.append(ch)
            if ch == "'":
                if i + 1 < n and text[i + 1] == "'":
                    buf.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            buf.append(ch)
        elif ch == ";":
            stmts.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
        i += 1
    stmts.append("".join(buf).strip())
    return [s for s in stmts if s]


def repl(server: str, session: ClientSession, progress: bool = False):
    print(f"presto-tpu CLI — connected to {server}")
    print("Type a SQL statement ending with ';', or 'quit'.")
    buf = []
    while True:
        try:
            prompt = "presto> " if not buf else "     -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if not buf and line.strip().lower() in ("quit", "exit", r"\q"):
            return
        buf.append(line)
        text = "\n".join(buf)
        if text.rstrip().endswith(";"):
            buf = []
            sql = text.rstrip().rstrip(";").strip()
            if sql:
                run_statement(server, sql, session, progress=progress)


def main(argv=None):
    p = argparse.ArgumentParser(prog="presto-tpu")
    p.add_argument("--server", default="http://127.0.0.1:8080")
    p.add_argument("--user", default="user")
    p.add_argument("--catalog")
    p.add_argument("--schema")
    p.add_argument("--execute", "-e", help="run one statement and exit")
    p.add_argument("--file", "-f", help="run statements from a file (';'-separated)")
    p.add_argument("--progress", action="store_true",
                   help="show a live progress bar from the server's "
                        "lifecycle estimate (requires session lifecycle=on)")
    args = p.parse_args(argv)
    session = ClientSession(user=args.user, catalog=args.catalog,
                            schema=args.schema)
    if args.execute:
        ok = run_statement(args.server, args.execute, session,
                           progress=args.progress)
        return 0 if ok else 1
    if args.file:
        with open(args.file) as f:
            text = f.read()
        for stmt in split_statements(text):
            if not run_statement(args.server, stmt, session,
                                 progress=args.progress):
                return 1
        return 0
    repl(args.server, session, progress=args.progress)
    return 0


if __name__ == "__main__":
    sys.exit(main())
