"""PEP 249 (DBAPI 2.0) driver over the statement protocol.

Reference: presto-jdbc (PrestoConnection / PrestoResultSet over the REST
protocol) — the same shape, for Python.

    import presto_tpu_torch.dbapi as dbapi
    conn = dbapi.connect("http://localhost:8080", user="alice")
    cur = conn.cursor()
    cur.execute("select * from tpch.nation")
    cur.fetchall()

The JAX package's dbapi.py over the port's statement client.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from presto_tpu_torch.client import ClientSession, QueryError, StatementClient

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


class Error(Exception):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


class Connection:
    def __init__(self, server: str, user: str = "user",
                 catalog: Optional[str] = None, schema: Optional[str] = None,
                 timeout_s: float = 60.0):
        self.server = server
        self.session = ClientSession(user=user, catalog=catalog, schema=schema)
        self.timeout_s = timeout_s
        self._closed = False

    def cursor(self) -> "Cursor":
        if self._closed:
            raise ProgrammingError("connection is closed")
        return Cursor(self)

    def close(self):
        self._closed = True

    def commit(self):
        pass  # autocommit (read path)

    def rollback(self):
        raise DatabaseError("transactions not supported")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _quote_param(p: Any) -> str:
    if p is None:
        return "NULL"
    if isinstance(p, bool):
        return "TRUE" if p else "FALSE"
    if isinstance(p, (int, float)):
        return repr(p)
    s = str(p).replace("'", "''")
    return f"'{s}'"


def _substitute_params(sql: str, params: Sequence) -> str:
    """Replace `?` placeholders left-to-right, skipping string literals —
    a `?` inside quotes (or inside a substituted value) is never touched."""
    out = []
    it = iter(params)
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    j += 2  # escaped quote
                elif sql[j] == "'":
                    j += 1
                    break
                else:
                    j += 1
            out.append(sql[i:j])
            i = j
        elif ch == "?":
            try:
                out.append(_quote_param(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters for placeholders")
            i += 1
        else:
            out.append(ch)
            i += 1
    leftover = list(it)
    if leftover:
        raise ProgrammingError(f"{len(leftover)} unused parameter(s)")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, connection: Connection):
        self.connection = connection
        self._client: Optional[StatementClient] = None
        self._rows_iter = None
        self.rowcount = -1

    @property
    def description(self):
        if self._client is None or self._client.columns is None:
            return None
        return [
            (c["name"], c["type"], None, None, None, None, None)
            for c in self._client.columns
        ]

    def execute(self, operation: str, parameters: Optional[Sequence] = None):
        if parameters:
            operation = _substitute_params(operation, parameters)
        try:
            self._client = StatementClient(
                self.connection.server, operation, self.connection.session,
                timeout_s=self.connection.timeout_s)
            self._rows_iter = self._client.rows()
        except QueryError as e:
            raise DatabaseError(str(e)) from e
        return self

    def executemany(self, operation: str, seq_of_parameters):
        for params in seq_of_parameters:
            self.execute(operation, params)
        return self

    def fetchone(self) -> Optional[tuple]:
        if self._rows_iter is None:
            raise ProgrammingError("no query executed")
        try:
            return tuple(next(self._rows_iter))
        except StopIteration:
            return None
        except QueryError as e:
            raise DatabaseError(str(e)) from e

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        size = size or self.arraysize
        out = []
        for _ in range(size):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self) -> List[tuple]:
        out = []
        while True:
            row = self.fetchone()
            if row is None:
                return out
            out.append(row)

    def cancel(self):
        if self._client is not None:
            self._client.cancel()

    def close(self):
        self._client = None
        self._rows_iter = None

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row


def connect(server: str, user: str = "user", catalog: Optional[str] = None,
            schema: Optional[str] = None, timeout_s: float = 60.0
            ) -> Connection:
    return Connection(server, user=user, catalog=catalog, schema=schema,
                      timeout_s=timeout_s)
