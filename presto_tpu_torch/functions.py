"""Extensible function registry — user/plugin scalar + aggregate functions.

Reference: presto-main metadata/FunctionManager.java:82 (function
resolution consults registered namespaces), :158 (addFunctions — the
registration path used by plugins via Plugin.getFunctions), and the
FunctionNamespaceManager SPI. The reference resolves signatures over a
global registry built at plugin-load time; connectors and users cannot
work without it being open.

TPU-native shape: a registered scalar supplies a *lowering* — an
elementwise jnp function traced straight into the same fused XLA program
as built-in expressions (no interpreter, no row loop; the analog of the
reference's @ScalarFunction methods being compiled into bytecode).
A registered aggregate supplies its decomposable state layout — each
state is one of the kernel merge ops (sum/min/max/count_add) over an
elementwise input transform — plus an elementwise finalizer, exactly the
contract of the built-in variance/covariance family, so UDAFs ride the
same grouped_merge kernel, spill machinery, and partial/final split.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from presto_tpu_torch.types import BIGINT, DOUBLE, Type


@dataclasses.dataclass(frozen=True)
class ScalarFunction:
    """One registered scalar function.

    lower(values) receives one jnp array per argument (numeric args are
    coerced to float64 when coerce_double is set) and returns the result
    array. NULLs propagate automatically (validity = AND of argument
    validities); a function needing custom NULL semantics sets
    null_propagating=False and lower returns (values, validity).
    """

    name: str
    return_type: Union[Type, Callable[[Sequence[Type]], Type]]
    lower: Callable
    arity: Optional[int] = None
    coerce_double: bool = False
    null_propagating: bool = True
    description: str = ""

    def result_type(self, arg_types: Sequence[Type]) -> Type:
        if callable(self.return_type):
            return self.return_type(list(arg_types))
        return self.return_type


@dataclasses.dataclass(frozen=True)
class AggregateFunction:
    """One registered decomposable aggregate.

    states: [(suffix, merge_op, transform)] — suffix names the state
    column (must start with '$' and be unique per function; it travels
    through exchanges like '$sum'/'$cnt' do for avg). merge_op is one of
    'sum' | 'min' | 'max' | 'count_add'. transform(x) maps the float64
    argument array to that state's per-row contribution (None = identity;
    ignored for count_add, which contributes the argument's validity).

    finalize(states) receives {suffix: jnp array} over the group table and
    returns the output values array (elementwise). Output rows where no
    non-null input arrived are NULL automatically when a '$cnt'-style
    count_add state exists; otherwise the first state's validity is used.
    """

    name: str
    return_type: Union[Type, Callable[[Type], Type]]
    states: Tuple[Tuple[str, str, Optional[Callable]], ...]
    finalize: Callable
    description: str = ""

    def __post_init__(self):
        seen = set()
        for suffix, op, _ in self.states:
            if not suffix.startswith("$"):
                raise ValueError(
                    f"aggregate {self.name}: state suffix {suffix!r} must "
                    f"start with '$'")
            if suffix in seen:
                raise ValueError(
                    f"aggregate {self.name}: duplicate state {suffix!r}")
            seen.add(suffix)
            if op not in ("sum", "min", "max", "count_add"):
                raise ValueError(
                    f"aggregate {self.name}: unknown merge op {op!r}")

    def result_type(self, arg_type: Optional[Type]) -> Type:
        if callable(self.return_type):
            return self.return_type(arg_type)
        return self.return_type


class FunctionRegistry:
    """Name → function map consulted by the analyzer, the expression
    compiler, and the aggregation runtime (FunctionManager analog)."""

    def __init__(self):
        self._scalars: Dict[str, ScalarFunction] = {}
        self._aggregates: Dict[str, AggregateFunction] = {}
        self._lock = threading.Lock()

    # -- registration (FunctionManager.addFunctions) -----------------------

    def register_scalar(self, name: str, return_type, lower,
                        arity: Optional[int] = None,
                        coerce_double: bool = False,
                        null_propagating: bool = True,
                        description: str = "") -> ScalarFunction:
        f = ScalarFunction(name.lower(), return_type, lower, arity,
                           coerce_double, null_propagating, description)
        with self._lock:
            self._scalars[f.name] = f
        return f

    def register_aggregate(self, name: str, return_type, states, finalize,
                           description: str = "") -> AggregateFunction:
        # Built-in aggregates cannot be shadowed: the aggregation runtime
        # resolves by bare name (no "udf:" tag like scalars), so a
        # collision would hijack the built-in's state layout mid-query.
        from presto_tpu_torch.plan.builder import _AGG_CANON, _AGG_FUNCS

        lname = name.lower()
        if lname in _AGG_FUNCS or lname in _AGG_CANON:
            raise ValueError(
                f"cannot register aggregate {name!r}: shadows a built-in")
        f = AggregateFunction(lname, return_type,
                              tuple((s, op, t) for s, op, t in states),
                              finalize, description)
        with self._lock:
            self._aggregates[f.name] = f
        return f

    def unregister(self, name: str):
        with self._lock:
            self._scalars.pop(name.lower(), None)
            self._aggregates.pop(name.lower(), None)

    # -- resolution (FunctionManager.resolveFunction) ----------------------

    def scalar(self, name: str) -> Optional[ScalarFunction]:
        return self._scalars.get(name.lower())

    def aggregate(self, name: str) -> Optional[AggregateFunction]:
        return self._aggregates.get(name.lower())

    def list(self) -> List[Tuple[str, str, str]]:
        """(name, kind, description) rows for SHOW FUNCTIONS."""
        with self._lock:
            return sorted(
                [(f.name, "scalar (registered)", f.description)
                 for f in self._scalars.values()]
                + [(f.name, "aggregate (registered)", f.description)
                   for f in self._aggregates.values()]
            )

    # -- plugin loading (PluginManager.installPlugin analog) ---------------

    def load_plugin(self, spec: str):
        """Import `module` or `module:attr` and let it register functions:
        the module (or attr) must expose register_functions(registry)."""
        mod_name, _, attr = spec.partition(":")
        mod = importlib.import_module(mod_name)
        target = getattr(mod, attr) if attr else mod
        hook = getattr(target, "register_functions", None)
        if hook is None and callable(target):
            hook = target
        if hook is None:
            raise ValueError(
                f"function plugin {spec!r} exposes no register_functions()")
        hook(self)


# The default (global) registry — the session-independent function
# namespace every engine entry point consults.
GLOBAL = FunctionRegistry()


def registry() -> FunctionRegistry:
    return GLOBAL
