"""Cost functions defined as Python expression strings.

Role-equivalent to ``pydcop/utils/expressionfunction.py`` in the reference:
wrap an expression like ``"10 if v1 == v2 else 0"`` as a callable whose
free variables are discovered from the AST, with support for fixing some
variables (partial application).

Design notes (TPU build): expression functions only run on the host, at
*compile* time — the problem compiler tabulates them over their (finite)
domains into dense cost tables that live on device.  They are never traced
by JAX, so arbitrary Python is fine here.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Callable, Dict, Iterable, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr

# Names usable inside expressions without being treated as variables.
_SAFE_BUILTINS = {
    "abs": abs,
    "min": min,
    "max": max,
    "round": round,
    "len": len,
    "sum": sum,
    "int": int,
    "float": float,
    "str": str,
    "bool": bool,
    "pow": pow,
    "all": all,
    "any": any,
    "sorted": sorted,
}


def _is_statement_form(expression: str) -> bool:
    """True when the expression is a function body containing a ``return``
    statement rather than a single expression.  A word-boundary match
    avoids misclassifying names like ``return_delay``; a final AST check
    avoids misclassifying e.g. string literals containing ``return``."""
    if not re.search(r"\breturn\b", expression):
        return False
    try:
        ast.parse(expression, mode="eval")
        return False  # parses as a plain expression → not a body
    except SyntaxError:
        return True


def _free_variables(expression: str) -> set:
    """Names loaded by the expression minus builtins/imports and
    names assigned within (multi-line expressions with 'return')."""
    src = expression
    if _is_statement_form(expression):
        # multi-line function body form
        tree = ast.parse(_as_function_src(expression))
    else:
        tree = ast.parse(src, mode="eval")
    loaded, stored = set(), set()
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loaded.add(node.id)
            else:
                stored.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                imported.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.comprehension):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    stored.add(t.id)
    return loaded - stored - imported - set(_SAFE_BUILTINS) - {"math"}


def _as_function_src(expression: str, name: str = "_expr_fn") -> str:
    body = "\n".join("    " + line for line in expression.splitlines())
    return f"def {name}():\n{body}\n"


class ExpressionFunction(SimpleRepr):
    """A callable built from a Python expression string.

    >>> f = ExpressionFunction('a + b')
    >>> sorted(f.variable_names)
    ['a', 'b']
    >>> f(a=1, b=2)
    3

    Supports multi-line bodies containing ``return`` and partial
    application (fixed variables) via ``partial`` / constructor kwargs.
    """

    def __init__(self, expression: str, **fixed_vars: Any):
        self._expression = expression
        self._fixed_vars = dict(fixed_vars)
        self._all_vars = frozenset(_free_variables(expression))
        unknown = set(fixed_vars) - self._all_vars
        if unknown:
            raise ValueError(
                f"Fixed variables {unknown} do not appear in expression "
                f"{expression!r}"
            )
        self._compile()

    def _compile(self) -> None:
        import math

        glb: Dict[str, Any] = {"__builtins__": _SAFE_BUILTINS, "math": math}
        if _is_statement_form(self._expression):
            src = _as_function_src(self._expression)
            code = compile(ast.parse(src), "<expression_function>", "exec")
            # Free variables are injected by re-exec'ing the def with the
            # call scope merged into globals, then calling the function.
            def call(scope: Dict[str, Any]) -> Any:
                g = dict(glb)
                g.update(scope)
                loc2: Dict[str, Any] = {}
                exec(code, g, loc2)
                return loc2["_expr_fn"]()

            self._call = call
        else:
            code = compile(
                ast.parse(self._expression, mode="eval"),
                "<expression_function>",
                "eval",
            )

            def call(scope: Dict[str, Any]) -> Any:
                g = dict(glb)
                g.update(scope)
                return eval(code, g)  # noqa: S307 — sandboxed builtins

            self._call = call

    # -- public API ----------------------------------------------------

    @property
    def expression(self) -> str:
        return self._expression

    @property
    def variable_names(self) -> Iterable[str]:
        """Names of the (non-fixed) variables of the function."""
        return self._all_vars - set(self._fixed_vars)

    @property
    def fixed_vars(self) -> Dict[str, Any]:
        return dict(self._fixed_vars)

    def partial(self, **kwargs: Any) -> "ExpressionFunction":
        fixed = dict(self._fixed_vars)
        fixed.update(kwargs)
        return ExpressionFunction(self._expression, **fixed)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if args:
            if len(args) == 1 and isinstance(args[0], dict) and not kwargs:
                kwargs = args[0]
            else:
                raise TypeError(
                    "ExpressionFunction must be called with keyword "
                    "arguments (or a single assignment dict)"
                )
        scope = dict(self._fixed_vars)
        scope.update(kwargs)
        missing = set(self._all_vars) - set(scope)
        if missing:
            raise TypeError(f"Missing variable(s) {missing} for {self}")
        return self._call(scope)

    def __repr__(self) -> str:
        return f"ExpressionFunction({self._expression!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ExpressionFunction)
            and other._expression == self._expression
            and other._fixed_vars == self._fixed_vars
        )

    def __hash__(self) -> int:
        return hash((self._expression, tuple(sorted(self._fixed_vars.items()))))

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "expression": self._expression,
            "fixed_vars": simple_repr(self._fixed_vars),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        fixed = from_repr(r.get("fixed_vars", {})) or {}
        return cls(r["expression"], **fixed)
