from pydcop_tpu_torch.utils.simple_repr import (
    SimpleRepr,
    SimpleReprException,
    simple_repr,
    from_repr,
)
from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction

__all__ = [
    "SimpleRepr",
    "SimpleReprException",
    "simple_repr",
    "from_repr",
    "ExpressionFunction",
]
