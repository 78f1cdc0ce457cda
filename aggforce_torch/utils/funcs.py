"""Small functional helpers shared across the package.

API parity targets: reference ``util.py`` (``curry`` at util.py:146, ``Curry`` at
util.py:181, ``flatten`` at util.py:128). Implementations are original.
"""

from typing import Any, Callable, Generic, Iterable, List, TypeVar

R = TypeVar("R")


def flatten(nested: Iterable[Iterable[Any]]) -> List[Any]:
    """Flatten one level of nesting: [[a,b],[c]] -> [a,b,c]."""
    out: List[Any] = []
    for sub in nested:
        out.extend(sub)
    return out


def curry(func: Callable[..., R], *args: Any, **kwargs: Any) -> Callable[..., R]:
    """Return g where g(*a, **k) == func(*a, *args, **k, **kwargs).

    Note the curried positional args are appended *after* call-time positional
    args (matches reference semantics, which differs from functools.partial).
    """

    def inner(*call_args: Any, **call_kwargs: Any) -> R:
        return func(*call_args, *args, **call_kwargs, **kwargs)

    return inner


class Curry(Generic[R]):
    """Self-describing callable version of :func:`curry`.

    Useful for baking featurizer hyperparameters while keeping a reprable
    object (e.g. for CV grids).
    """

    def __init__(self, func: Callable[..., R], *args: Any, **kwargs: Any) -> None:
        self.func = func
        self.args = args
        self.kwargs = kwargs

    def __call__(self, *call_args: Any, **call_kwargs: Any) -> R:
        return self.func(*call_args, *self.args, **call_kwargs, **self.kwargs)

    def __repr__(self) -> str:
        parts = [f"{self.__class__.__name__}({self.func!r}"]
        if self.args:
            parts.append(f", args={self.args!r}")
        if self.kwargs:
            parts.append(f", kwargs={self.kwargs!r}")
        parts.append(")")
        return "".join(parts)

    def __str__(self) -> str:
        lines = [f"{self.__class__.__name__} instance:"]
        lines.append("  callable:")
        lines.extend("    " + ln for ln in str(self.func).split("\n"))
        lines.append("  args:")
        lines.extend("    " + ln for ln in str(self.args).split("\n"))
        lines.append("  kwargs:")
        lines.extend("    " + ln for ln in str(self.kwargs).split("\n"))
        return "\n".join(lines)
