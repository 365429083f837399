# Copied from src/repro/core/registry.py; `repro.` rewritten to `repro_torch.`.
"""Named-factory registry: the one lookup idiom behind every
``make_*`` function.

The repo grew four ad-hoc factories — ``make_policy`` (an if-chain),
``make_arrival`` / ``make_admission`` / ``make_placement`` (module-level
dicts) — each with its own unknown-name error wording.  :class:`Registry`
unifies them: entries register under a lowercase name, ``names`` preserves
registration order (the historical ``*_NAMES`` tuples), and a miss always
raises the same shape of ``KeyError``::

    unknown <kind> 'nope'; choose from ('a', 'b', ...)

Factories stay thin public functions (``make_policy(name, ...)``) so no
call site changes; only the lookup behind them is shared.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


class Registry:
    """Ordered name → factory mapping with a uniform unknown-name error.

    ``kind`` is the human-readable noun used in the error message
    ("policy", "arrival process", ...).  Registration order is public
    API: ``names`` backs the historical ``POLICY_NAMES``-style tuples
    that tests and benchmarks iterate.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str,
                 factory: Callable[..., Any]) -> Callable[..., Any]:
        """Register ``factory`` under ``name`` (lowercase); returns the
        factory so it can be used as a decorator."""
        key = name.lower()
        if key in self._entries:
            raise ValueError(f"duplicate {self.kind} name {name!r}")
        self._entries[key] = factory
        return factory

    @property
    def names(self) -> Tuple[str, ...]:
        """Registered names, in registration order."""
        return tuple(self._entries)

    def __contains__(self, name: str) -> bool:
        """Whether ``name`` (case-insensitive) is registered."""
        return name.lower() in self._entries

    def get(self, name: str) -> Callable[..., Any]:
        """The factory registered under ``name``, or the shared
        unknown-name ``KeyError`` listing the valid choices."""
        try:
            return self._entries[name.lower()]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"choose from {self.names}") from None

    def make(self, name: str, *args: Any, **kwargs: Any) -> Any:
        """Instantiate ``name``'s entry with the given arguments."""
        return self.get(name)(*args, **kwargs)
