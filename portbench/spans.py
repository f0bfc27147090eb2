"""The program's own spans and counters (``repro_torch.trace``), by
``solve`` call.

In a traced run the program records while the harness's
``torch.profiler`` session runs, so the store holds the traced half's
calls alone.  A program without ``repro_torch.trace`` records nothing:
:func:`solve_calls` is then empty, and every reader of it returns None.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple


class Call(NamedTuple):
    """One recorded ``solve`` request: its root span, all its spans by
    start, and its counters."""
    root: object
    spans: list
    counters: Dict[str, int]

    def first(self, name: str):
        """The call's first span named ``name``, or None."""
        return next((s for s in self.spans if s.name == name), None)

    def named(self, prefix: str) -> list:
        """The call's spans whose names begin with ``prefix``."""
        return [s for s in self.spans if s.name.startswith(prefix)]


def solve_calls() -> List[Call]:
    """Every request in the program's store whose root span is
    ``solve``."""
    try:
        from repro_torch import trace
    except ImportError:
        return []
    snap = trace.snapshot()
    groups: Dict[int, list] = {}
    for s in snap["spans"]:
        groups.setdefault(s.request, []).append(s)
    calls = []
    for request, group in groups.items():
        root = next((s for s in group if s.id == request), None)
        if root is None or root.name != "solve":
            continue
        group.sort(key=lambda s: (s.start_ns, s.id))
        calls.append(Call(root, group,
                          dict(snap["counters"].get(request, {}))))
    return calls
