"""Multi-subtask progress meter (tk::Progress): the port's own copy of
quinoa_tpu/base/progress.py."""

from __future__ import annotations

import sys
from typing import Sequence


class Progress:
    """Track N named subtasks with expected totals; prints a one-line
    status as sub-tasks complete (Progress.hpp)."""

    def __init__(self, prefix: str, names: Sequence[str],
                 totals: Sequence[int], stream=None):
        assert len(names) == len(totals)
        self.prefix = prefix
        self.names = list(names)
        self.totals = list(totals)
        self.done = [0] * len(names)
        self.stream = stream or sys.stderr

    def inc(self, i: int, n: int = 1):
        self.done[i] += n
        self._print()

    def _print(self):
        parts = [
            f"{nm}:{d}/{t}"
            for nm, d, t in zip(self.names, self.done, self.totals)
        ]
        self.stream.write(f"\r{self.prefix} [{' '.join(parts)}]")
        if all(d >= t for d, t in zip(self.done, self.totals)):
            self.stream.write(" done\n")
        self.stream.flush()
