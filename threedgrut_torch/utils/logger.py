"""Console logger, port of threedgrut_tpu/utils/logger.py: rich's console
(rules, tables) where rich is installed and the output is a terminal,
plain printing otherwise, and a registry of tracked tasks' elapsed time."""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional


class Logger:
    def __init__(self, use_rich: Optional[bool] = None):
        if use_rich is None:
            use_rich = sys.stdout.isatty()
        self._console = None
        if use_rich:
            try:
                from rich.console import Console
            except ImportError:
                Console = None
            if Console is not None:
                self._console = Console()
        self._tracked: Dict[str, float] = {}
        self._elapsed: Dict[str, float] = {}

    def info(self, msg: str) -> None:
        if self._console:
            self._console.log(msg)
        else:
            print(msg, flush=True)

    def warning(self, msg: str) -> None:
        self.info(f"WARNING: {msg}")

    def rule(self, title: str) -> None:
        if self._console:
            self._console.rule(title)
        else:
            print(f"===== {title} =====", flush=True)

    def table(self, title: str, rows: Dict[str, object]) -> None:
        if self._console:
            from rich.table import Table
            t = Table(title=title)
            t.add_column("key")
            t.add_column("value")
            for k, v in rows.items():
                t.add_row(str(k), str(v))
            self._console.print(t)
        else:
            print(f"-- {title} --", flush=True)
            for k, v in rows.items():
                print(f"  {k}: {v}", flush=True)

    # Tracked tasks: elapsed seconds summed per name.
    def start_task(self, name: str) -> None:
        self._tracked[name] = time.perf_counter()

    def end_task(self, name: str) -> float:
        dt = time.perf_counter() - self._tracked.pop(name,
                                                     time.perf_counter())
        self._elapsed[name] = self._elapsed.get(name, 0.0) + dt
        return dt

    def elapsed(self) -> Dict[str, float]:
        return dict(self._elapsed)
