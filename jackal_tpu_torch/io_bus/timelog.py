"""Per-stage time logging compatible with the reference plot scripts.

The reference appends one float (seconds) per line to files given by
-d/-p/-s (point_cloud.cpp:452-462, 391-401, 202-210, 287-295); the
scripts/plot-*.py harness consumes them. This writer reproduces that
format exactly, so the original scripts read the port's stage times.
"""
from __future__ import annotations

from typing import Optional, TextIO


class TimeLogWriter:
    """Append-mode one-float-per-line stage time files."""

    def __init__(self, dmap_file: Optional[str] = None,
                 pcl_file: Optional[str] = None,
                 scan_file: Optional[str] = None):
        self._files = {}
        for name, path in (("dmap", dmap_file), ("pcl", pcl_file),
                           ("scan", scan_file)):
            self._files[name] = open(path, "a") if path else None

    def log(self, stage: str, seconds: float) -> None:
        f: Optional[TextIO] = self._files.get(stage)
        if f is not None:
            f.write(f"{seconds}\n")
            f.flush()

    def close(self) -> None:
        for f in self._files.values():
            if f is not None:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
