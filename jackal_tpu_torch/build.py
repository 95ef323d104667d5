"""Build the port's shared libraries into the package's ignored _build/.

Two kinds of library go through here: the C++ host prior (g++) and the
CUDA kernels (nvcc, one library per source under csrc/). Each library is
named by a hash of its sources and flags, so a changed source rebuilds and
a checkout never loads a binary built from other sources or for another
CPU (-march=native). A build writes a temporary file and renames it into
place, so concurrent test workers never load a half-written library.
Several builds start together and are awaited together.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


@dataclass(frozen=True)
class Library:
    name: str
    compiler: str
    flags: tuple
    sources: tuple
    headers: tuple = ()   # files the sources include: hashed, not compiled

    @property
    def path(self) -> str:
        h = hashlib.sha256()
        h.update(" ".join((self.compiler,) + self.flags).encode())
        for src in self.sources + self.headers:
            with open(src, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")


# compiler output of the last build of each library (chip_smoke prints the
# nvcc -Xptxas -v register and spill report from here)
BUILD_LOGS: Dict[str, str] = {}


def build(libs: Sequence[Library]) -> List[str]:
    """Build every library not yet built, all compilers at once; return the
    paths in order. Raises RuntimeError with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [lib.path for lib in libs]
    running = []
    for lib, out in zip(libs, paths):
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [lib.compiler, *lib.flags, "-o", tmp, *lib.sources]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((lib, proc, tmp, out, cmd))
    errors = []
    for lib, proc, tmp, out, cmd in running:
        log, _ = proc.communicate()
        BUILD_LOGS[lib.name] = log
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return paths
