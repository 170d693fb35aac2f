"""Shared libraries compiled at first use, cached by content hash.

Everything the port compiles goes through here: the CUDA kernels
(`ops/kernels.py`, nvcc) and the native host runtime (`native.py`, g++).
A library's name carries the hash of the files it is built from and of the
compiler's flags, so a changed source is rebuilt under a new name and an
unchanged one is never rebuilt.  A library appears only once its compiler
succeeded: each compiler writes a temporary file in the library's
directory, which replaces the library's path at the end.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from collections.abc import Iterable, Mapping, Sequence
from pathlib import Path


def library_path(build_dir: Path, stem: str, inputs: Iterable[Path],
                 flags: Sequence[str]) -> Path:
    """`build_dir / <stem>_<digest>.so`, the digest being the first 16 hex
    digits of the sha256 of the inputs' bytes, in order, and the flags
    joined by spaces."""
    h = hashlib.sha256()
    for path in inputs:
        h.update(Path(path).read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def build_libraries(compiler: Sequence[str], libraries: Mapping[Path, Path],
                    link: Sequence[str] = ()) -> None:
    """Build each library of `libraries` (source -> library path) that does
    not exist yet with `compiler -o <tmp> <source> link`, one compiler
    process a library, all started together.  Raises RuntimeError naming
    every source whose compiler failed, with its errors; a failed build
    leaves no file."""
    todo = {src: lib for src, lib in libraries.items() if not lib.exists()}
    tmps, jobs = [], []
    try:
        for src, lib in todo.items():
            lib.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
            os.close(fd)
            tmps.append(tmp)
            jobs.append((src, lib, tmp, subprocess.Popen(
                [*compiler, "-o", tmp, str(src), *link],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, lib, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{Path(compiler[0]).name} failed to build "
                              f"{src}:\n{err}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.unlink(tmp)
