"""How a CUDA source of the port becomes a callable, and the count of every
kernel launch.

Every `csrc/*.cu` is built at first use with nvcc into `build/kernels/` at
the root of the checkout: one shared library with a plain C interface a
source, `<stem>_<digest>.so`, where the digest covers the source, every
`csrc/*.cuh` and `NVCC_FLAGS` (`utils/build.py`), so a changed source or
header is rebuilt and a warm cache stays warm.  The first launch builds
what is missing and loads every library with ctypes, inside the span
`setup.kernels`.

The C entry of `<stem>.cu` is `vln_<stem>`, returning 0 or a CUDA error.
The op module that marshals an entry's arguments declares it as an `Entry`
with their ctypes types and the names of the wrappers that count its
launches (the counters `launches.<name>` of `utils/spans.py`, which
`launch_counts()` reads).  Calling an `Entry` launches on the arguments as
they are, on whatever stream they name (`stream(t)`: PyTorch's current
one), without synchronising, and raises on a non-zero return.  After its
first call an entry's launch is one attribute read of the bound ctypes
function.
"""

from __future__ import annotations

import ctypes
import threading
from collections.abc import Sequence
from pathlib import Path

import torch

from vln_imagine_tpu_torch.utils import spans
from vln_imagine_tpu_torch.utils.build import build_libraries, library_path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# the `dtype` argument of the C entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

ENTRIES: dict[str, "Entry"] = {}  # C entry name -> its declaration
_libs: dict[str, ctypes.CDLL] = {}  # source stem -> loaded library
_lock = threading.Lock()


def stream(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on t's device, as a C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sources() -> list[Path]:
    """Every kernel source, in name order."""
    return sorted(CSRC.glob("*.cu"))


def kernel_library(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """The library of `source`: `<stem>_<digest>.so` in `build_dir`, the
    digest over the source, every `*.cuh` beside it and the flags."""
    source = Path(source)
    return library_path(build_dir, source.stem,
                        [source, *sorted(source.parent.glob("*.cuh"))],
                        NVCC_FLAGS)


def build(libraries: dict[Path, Path] | None = None) -> dict[Path, Path]:
    """Compile each source (default: every kernel source, into its
    `kernel_library`) that has no library yet, one nvcc each, all started
    together.  Returns source -> library."""
    if libraries is None:
        libraries = {src: kernel_library(src) for src in sources()}
    if not all(lib.exists() for lib in libraries.values()):
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
        build_libraries([nvcc, *NVCC_FLAGS], libraries)
    return libraries


def load() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; stem -> library.
    The first call, which builds or loads, is the span `setup.kernels`."""
    with _lock:
        if not _libs:
            with spans.span("setup.kernels"):
                for src, lib in build().items():
                    _libs[src.stem] = ctypes.CDLL(str(lib))
    return _libs


class Entry:
    """The C entry `name` (`vln_<stem>` of `csrc/<stem>.cu`), its ctypes
    argument types, and the wrappers that count its launches."""

    def __init__(self, name: str, argtypes: Sequence, launches: Sequence[str]):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = tuple(launches)
        self._fn = None
        ENTRIES[name] = self

    def bind(self, lib: ctypes.CDLL):
        """The entry of `lib`, typed by this declaration."""
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        """Launch; RuntimeError naming the entry on a CUDA error."""
        fn = self._fn
        if fn is None:
            fn = self._fn = self.bind(load()[self.name[len("vln_"):]])
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"kernel launch {self.name} failed: CUDA "
                               f"error {err}")


def reset_launch_counts() -> None:
    spans.reset_counts("launches.")


def launch_counts() -> dict[str, int]:
    """Each wrapper's kernel launches since the last reset (the counters
    `launches.<wrapper>` of utils/spans.py), for every wrapper an `Entry`
    names."""
    n = spans.counts()
    return {name: n.get("launches." + name, 0)
            for entry in ENTRIES.values() for name in entry.launches}
