"""ctypes binding of the native C++ runtime (`native/vln_native.cc`).

The port's own copy of `vln_imagine_tpu/native.py`: the all-pairs world
compiler and the MatterSim-surface graph simulator (`NativeWorld`,
`NativeSim`, oracles of the compiled environment), and the mmap'd feature
bank with its asynchronous prefetcher (`FeatureBank`, `BankPrefetcher`),
which the pre-training batcher reads on the real-data path.

The source is read where it is; the shared library is built with g++ at
first use into `build/native/` at the root of the checkout, named by the
content hash of the source and the flags (`utils/build.py`), so a changed
source is rebuilt and nothing is written into `native/`.  This is host
code: no kernel.
"""

from __future__ import annotations

import ctypes as C
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from vln_imagine_tpu_torch.utils import build

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "vln_native.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-shared")
_lib: Optional[C.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    return build.library_path(BUILD_DIR, "libvln_native", [SOURCE], CXX_FLAGS)


def ensure_built() -> Path:
    """Build the library for the current source unless it exists."""
    path = library_path()
    build.build_libraries([os.environ.get("CXX", "g++"), *CXX_FLAGS],
                          {SOURCE: path}, link=["-lpthread"])
    return path


def load() -> C.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = C.CDLL(str(ensure_built()))
        P, I, D, L = C.c_void_p, C.c_int, C.c_double, C.c_int64
        pd, pi, pf, pl = (C.POINTER(C.c_double), C.POINTER(C.c_int),
                          C.POINTER(C.c_float), C.POINTER(C.c_int64))
        sigs = {
            "vln_world_create": (P, [I, pd, I, pi]),
            "vln_world_destroy": (None, [P]),
            "vln_world_allpairs": (None, [P, pd, pi, pi]),
            "vln_world_degree": (I, [P, I]),
            "vln_sim_create": (P, [P, I]),
            "vln_sim_destroy": (None, [P]),
            "vln_sim_new_episode": (None, [P, I, D, D]),
            "vln_sim_make_action": (None, [P, I, D, D]),
            "vln_sim_get_state": (None, [P, pi, pd, pd, pi]),
            "vln_sim_navigable": (I, [P, I, pi, pd, pd]),
            "vln_sim_candidates": (I, [P, I, pi, pi, pd, pd]),
            "vln_bank_open": (P, [C.c_char_p, L, I]),
            "vln_bank_close": (None, [P]),
            "vln_bank_gather": (None, [P, pl, I, pf]),
            "vln_prefetch_create": (P, [P, I]),
            "vln_prefetch_submit": (None, [P, pl, I]),
            "vln_prefetch_wait": (I, [P, pf]),
            "vln_prefetch_destroy": (None, [P]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


class NativeWorld:
    """C++ world: adjacency + all-pairs shortest paths."""

    def __init__(self, xyz: np.ndarray, edges: list[tuple[int, int]]):
        self._lib = load()
        self.n = len(xyz)
        xyz = np.ascontiguousarray(xyz, np.float64)
        earr = np.ascontiguousarray(
            np.asarray(edges, np.int32).reshape(-1, 2))
        self._h = self._lib.vln_world_create(
            self.n, _ptr(xyz, C.c_double), len(edges), _ptr(earr, C.c_int))

    def all_pairs(self):
        n = self.n
        dist = np.zeros((n, n), np.float64)
        nxt = np.zeros((n, n), np.int32)
        hops = np.zeros((n, n), np.int32)
        self._lib.vln_world_allpairs(self._h, _ptr(dist, C.c_double),
                                     _ptr(nxt, C.c_int), _ptr(hops, C.c_int))
        return dist, nxt, hops

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vln_world_destroy(self._h)
            self._h = None


class NativeSim:
    """MatterSim-surface graph simulator over a NativeWorld."""

    def __init__(self, world: NativeWorld, views: int = 36):
        self._lib = load()
        self.world = world
        self._h = self._lib.vln_sim_create(world._h, views)

    def new_episode(self, node: int, heading: float, elevation: float = 0.0):
        self._lib.vln_sim_new_episode(self._h, node, heading, elevation)

    def make_action(self, index: int, heading_delta: float,
                    elevation_delta: float):
        self._lib.vln_sim_make_action(self._h, index, heading_delta,
                                      elevation_delta)

    def get_state(self):
        node, view = C.c_int(), C.c_int()
        heading, elevation = C.c_double(), C.c_double()
        self._lib.vln_sim_get_state(self._h, C.byref(node), C.byref(heading),
                                    C.byref(elevation), C.byref(view))
        return dict(node=node.value, heading=heading.value,
                    elevation=elevation.value, view_index=view.value)

    def navigable(self, max_out: int = 32):
        nodes = np.zeros(max_out, np.int32)
        rh = np.zeros(max_out, np.float64)
        re = np.zeros(max_out, np.float64)
        n = self._lib.vln_sim_navigable(self._h, max_out,
                                        _ptr(nodes, C.c_int),
                                        _ptr(rh, C.c_double),
                                        _ptr(re, C.c_double))
        return nodes[:n], rh[:n], re[:n]

    def candidates(self, max_out: int = 32):
        nodes = np.zeros(max_out, np.int32)
        pids = np.zeros(max_out, np.int32)
        hs = np.zeros(max_out, np.float64)
        es = np.zeros(max_out, np.float64)
        n = self._lib.vln_sim_candidates(self._h, max_out,
                                         _ptr(nodes, C.c_int),
                                         _ptr(pids, C.c_int),
                                         _ptr(hs, C.c_double),
                                         _ptr(es, C.c_double))
        return nodes[:n], pids[:n], hs[:n], es[:n]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vln_sim_destroy(self._h)
            self._h = None


class FeatureBank:
    """mmap'd float32 feature store with batched row gather (rows out of
    range come back zeroed)."""

    def __init__(self, path: str, rows: int, row_floats: int):
        self._lib = load()
        self.rows = rows
        self.row_floats = row_floats
        self._h = self._lib.vln_bank_open(str(path).encode(), rows, row_floats)
        if not self._h:
            raise OSError(f"cannot open feature bank {path}")

    @staticmethod
    def write(path: str, array: np.ndarray) -> "FeatureBank":
        flat = np.ascontiguousarray(array, np.float32).reshape(
            array.shape[0], -1)
        flat.tofile(path)
        return FeatureBank(path, flat.shape[0], flat.shape[1])

    def gather(self, row_ids: np.ndarray) -> np.ndarray:
        row_ids = np.ascontiguousarray(row_ids, np.int64)
        out = np.zeros((len(row_ids), self.row_floats), np.float32)
        self._lib.vln_bank_gather(self._h, _ptr(row_ids, C.c_int64),
                                  len(row_ids), _ptr(out, C.c_float))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vln_bank_close(self._h)
            self._h = None


class BankPrefetcher:
    """Double-buffered batch gather over a FeatureBank: a C++ worker thread
    fills the next batch while the caller consumes the current one (the
    host half of the reference's PrefetchLoader overlap,
    pretrain_src/data/loader.py:90-124).

        pf.submit(rows0)
        while ...:
            batch = pf.wait()        # rows gathered in the background
            pf.submit(next_rows)     # overlaps with consuming `batch`
            consume(batch)
    """

    def __init__(self, bank: FeatureBank, capacity: int):
        self._lib = load()
        self._bank = bank  # keep alive
        self.capacity = capacity
        self.row_floats = bank.row_floats
        self._h = self._lib.vln_prefetch_create(bank._h, capacity)

    def submit(self, row_ids: np.ndarray):
        row_ids = np.ascontiguousarray(row_ids, np.int64)
        if len(row_ids) > self.capacity:
            raise ValueError(f"{len(row_ids)} rows exceed the prefetcher's "
                             f"capacity {self.capacity}")
        self._lib.vln_prefetch_submit(self._h, _ptr(row_ids, C.c_int64),
                                      len(row_ids))

    def wait(self) -> np.ndarray:
        out = np.zeros((self.capacity, self.row_floats), np.float32)
        n = self._lib.vln_prefetch_wait(self._h, _ptr(out, C.c_float))
        if n < 0:
            raise RuntimeError("wait() without a submitted batch")
        return out[:n]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vln_prefetch_destroy(self._h)
            self._h = None
