"""Minimal read-only LMDB parser (no native dependency).

The port's own copy of `vln_imagine_tpu/data/lmdb_reader.py` (pure Python).
The reference's released raw-image data for E2E pre-training is an LMDB
store: key "<scan>_<viewpoint>" -> raw uint8 buffer of shape
(36, 248, 330, 3) (VLN-HAMT/pretrain_src/data/image_data.py:60-66,225-231).
The LMDB -> RawPanoramaBank converter (scripts/convert_lmdb_bank.py) needs
no `lmdb` package: it parses the file format directly:
the on-disk layout is a stable public format (a copy-on-write B+tree of
fixed-size pages; see the file-format constants in OpenLDAP liblmdb's
mdb.c), and a read-only walk needs only four page kinds.

Layout facts used here (64-bit, little-endian files — the only kind the
reference toolchain produces):

- 16-byte page header: pgno u64, pad u16, flags u16, then either
  (lower u16, upper u16) for tree pages or pages u32 for overflow chains.
- pages 0 and 1 are meta pages; the live one has the larger txnid.  The
  page size lives in the FREE_DBI db record's md_pad field of meta 0.
- meta struct (after the header): magic u32 (0xBEEFC0DE), version u32,
  address u64, mapsize u64, dbs[2] (48 bytes each: pad u32, flags u16,
  depth u16, branch/leaf/overflow/entries/root u64), last_pg u64, txnid
  u64.  dbs[1] is the main (unnamed) database.
- tree pages hold nkeys = (lower - 16) / 2 nodes; mp_ptrs (u16 offsets
  relative to the page start) follow the header.
- node: lo u16, hi u16, flags u16, ksize u16, then the key bytes.  On a
  branch page the child pgno is lo | hi<<16 | flags<<32; on a leaf the
  data size is lo | hi<<16 and the value follows the key, except
  F_BIGDATA (0x01) nodes where an 8-byte overflow pgno follows instead
  and the value starts 16 bytes into that overflow chain.
"""

from __future__ import annotations

import mmap
import os
import struct

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
F_DUPDATA = 0x04
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class LmdbFormatError(ValueError):
    pass


class LmdbReader:
    """Iterate / look up entries of an LMDB main database, read-only.

    `path` may be the environment directory (containing data.mdb — the
    default `subdir=True` layout the reference uses) or the data file
    itself.  Values are returned as zero-copy memoryviews over the mmap;
    call bytes() on one to detach it.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0,
                             access=mmap.ACCESS_READ)
        self._view = memoryview(self._mm)
        # page size: FREE_DBI md_pad of meta 0 (dbs[0] starts 24 bytes into
        # the meta struct, which starts after the 16-byte page header)
        self.psize = self._u32(PAGEHDRSZ + 24)
        if not 512 <= self.psize <= 1 << 16:
            raise LmdbFormatError(f"implausible page size {self.psize}")
        metas = [self._meta(0), self._meta(self.psize)]
        live = max(metas, key=lambda m: m["txnid"])
        self.entries = live["main"]["entries"]
        self._root = live["main"]["root"]
        if live["main"]["flags"] & 0x04:  # MDB_DUPSORT
            raise LmdbFormatError("dupsort databases are not supported")

    # ------------------------------------------------------------- plumbing
    def _u16(self, off):
        return _U16.unpack_from(self._view, off)[0]

    def _u32(self, off):
        return _U32.unpack_from(self._view, off)[0]

    def _u64(self, off):
        return _U64.unpack_from(self._view, off)[0]

    def _meta(self, off):
        if self._u16(off + 10) & P_META == 0:
            raise LmdbFormatError(f"page at {off} is not a meta page")
        m = off + PAGEHDRSZ
        if self._u32(m) != MDB_MAGIC:
            raise LmdbFormatError(f"bad LMDB magic at {m}")

        def db(o):
            return {"pad": self._u32(o), "flags": self._u16(o + 4),
                    "depth": self._u16(o + 6), "entries": self._u64(o + 32),
                    "root": self._u64(o + 40)}

        return {"free": db(m + 24), "main": db(m + 72),
                "txnid": self._u64(m + 128)}

    def _page(self, pgno):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._view):
            raise LmdbFormatError(f"page {pgno} beyond end of file")
        flags = self._u16(off + 10)
        nkeys = (self._u16(off + 12) - PAGEHDRSZ) >> 1
        return off, flags, nkeys

    def _node(self, page_off, page_base, i):
        ptr = self._u16(page_base + PAGEHDRSZ + 2 * i)
        n = page_off + ptr
        return (self._u16(n), self._u16(n + 2), self._u16(n + 4),
                self._u16(n + 6), n + 8)

    def _leaf_value(self, lo, hi, flags, ksize, koff):
        if flags & F_DUPDATA:
            raise LmdbFormatError("dupsort data encountered")
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            opgno = self._u64(koff + ksize)
            ooff, oflags, _ = self._page(opgno)
            if oflags & P_OVERFLOW == 0:
                raise LmdbFormatError(
                    f"page {opgno} is not an overflow page")
            return self._view[ooff + PAGEHDRSZ:ooff + PAGEHDRSZ + dsize]
        doff = koff + ksize
        return self._view[doff:doff + dsize]

    # ------------------------------------------------------------------ api
    def items(self):
        """All (key: bytes, value: memoryview) pairs in key order."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            off, flags, nkeys = self._page(pgno)
            if flags & P_BRANCH:
                # push children in reverse so iteration stays in key order
                for i in reversed(range(nkeys)):
                    lo, hi, fl, _, _ = self._node(off, off, i)
                    stack.append(lo | (hi << 16) | (fl << 32))
            elif flags & P_LEAF:
                if flags & P_LEAF2:
                    raise LmdbFormatError("LEAF2 pages are not supported")
                for i in range(nkeys):
                    lo, hi, fl, ksize, koff = self._node(off, off, i)
                    key = bytes(self._view[koff:koff + ksize])
                    yield key, self._leaf_value(lo, hi, fl, ksize, koff)
            else:
                raise LmdbFormatError(
                    f"unexpected page flags {flags:#x} at page {pgno}")

    def keys(self):
        for k, _ in self.items():
            yield k

    def get(self, key: bytes):
        """Value for `key` (memoryview) or None — descends the tree."""
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            off, flags, nkeys = self._page(pgno)
            if flags & P_BRANCH:
                # rightmost child whose separator key <= target (node 0's
                # separator is empty, i.e. -infinity)
                child = None
                for i in range(nkeys):
                    lo, hi, fl, ksize, koff = self._node(off, off, i)
                    sep = bytes(self._view[koff:koff + ksize])
                    if i > 0 and sep > key:
                        break
                    child = lo | (hi << 16) | (fl << 32)
                pgno = child
            elif flags & P_LEAF:
                for i in range(nkeys):
                    lo, hi, fl, ksize, koff = self._node(off, off, i)
                    if bytes(self._view[koff:koff + ksize]) == key:
                        return self._leaf_value(lo, hi, fl, ksize, koff)
                return None
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x}")

    def close(self):
        self._view.release()
        try:
            self._mm.close()
        except BufferError:
            # a caller still holds a value memoryview (e.g. np.frombuffer
            # over it); the mmap stays alive until those views are dropped
            # and is then reclaimed with them
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        return self.entries
