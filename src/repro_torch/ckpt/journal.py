"""Append-only write-ahead journal for the mutable store (DESIGN.md §6.5),
PyTorch port of ``repro/ckpt/journal.py``: the same files, byte for byte.

One segment per snapshot step: ``journal_<step>.log`` holds every write
made AFTER snapshot ``step`` (rotated by ``MutableIndex.save``). Restore
loads the newest verifying snapshot S and replays the segments with step
>= S in step order; records are CRC-framed so a torn tail (a crash in the
middle of an append) is detected and ignored, never misapplied.

Format (all little-endian):

    header   16 bytes   MAGIC ``b"RJL1"`` + key-dtype str padded to 12
    record   25 bytes   seq uint64 · op uint8 (0=insert, 1=delete) ·
                        key int64 bits (float keys carried as float64 bit
                        pattern) · value int32 · crc32 of the 21 payload
                        bytes

Records carry a globally monotone sequence number so replay can detect
ordering violations across segments.

The ``fsync`` policy:

* ``"never"``: OS page cache only; a crash loses whatever the kernel had
  not written back.
* ``"rotate"`` (default): ``os.fsync`` when a segment closes at rotation or
  shutdown; every *rotated* segment is durable.
* ``"always"``: ``os.fsync`` on every ``flush()``, i.e. after every
  acknowledged write batch: no acknowledged write is lost, at the cost of
  a disk barrier a batch.

The reference's counters go to the metrics registry (``obs``):
``journal_appends`` and ``journal_bytes`` at each flush of a batch,
``journal_syncs{policy}`` at each ``os.fsync``, ``journal_compactions``
and ``journal_compacted_records`` at each compaction that drops records.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..obs import get_registry

MAGIC = b"RJL1"
HEADER = struct.Struct("<4s12s")
PAYLOAD = struct.Struct("<QBqi")
RECORD = struct.Struct("<QBqiI")
# one record as a numpy structured type (packed: 25 bytes, the same
# layout as RECORD), for packing a whole batch at once
RECORD_DTYPE = np.dtype([("seq", "<u8"), ("op", "u1"), ("key", "<i8"),
                         ("val", "<i4"), ("crc", "<u4")])
OP_INSERT, OP_DELETE = 0, 1
FSYNC_POLICIES = ("never", "rotate", "always")


def segment_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"journal_{step:08d}.log")


def scan_dir(ckpt_dir: str):
    """Sorted [(step, path)] of the directory's journal segments."""
    out = []
    if os.path.isdir(ckpt_dir):
        for f in os.listdir(ckpt_dir):
            if f.startswith("journal_") and f.endswith(".log"):
                try:
                    out.append((int(f[len("journal_"):-len(".log")]),
                                os.path.join(ckpt_dir, f)))
                except ValueError:
                    pass
    return sorted(out)


def _encode_key(key, dtype: np.dtype) -> int:
    if dtype.kind == "f":
        return int(np.float64(key).view(np.int64))
    return int(key)


def _decode_key(bits: int, dtype: np.dtype):
    if dtype.kind == "f":
        return dtype.type(np.int64(bits).view(np.float64))
    return dtype.type(bits)


def _record(seq: int, op: int, bits: int, value: int) -> bytes:
    payload = PAYLOAD.pack(seq, op, bits, int(value))
    return payload + struct.pack("<I", zlib.crc32(payload))


def _header(dtype: np.dtype) -> bytes:
    return HEADER.pack(MAGIC, dtype.str.encode()[:12])


class Journal:
    """Appender for one segment. Creates the file and its header when
    absent or empty; otherwise appends after the existing records (the
    caller truncates any torn tail first: :func:`truncate_torn`)."""

    def __init__(self, path: str, key_dtype, next_seq: int = 0,
                 fsync: str = "rotate"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, "
                             f"got {fsync!r}")
        self.path = path
        self.dtype = np.dtype(key_dtype)
        self.seq = int(next_seq)
        self.fsync = fsync
        self.syncs = 0                    # os.fsync calls on this segment
        self._pending = 0                 # appends since the last flush()
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_header(self.dtype))
            self._f.flush()

    def append_many(self, keys, values, *, delete: bool = False):
        """Append one record a key (the reference's per-record bytes),
        packed with numpy, a CRC a record and one write."""
        n = len(keys)
        if n == 0:
            return
        rec = np.zeros(n, RECORD_DTYPE)
        rec["seq"] = np.arange(self.seq, self.seq + n, dtype=np.uint64)
        rec["op"] = OP_DELETE if delete else OP_INSERT
        k = np.asarray(keys, self.dtype)
        rec["key"] = k.astype(np.float64).view(np.int64) \
            if self.dtype.kind == "f" else k.astype(np.int64)
        rec["val"] = np.asarray(values, np.int32)
        raw = rec.tobytes()
        step, body = RECORD.size, PAYLOAD.size
        rec["crc"] = [zlib.crc32(raw[o:o + body])
                      for o in range(0, n * step, step)]
        self._f.write(rec.tobytes())
        self.seq += n
        self._pending += n

    def flush(self):
        self._f.flush()
        if self._pending:
            if self.fsync == "always":
                self._sync()
            reg = get_registry()
            reg.counter("journal_appends").inc(self._pending)
            reg.counter("journal_bytes").inc(self._pending * RECORD.size)
            self._pending = 0

    def _sync(self):
        os.fsync(self._f.fileno())
        self.syncs += 1
        get_registry().counter("journal_syncs", policy=self.fsync).inc()

    def close(self):
        try:
            self.flush()
            if self.fsync == "rotate":
                self._sync()
        finally:
            self._f.close()


def read_segment(path: str):
    """(key_dtype, [(seq, op, key, value), ...]): every record up to the
    first torn or corrupt one (short read, CRC mismatch, or a sequence
    regression inside the segment); the tail after it is ignored."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < HEADER.size:
        return None, []
    magic, dstr = HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        return None, []
    dtype = np.dtype(dstr.rstrip(b"\x00").decode())
    out = []
    off, last = HEADER.size, -1
    while off + RECORD.size <= len(blob):
        seq, op, bits, val, crc = RECORD.unpack_from(blob, off)
        if zlib.crc32(blob[off: off + PAYLOAD.size]) != crc:
            break
        if seq <= last or op not in (OP_INSERT, OP_DELETE):
            break
        last = seq
        out.append((seq, op, _decode_key(bits, dtype), val))
        off += RECORD.size
    return dtype, out


def compact_segment(path: str) -> int:
    """Rewrite a CLOSED segment keeping only each key's last record: N
    overwrites of one key collapse to the final writer. Correct because
    replay is an idempotent in-order upsert, and a final tombstone is kept
    so deletes still replay. Surviving records keep their sequence numbers
    (a monotone subsequence) and the rewrite is atomic (tmp + fsync +
    rename): a crash while compacting leaves the original segment. Returns
    the number of records dropped."""
    dtype, recs = read_segment(path)
    if dtype is None or not recs:
        return 0
    last_seq: dict = {}
    for seq, op, key, val in recs:
        last_seq[_encode_key(key, dtype)] = seq
    dropped = len(recs) - len(last_seq)
    if dropped == 0:
        return 0
    keep = set(last_seq.values())
    tmp = path + ".compact"
    with open(tmp, "wb") as f:
        f.write(_header(dtype))
        for seq, op, key, val in recs:
            if seq in keep:
                f.write(_record(seq, op, _encode_key(key, dtype), val))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    reg = get_registry()
    reg.counter("journal_compactions").inc()
    reg.counter("journal_compacted_records").inc(dropped)
    return dropped


def truncate_torn(path: str):
    """Cut the segment down to its valid prefix (header + CRC-clean
    records), so later appends follow intact data instead of a torn
    record."""
    dtype, recs = read_segment(path)
    if dtype is None:
        return
    good = HEADER.size + len(recs) * RECORD.size
    if os.path.getsize(path) > good:
        with open(path, "r+b") as f:
            f.truncate(good)
