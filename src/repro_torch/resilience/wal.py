"""Write-ahead log of canonical update batches, and crash recovery.

Durability contract: every ``apply`` appends its canonical batch (deduped,
unpadded host arrays) to the WAL and fsyncs BEFORE the engine mutates any
pool.  A process killed at any point
after the append can therefore be recovered exactly: ``restore`` the last
checkpoint, then replay the WAL suffix (records past the checkpoint
version) through ``apply`` — the replayed trajectory is bit-identical to
the uninterrupted one because ``apply`` is deterministic in (pool state,
canonical batch) and the checkpoint restores the pools leaf-for-leaf.

On-disk format — segment files ``wal-<first_version>.log`` of framed
records::

    magic   u32   0x4C415731 ("1WAL" LE)
    version u64   store version this batch produces
    n_ins   u32   insert lanes     n_del u32  delete lanes
    has_w   u8    + 3 pad bytes
    crc     u32   zlib.crc32 over (header-sans-crc + payload)
    payload       ins_src u32[n_ins] · ins_dst u32[n_ins]
                  · ins_w f32[n_ins] (if has_w) · del_src u32[n_del]
                  · del_dst u32[n_del]

A torn or corrupt tail record (the normal crash-mid-append case) ends that
segment's replay; segments rotate every ``segment_records`` appends and
``truncate`` drops whole segments once a checkpoint covers them.
Maintenance epochs are NOT logged: they are re-derived deterministically
during replay from the checkpointed maintenance counters.

The byte format is the reference's (``repro.resilience.wal``), so either
package reads the other's segments.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs import flight as _flight
from ..obs import postmortem as _postmortem

_FL_APPEND = _flight.intern("wal.append")
_FL_ROLLBACK = _flight.intern("wal.rollback")
_FL_RECOVER = _flight.intern("wal.recover")

_MAGIC = 0x4C415731
#: magic, version, n_ins, n_del, has_w, crc
_HEAD = struct.Struct("<IQIIB3xI")
_CRC_HEAD = struct.Struct("<QIIB")      # the crc-covered header prefix


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One logged canonical batch (host arrays, unpadded)."""
    version: int
    ins_src: np.ndarray
    ins_dst: np.ndarray
    ins_w: Optional[np.ndarray]
    del_src: np.ndarray
    del_dst: np.ndarray


def _segment_name(first_version: int) -> str:
    return f"wal-{first_version:012d}.log"


def _segment_version(path: Path) -> int:
    return int(path.stem.split("-")[1])


def _segments(wal_dir: Path) -> List[Path]:
    return sorted(wal_dir.glob("wal-*.log"))


class WriteAheadLog:
    """Append-only durable log.  One writer; readers go via ``read_wal``."""

    def __init__(self, wal_dir, *, segment_records: int = 1024,
                 sync: bool = True):
        self.wal_dir = Path(wal_dir)
        self.wal_dir.mkdir(parents=True, exist_ok=True)
        self.segment_records = int(segment_records)
        self.sync = bool(sync)
        self._f = None                  # current segment (lazy-opened)
        self._path: Optional[Path] = None
        self._records_in_segment = 0
        self.appended = 0

    # ------------------------------------------------------------------ write
    def _open_segment(self, first_version: int) -> None:
        self._close_segment()
        self._path = self.wal_dir / _segment_name(first_version)
        if self._path.exists():
            # a crashed writer left this segment behind (crash during its
            # first append): keep the intact prefix — those records are
            # covered by the recovery replay — truncate the torn tail, and
            # continue appending after it.
            end, n = _intact_prefix(self._path.read_bytes())
            self._f = open(self._path, "r+b")
            self._f.truncate(end)
            self._f.seek(end)
            self._records_in_segment = n
        else:
            self._f = open(self._path, "wb")
            self._records_in_segment = 0

    def _close_segment(self) -> None:
        if self._f is not None:
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def append(self, version: int, ins_src, ins_dst, ins_w,
               del_src, del_dst) -> Tuple[Path, int]:
        """Durably frame one canonical batch; returns a rollback token."""
        if (self._f is None
                or self._records_in_segment >= self.segment_records):
            self._open_segment(version)
        i_s = np.ascontiguousarray(ins_src, np.uint32)
        i_d = np.ascontiguousarray(ins_dst, np.uint32)
        d_s = np.ascontiguousarray(del_src, np.uint32)
        d_d = np.ascontiguousarray(del_dst, np.uint32)
        i_w = (None if ins_w is None
               else np.ascontiguousarray(ins_w, np.float32))
        payload = i_s.tobytes() + i_d.tobytes()
        if i_w is not None:
            payload += i_w.tobytes()
        payload += d_s.tobytes() + d_d.tobytes()
        prefix = _CRC_HEAD.pack(version, len(i_s), len(d_s),
                                0 if i_w is None else 1)
        crc = zlib.crc32(prefix + payload) & 0xFFFFFFFF
        head = _HEAD.pack(_MAGIC, version, len(i_s), len(d_s),
                          0 if i_w is None else 1, crc)
        offset = self._f.tell()
        self._f.write(head + payload)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self._records_in_segment += 1
        self.appended += 1
        _flight.record(_FL_APPEND, version, len(i_s), len(d_s))
        return (self._path, offset)

    def rollback(self, token: Tuple[Path, int]) -> None:
        """Drop the record at ``token`` (the failed-apply compensation:
        called when a dispatch fails AFTER its WAL append, so replay never
        sees a batch the store rejected).  Only the tail record of the
        open segment can roll back."""
        path, offset = token
        if self._f is None or path != self._path:
            return
        self._f.truncate(offset)
        self._f.seek(offset)
        self._records_in_segment = max(0, self._records_in_segment - 1)
        self.appended = max(0, self.appended - 1)
        obs.inc("wal.rollbacks")
        _flight.record(_FL_ROLLBACK, offset)

    def truncate(self, upto_version: int) -> int:
        """Drop whole segments wholly covered by a checkpoint at
        ``upto_version``; returns the number of segments removed.  A
        segment is removable iff a LATER segment starts at or before
        ``upto_version + 1`` (so every record it holds is <= the
        checkpoint)."""
        segs = _segments(self.wal_dir)
        removed = 0
        for i, seg in enumerate(segs):
            covered = any(_segment_version(s) <= upto_version + 1
                          for s in segs[i + 1:])
            if covered and seg != self._path:
                seg.unlink()
                removed += 1
        if removed:
            obs.inc("wal.segments_truncated", removed)
        return removed

    def close(self) -> None:
        self._close_segment()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------

def _intact_prefix(data: bytes) -> Tuple[int, int]:
    """(byte offset after the last intact record, record count)."""
    at = n = 0
    while at + _HEAD.size <= len(data):
        magic, version, n_ins, n_del, has_w, crc = _HEAD.unpack_from(data, at)
        if magic != _MAGIC:
            break
        n_pay = (2 + (1 if has_w else 0)) * 4 * n_ins + 2 * 4 * n_del
        end = at + _HEAD.size + n_pay
        if end > len(data):
            break
        payload = data[at + _HEAD.size:end]
        prefix = _CRC_HEAD.pack(version, n_ins, n_del, has_w)
        if zlib.crc32(prefix + payload) & 0xFFFFFFFF != crc:
            break
        at = end
        n += 1
    return at, n


def read_wal(wal_dir, *, after_version: int = 0
             ) -> Tuple[List[WalRecord], bool]:
    """Every intact record with ``version > after_version``, in order.

    Returns ``(records, torn)`` — ``torn`` is True when a segment ended in
    a torn/corrupt record (the crash-mid-append signature); replay of that
    segment stops there, later segments (appended by a recovered process)
    still load.
    """
    wal_dir = Path(wal_dir)
    records: List[WalRecord] = []
    torn = False
    last_version = after_version
    if not wal_dir.exists():
        return records, torn
    for seg in _segments(wal_dir):
        data = seg.read_bytes()
        intact_end, _ = _intact_prefix(data)
        at = 0
        while at < intact_end:
            _, version, n_ins, n_del, has_w, _ = _HEAD.unpack_from(data, at)
            n_pay = (2 + (1 if has_w else 0)) * 4 * n_ins + 2 * 4 * n_del
            payload = data[at + _HEAD.size:at + _HEAD.size + n_pay]
            at += _HEAD.size + n_pay
            if version <= last_version:
                continue                 # checkpoint-covered or duplicate
            o = 0
            ins_src = np.frombuffer(payload, np.uint32, n_ins, o)
            o += 4 * n_ins
            ins_dst = np.frombuffer(payload, np.uint32, n_ins, o)
            o += 4 * n_ins
            ins_w = None
            if has_w:
                ins_w = np.frombuffer(payload, np.float32, n_ins, o)
                o += 4 * n_ins
            del_src = np.frombuffer(payload, np.uint32, n_del, o)
            o += 4 * n_del
            del_dst = np.frombuffer(payload, np.uint32, n_del, o)
            records.append(WalRecord(version, ins_src, ins_dst, ins_w,
                                     del_src, del_dst))
            last_version = version
        if intact_end < len(data):       # torn/corrupt tail: crash signature
            torn = True
            obs.emit_event("wal_torn_tail", segment=seg.name,
                           offset=intact_end)
    return records, torn


# --------------------------------------------------------------------------
# crash recovery: restore + WAL-suffix replay
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    checkpoint_version: int      # version the restored checkpoint carried
    replayed: int                # WAL records replayed through apply
    final_version: int           # store version after replay
    torn_tail: bool              # WAL ended in a torn record (crash point)
    anomalies: Tuple[str, ...] = ()
    #: the crashed process's post-mortem bundle (``obs.postmortem``), read
    #: back from ``<wal_dir>/postmortem/`` — None when the death was too
    #: sudden to dump (or predates the black box)
    postmortem: Optional[Dict[str, Any]] = None

    @property
    def crash_reason(self) -> Optional[str]:
        """Why the crashed process died, per its own post-mortem."""
        if not self.postmortem:
            return None
        exc = self.postmortem.get("exception") or {}
        reason = self.postmortem.get("reason", "unknown")
        site = exc.get("site")
        return reason if site is None else f"{reason}@{site}"


def recover(ckpt_dir, wal_dir, *, store_cls=None, specs=(), policies=None,
            step: Optional[int] = None, maintenance=None,
            log_capacity: int = 64, wal: Optional[WriteAheadLog] = None,
            device="cuda"):
    """Rebuild ``(store, registry, RecoveryReport)`` after a crash.

    Restores the newest valid checkpoint onto ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; ``store_cls.restore``, by default
    ``GraphStore``), then replays every WAL record past the checkpoint
    version through ``apply``.  With the same ``maintenance`` policy the
    original store ran (its counters are checkpointed), the recovered
    trajectory is bit-identical to the uninterrupted one.  ``wal=``
    re-attaches a live log so the recovered store keeps journaling.
    """
    if store_cls is None:
        from ..stream.store import GraphStore
        store_cls = GraphStore
    # read the crashed process's own account of why it died FIRST, so the
    # recovery log can lead with it (archived after one read — one
    # incident, one report)
    pm = _postmortem.consume_latest(Path(wal_dir) / "postmortem")
    with obs.span("resilience.recover"):
        store, registry = store_cls.restore(
            ckpt_dir, step=step, specs=specs, policies=policies,
            log_capacity=log_capacity, maintenance=maintenance,
            device=device)
        ckpt_version = store.version
        records, torn = read_wal(wal_dir, after_version=ckpt_version)
        anomalies: List[str] = []
        replayed = 0
        for rec in records:
            if rec.version <= store.version:
                continue                 # already covered (maintenance drift)
            store.apply(rec.ins_src, rec.ins_dst, rec.ins_w,
                        rec.del_src, rec.del_dst)
            replayed += 1
            if store.version < rec.version:
                anomalies.append(
                    f"replayed record v{rec.version} but store only "
                    f"reached v{store.version} (maintenance policy "
                    "mismatch vs the crashed process?)")
    if wal is not None:
        store.attach_wal(wal)
    report = RecoveryReport(checkpoint_version=ckpt_version,
                            replayed=replayed,
                            final_version=store.version,
                            torn_tail=torn,
                            anomalies=tuple(anomalies),
                            postmortem=pm)
    obs.emit_event("recovered", checkpoint_version=ckpt_version,
                   replayed=replayed, final_version=store.version,
                   crash_reason=report.crash_reason)
    _flight.record(_FL_RECOVER, store.version, replayed,
                   0 if pm is None else 1)
    return store, registry, report
