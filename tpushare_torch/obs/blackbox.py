"""Durable black-box flight journal: telemetry that survives the crash.

The port's copy of ``tpushare/obs/blackbox.py``, frame for frame: a
journal either package writes replays in the other.

Every other observability surface — the flight-recorder ring, the
timeline's tiered series, the profiler windows — is in-process memory:
an OOM-kill erases exactly the evidence the postmortem needs. This
module keeps a bounded, segment-rotated, CRC-framed append-only journal
on disk (``TPUSHARE_BLACKBOX_DIR``) that the marker sites, the timeline
sampler, and completed flight-recorder decisions tee into, so the next
process can replay the tail and show the pre-crash story behind a
``restart`` boundary marker (docs/observability.md §7).

Design constraints, in the obs tradition:

* **fire-and-forget** — :meth:`BlackboxJournal.append` never raises and
  never blocks: records go onto a bounded deque (GIL-atomic append) and
  a background writer drains them; a full queue or any writer trouble
  counts into the drop counter.
* **bounded on disk** — fixed-size segments, oldest deleted past the
  cap; a runaway marker storm can age history out but never fill the
  node's disk.
* **cheap durability** — the writer ``flush()``\\ es to the OS page
  cache per drain (that is what survives a SIGKILL); ``fsync`` is paid
  only on segment rotation and on the explicit SIGTERM/atexit
  :meth:`flush` (power-loss durability without taxing the hot path).
* **torn tails are data** — a record interrupted mid-write fails its
  CRC on replay and truncates that segment's story; every intact frame
  before it is still served.

Frame format: ``<u32 payload length> <u32 crc32(payload)> <payload>``,
payload a compact-JSON object carrying ``t`` (record type: ``marker`` /
``decision`` / ``sample``) and ``ts``.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from collections import deque
from typing import IO, Any, Callable

from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

#: Frame header: little-endian payload length + CRC32 of the payload.
_FRAME = struct.Struct("<II")

#: Segment rotation threshold (TPUSHARE_BLACKBOX_SEGMENT_BYTES).
DEFAULT_SEGMENT_BYTES = 1 * 1024 * 1024
#: Segments kept on disk (TPUSHARE_BLACKBOX_SEGMENTS); the journal's
#: total disk bound is segments x segment bytes.
DEFAULT_MAX_SEGMENTS = 8
#: Bounded intake between emission sites and the writer thread.
QUEUE_DEPTH = 4096
#: Replay refuses frames past this — a corrupt length field must not
#: make the reader allocate gigabytes.
MAX_FRAME_BYTES = 1 * 1024 * 1024

_SEGMENT_PREFIX = "blackbox-"
_SEGMENT_SUFFIX = ".log"

def journal_dir() -> str:
    """The arming switch: a journal exists iff
    ``TPUSHARE_BLACKBOX_DIR`` names a directory."""
    return os.environ.get("TPUSHARE_BLACKBOX_DIR", "")


def _segment_seq(name: str) -> int:
    """The sequence number of a segment file name, or -1."""
    if not (name.startswith(_SEGMENT_PREFIX)
            and name.endswith(_SEGMENT_SUFFIX)):
        return -1
    body = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
    try:
        return int(body)
    except ValueError:
        return -1


def list_segments(directory: str) -> list[str]:
    """Absolute segment paths, oldest first (sequence order — the
    replay order)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    pairs = sorted((seq, name) for name in names
                   if (seq := _segment_seq(name)) >= 0)
    return [os.path.join(directory, name) for _, name in pairs]


def _read_segment(path: str) -> list[dict[str, Any]]:
    """Every intact frame of one segment; a torn or corrupt frame ends
    the segment's story (everything before it is still returned)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    out: list[dict[str, Any]] = []
    off = 0
    while off + _FRAME.size <= len(data):
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if length > MAX_FRAME_BYTES or end > len(data):
            break  # torn tail: the write this frame was died mid-flight
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            break  # corrupt frame: stop trusting this segment
        try:
            doc = json.loads(payload)
        except ValueError:
            break
        if isinstance(doc, dict):
            out.append(doc)
        off = end
    return out


def replay(directory: str) -> list[dict[str, Any]]:
    """All intact records across the journal's segments, oldest first
    — what :func:`tpushare_torch.obs.replay_startup` feeds back into the
    timeline and the flight recorder after a restart."""
    docs: list[dict[str, Any]] = []
    for path in list_segments(directory):
        docs.extend(_read_segment(path))
    return docs


class BlackboxJournal:
    """The bounded on-disk journal: intake deque + writer thread +
    rotating CRC-framed segments.

    Thread model: ``append`` is called from any thread (lock-free
    bounded enqueue, like the timeline's verb buffers); the segment
    file handle and its byte/sequence counters (``_file``, ``_seq``,
    ``_bytes``) are mutated only under ``self._lock`` — held by the
    writer thread per drain and by :meth:`flush` (with a timeout, so a
    SIGTERM flush can never wedge shutdown behind a busy writer).
    """

    def __init__(self, directory: str,
                 segment_bytes: int | None = None,
                 max_segments: int | None = None) -> None:
        self.directory = directory
        self.segment_bytes = (
            segment_bytes if segment_bytes is not None
            else int(os.environ.get("TPUSHARE_BLACKBOX_SEGMENT_BYTES",
                                    str(DEFAULT_SEGMENT_BYTES))))
        self.max_segments = max(1, (
            max_segments if max_segments is not None
            else int(os.environ.get("TPUSHARE_BLACKBOX_SEGMENTS",
                                    str(DEFAULT_MAX_SEGMENTS)))))
        self._lock = locks.TracingRLock("obs/blackbox")
        self._queue: deque[dict[str, Any]] = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._file: IO[bytes] | None = None
        self._seq = 0
        self._bytes = 0
        #: Records lost: full queue, encode failures, write failures.
        self.drops = DropCounter()
        self.frames_written = 0
        self.rotations = 0
        #: Rotation hook (``hook(new_seq)``) — obs wires the
        #: ``journal-rotate`` marker here; failures are drop-counted.
        self.on_rotate: Callable[[int], None] | None = None

    # -- lifecycle -------------------------------------------------------- #

    def start(self) -> bool:
        """Open the next segment after any a previous process left
        behind and arm the writer thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            os.makedirs(self.directory, exist_ok=True)
            last = 0
            for path in list_segments(self.directory):
                last = max(last, _segment_seq(os.path.basename(path)))
            self._open_segment(last + 1)
            try:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="tpushare-blackbox", daemon=True)
                self._thread.start()
            except BaseException:
                self._close_segment()
                raise
        return True

    def stop(self) -> None:
        """Drain, fsync, and close the current segment."""
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        self._wake.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)
        # The writer's finally closed the segment on a clean exit; if
        # the join timed out (wedged disk), closing here would race the
        # writer — the timeout flush path below tolerates that.
        self.flush(timeout=1.0)
        with self._lock:
            if self._file is not None:
                self._close_segment(sync=True)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    # -- intake ------------------------------------------------------------ #

    def append(self, doc: dict[str, Any]) -> None:
        """Fire-and-forget: enqueue one record for the writer. A full
        queue (writer behind) drops the record and counts it — the
        journal must never block or throw into an emission site."""
        try:
            if len(self._queue) >= QUEUE_DEPTH:
                self.drops.inc()
                return
            self._queue.append(doc)
            self._wake.set()
        except Exception:  # noqa: BLE001 - journaling must never reach callers
            self.drops.inc()

    # -- writer ------------------------------------------------------------ #

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                self._drain()
            self._drain()  # final drain: SIGTERM-flushed stragglers
        finally:
            with self._lock:
                if self._file is not None:
                    self._close_segment(sync=True)

    def _drain(self) -> None:
        """Write every queued record, flush to the OS page cache (the
        SIGKILL survival boundary), rotate past the segment cap."""
        wrote = False
        with self._lock:
            while True:
                try:
                    doc = self._queue.popleft()
                except IndexError:
                    break
                if self._file is None:
                    self.drops.inc()
                    continue
                try:
                    payload = json.dumps(
                        doc, separators=(",", ":")).encode()
                    self._file.write(_FRAME.pack(len(payload),
                                                 zlib.crc32(payload)))
                    self._file.write(payload)
                    self._bytes += _FRAME.size + len(payload)
                    self.frames_written += 1
                    wrote = True
                except Exception:  # noqa: BLE001 - a bad record/disk drops
                    self.drops.inc()
            if wrote and self._file is not None:
                try:
                    self._file.flush()
                except OSError:
                    self.drops.inc()
            if self._bytes >= self.segment_bytes and self._file is not None:
                self._rotate()

    def _rotate(self) -> None:
        """Seal the full segment (fsync — rotation is the only hot-path
        fsync), open the next, delete past the cap. Caller holds the
        lock."""
        next_seq = self._seq + 1
        self._close_segment(sync=True)
        # Prune before opening: nothing raise-capable may follow the
        # acquire, or a failed prune would leak the open segment.
        segments = list_segments(self.directory)
        while len(segments) >= self.max_segments:
            try:
                os.unlink(segments.pop(0))
            except OSError:
                self.drops.inc()
                break
        self._open_segment(next_seq)
        self.rotations += 1
        hook = self.on_rotate
        if hook is not None:
            try:
                hook(next_seq)
            except Exception:  # noqa: BLE001 - the hook is telemetry
                self.drops.inc()

    def _open_segment(self, seq: int) -> None:
        """Open segment ``seq`` for append (reentrant: callers already
        hold the lock)."""
        with self._lock:
            path = os.path.join(
                self.directory,
                f"{_SEGMENT_PREFIX}{seq:08d}{_SEGMENT_SUFFIX}")
            self._file = open(path, "ab")
            self._seq = seq
            self._bytes = self._file.tell()

    def _close_segment(self, sync: bool = False) -> None:
        """Flush (+ fsync) and close the open segment. Caller holds the
        lock; idempotent (stop() and the writer's finally may both
        land here)."""
        with self._lock:
            f = self._file
            self._file = None
        if f is None:
            return
        try:
            f.flush()
            if sync:
                os.fsync(f.fileno())
        except OSError:
            self.drops.inc()
        finally:
            f.close()

    # -- flush (SIGTERM / atexit) ------------------------------------------ #

    def flush(self, timeout: float = 1.0) -> bool:
        """Synchronously drain the queue and fsync the segment — the
        SIGTERM/atexit durability point. Returns False (counted) when
        the lock cannot be had within ``timeout``: a flush that cannot
        finish must never wedge shutdown (cmd/main's signal contract)."""
        if not self._lock.acquire(timeout=timeout):
            self.drops.inc()
            return False
        try:
            self._drain()
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except OSError:
                    self.drops.inc()
                    return False
            return True
        finally:
            self._lock.release()

    # -- surface ----------------------------------------------------------- #

    def snapshot(self) -> dict[str, Any]:
        """The ``/debug/blackbox`` journal half: segment inventory and
        writer health."""
        with self._lock:
            seq, open_bytes = self._seq, self._bytes
            running = (self._thread is not None
                       and self._thread.is_alive())
        segments = []
        for path in list_segments(self.directory):
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            segments.append({"name": os.path.basename(path),
                             "bytes": size})
        return {
            "directory": self.directory,
            "running": running,
            "segment": seq,
            "segmentBytes": open_bytes,
            "segmentLimitBytes": self.segment_bytes,
            "maxSegments": self.max_segments,
            "segments": segments,
            "framesWritten": self.frames_written,
            "rotations": self.rotations,
            "queued": len(self._queue),
            "drops": self.drops.value,
        }
