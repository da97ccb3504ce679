"""JSONL trace files: ``TraceWriter`` / ``TraceReader``.

One JSON object per line, in record order header → submissions → events →
footer (see ``repro.trace.schema`` for the record shapes).  JSONL keeps the
format append-friendly and greppable; the reader is order-insensitive apart
from requiring a header, and rejects unknown schema versions up front.

    TraceWriter("run.trace.jsonl").write(trace)
    trace = TraceReader("run.trace.jsonl").read()

Segmented + streaming export (long-running servers): pass
``segment_records=N`` and the writer treats ``path`` as a *directory* of
rotating JSONL segments (``segment-00000.jsonl``, ``segment-00001.jsonl``,
…), each at most N records.  Segments can be written in one shot
(``write``) or incrementally — ``begin(meta)`` opens the stream and emits
the header, ``add_submission``/``add_event`` append (rotating as needed),
``end(trace)`` emits the footer and closes — so a server exports as it
runs instead of pausing for one big ``finish()`` dump.  ``TraceReader``
reads a segment directory transparently: point it at the directory and it
concatenates ``*.jsonl`` segments in name order.

Columnar events (schema v5): pass ``columnar_events=N`` and events are
written as ``events`` chunk records of up to N events each (parallel column
lists) instead of one record per event — a million-event trace shrinks to
a few hundred lines and parses lazily (``schema.ColumnarEvents``).  In
streaming mode chunking buffers up to N events in memory and flushes a
chunk line at each boundary (and at ``end``), trading the per-record
on-disk-live guarantee for compactness; per-event mode (the default) keeps
the original record-per-line durability.

``dumps_lines``/``loads_lines`` expose the same round-trip on in-memory line
lists (no filesystem), which tests and the serving engine's trace hook use.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Iterable, Iterator, Optional, TextIO

from ..runtime import Event
from .schema import (SubmissionRecord, Trace, TraceSchemaError, event_dict,
                     events_chunk_dict, footer_dict, header_dict,
                     parse_records, submission_dict)

SEGMENT_PATTERN = "segment-*.jsonl"


def _event_chunks(events, size: int) -> Iterator[list[Event]]:
    chunk: list[Event] = []
    for e in events:
        chunk.append(e)
        if len(chunk) >= size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def dumps_lines(trace: Trace, *,
                columnar_events: Optional[int] = None) -> list[str]:
    """Serialize ``trace`` to JSONL lines (no trailing newlines).

    ``columnar_events=N`` writes events as schema-v5 columnar chunk records
    of up to N events each instead of one record per event.
    """
    lines = [json.dumps(header_dict(trace.meta))]
    lines += [json.dumps(submission_dict(s)) for s in trace.submissions]
    if columnar_events is None:
        lines += [json.dumps(event_dict(e)) for e in trace.events]
    else:
        lines += [json.dumps(events_chunk_dict(chunk))
                  for chunk in _event_chunks(trace.events, columnar_events)]
    lines.append(json.dumps(footer_dict(trace)))
    return lines


def loads_lines(lines: Iterable[str]) -> Trace:
    """Parse JSONL lines (blank lines ignored) back into a ``Trace``."""
    records = (json.loads(ln) for ln in lines if ln.strip())
    return parse_records(records)


class TraceWriter:
    """Write a ``Trace`` to a JSONL file, or to rotating JSONL segments.

    ``segment_records=None`` (default): ``path`` is a single file, written
    whole by ``write``.  ``segment_records=N``: ``path`` is a directory of
    rotating segments of at most N records each, usable either via
    ``write`` or via the streaming ``begin``/``add_*``/``end`` protocol.

    ``columnar_events=N`` switches event serialization to schema-v5
    columnar chunks of up to N events per record (lazy-decoded on read).
    In streaming mode events are buffered until a chunk fills (or ``end``
    flushes the remainder) — a chunk counts as one record toward segment
    rotation.
    """

    def __init__(self, path: str | os.PathLike,
                 segment_records: Optional[int] = None,
                 columnar_events: Optional[int] = None):
        if segment_records is not None and segment_records < 1:
            raise ValueError("segment_records must be >= 1")
        if columnar_events is not None and columnar_events < 1:
            raise ValueError("columnar_events must be >= 1")
        self.path = os.fspath(path)
        self.segment_records = segment_records
        self.columnar_events = columnar_events
        self._fh: Optional[TextIO] = None
        self._seg = 0          # next segment index
        self._in_seg = 0       # records in the open segment
        self._chunk: list[Event] = []   # buffered events (columnar mode)
        self.records_written = 0

    # -- one-shot ------------------------------------------------------------
    def write(self, trace: Trace) -> str:
        """Write ``trace`` whole; returns the file (or directory) path."""
        if self.segment_records is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as fh:
                for ln in dumps_lines(trace,
                                      columnar_events=self.columnar_events):
                    fh.write(ln + "\n")
            return self.path
        self.begin(trace.meta)
        for s in trace.submissions:
            self.add_submission(s)
        self.add_events(trace.events)
        self.end(trace)
        return self.path

    # -- streaming -----------------------------------------------------------
    def begin(self, meta: dict[str, Any]) -> "TraceWriter":
        """Open the stream and write the header record (segmented mode)."""
        if self.segment_records is None:
            raise RuntimeError("streaming export needs segment_records=N "
                               "(single-file mode is one-shot write() only)")
        if self._fh is not None or self._seg:
            raise RuntimeError("TraceWriter stream already begun; "
                               "use one writer per run")
        os.makedirs(self.path, exist_ok=True)
        self._append(header_dict(meta))
        return self

    def add_submission(self, s: SubmissionRecord) -> None:
        self._append(submission_dict(s))

    def add_event(self, e: Event) -> None:
        if self.columnar_events is None:
            self._append(event_dict(e))
            return
        self._chunk.append(e)
        if len(self._chunk) >= self.columnar_events:
            self._flush_chunk()

    def add_events(self, events: Iterable[Event]) -> None:
        """Append a whole event sequence (chunked when columnar)."""
        for e in events:
            self.add_event(e)

    def _flush_chunk(self) -> None:
        if self._chunk:
            self._append(events_chunk_dict(self._chunk))
            self._chunk = []

    def end(self, trace: Trace) -> str:
        """Write the footer (taken from ``trace``) and close the stream."""
        self._flush_chunk()
        self._append(footer_dict(trace))
        self._fh.close()
        self._fh = None
        return self.path

    def _append(self, record: dict[str, Any]) -> None:
        if self._fh is None or self._in_seg >= self.segment_records:
            if self._fh is not None:
                self._fh.close()
            name = os.path.join(self.path, f"segment-{self._seg:05d}.jsonl")
            # repro: allow[hook-purity] sanctioned streaming-export sink: the submit hook writes records out, it never reads anything back into a decision
            self._fh = open(name, "w", encoding="utf-8")
            self._seg += 1
            self._in_seg = 0
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()       # stream contract: records are on disk live
        self._in_seg += 1
        self.records_written += 1


class TraceReader:
    """Read a JSONL trace back in — a single file or a segment directory.

    A directory path is read as rotating segments: every
    ``segment-*.jsonl`` inside is concatenated in name order (the writer's
    zero-padded segment names sort chronologically), so segmented and
    single-file traces are interchangeable to callers.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)

    def _lines(self) -> Iterator[str]:
        if os.path.isdir(self.path):
            segments = sorted(glob.glob(os.path.join(self.path,
                                                     SEGMENT_PATTERN)))
            if not segments:
                raise TraceSchemaError(
                    f"no {SEGMENT_PATTERN} segments in directory "
                    f"{self.path!r}")
            for seg in segments:
                with open(seg, "r", encoding="utf-8") as fh:
                    yield from fh
        else:
            with open(self.path, "r", encoding="utf-8") as fh:
                yield from fh

    def read(self) -> Trace:
        return loads_lines(self._lines())
