"""Size-capped append-only JSONL sink with `.1`-roll rotation (port of
`oryx_tpu.utils.rolling_sink`): the rotation contract of the anomaly
``events.jsonl`` (utils/anomaly.py) and the wide-event ``requests.jsonl``
(utils/request_log.py):

  * append one complete JSON line, then flush — the live file is never
    a torn JSONL;
  * rotate AFTER the write that crossed ``max_bytes``: the crossing
    line lands in ``<path>.1`` with its episode-mates, the fresh file
    starts empty;
  * exactly one rotation generation is kept (``os.replace`` clobbers
    the previous ``.1``), so disk usage stays <= ~2x the cap;
  * ``max_bytes=0`` disables rotation (unbounded append).

An optional ``prologue`` line (a header) is
re-written at the top of every fresh file — including the one a
rotation opens — so a consumer holding only the live file always sees
the sink's self-describing first line.

Thread safety is the CALLER's job: every owner serializes its writes
under its own lock.
"""

from __future__ import annotations

import os


class RollingSink:
    """Append-only line sink over ``path``, rolling to ``<path>.1``
    after the write that crosses ``max_bytes``."""

    def __init__(self, path: str, *, max_bytes: int = 16 * 1024 * 1024,
                 prologue: str | None = None):
        self.path = os.path.abspath(path)
        self.max_bytes = max_bytes
        self._prologue = prologue
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")
        if self._prologue is not None and self._f.tell() == 0:
            self._write_line(self._prologue)

    def set_prologue(self, line: str) -> None:
        """Install (or replace) the fresh-file first line. Written
        immediately when the live file is still empty — the owner may
        only learn its header after constructing the sink."""
        self._prologue = line
        if self._f is not None and self._f.tell() == 0:
            self._write_line(line)

    def _write_line(self, line: str) -> None:
        self._f.write(line + "\n")
        self._f.flush()

    def write(self, line: str) -> None:
        """Append one complete JSON line and flush; rotate after the
        crossing write (the live file is always whole JSONL, the
        crossing line keeps its episode-mates in ``.1``)."""
        if self._f is None:
            raise ValueError(f"sink {self.path} is closed")
        self._write_line(line)
        if self.max_bytes and self._f.tell() >= self.max_bytes:
            self._f.close()
            os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "a")
            if self._prologue is not None:
                self._write_line(self._prologue)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
