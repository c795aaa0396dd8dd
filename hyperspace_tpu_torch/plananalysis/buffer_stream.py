"""Explain text assembled under a display mode (counterpart of
`hyperspace_tpu/plananalysis/buffer_stream.py`; reference `BufferStream.scala:23-83`)."""

from __future__ import annotations

from .display_mode import DisplayMode


class BufferStream:
    def __init__(self, mode: DisplayMode):
        self._mode = mode
        self._parts = []

    def write(self, s: str) -> "BufferStream":
        self._parts.append(s)
        return self

    def write_line(self, s: str = "") -> "BufferStream":
        self._parts.append(s + self._mode.new_line)
        return self

    def highlight(self, s: str) -> "BufferStream":
        begin, end = self._mode.highlight_tag
        self._parts.append(begin + s + end)
        return self

    def highlight_line(self, s: str) -> "BufferStream":
        self.highlight(s)
        self._parts.append(self._mode.new_line)
        return self

    def to_string(self) -> str:
        begin, end = self._mode.begin_end_tag
        return begin + "".join(self._parts) + end
