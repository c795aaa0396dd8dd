"""Explain display modes (counterpart of `hyperspace_tpu/plananalysis/display_mode.py`;
reference `DisplayMode.scala:26-89`): plain text (`<---- ---->` highlight
tags), HTML (`<pre>`, bold highlights, `<br/>` lines) and console (ANSI
green background); the tags can be set in the conf."""

from __future__ import annotations

from ..config import IndexConstants, SessionConf
from ..exceptions import HyperspaceException


class DisplayMode:
    new_line = "\n"
    begin_end_tag = ("", "")
    default_highlight = ("", "")

    def __init__(self, conf: SessionConf):
        self.highlight_tag = (
            conf.get(IndexConstants.HIGHLIGHT_BEGIN_TAG, self.default_highlight[0]),
            conf.get(IndexConstants.HIGHLIGHT_END_TAG, self.default_highlight[1]),
        )


class PlainTextMode(DisplayMode):
    default_highlight = ("<----", "---->")


class HTMLMode(DisplayMode):
    new_line = "<br/>"
    begin_end_tag = ("<pre>", "</pre>")
    default_highlight = ('<b style="background: #ff9900">', "</b>")


class ConsoleMode(DisplayMode):
    default_highlight = ("\x1b[42m", "\x1b[0m")


def create_display_mode(conf: SessionConf) -> DisplayMode:
    name = (conf.get(IndexConstants.DISPLAY_MODE) or "plaintext").lower()
    if name == "html":
        return HTMLMode(conf)
    if name == "console":
        return ConsoleMode(conf)
    if name == "plaintext":
        return PlainTextMode(conf)
    raise HyperspaceException(f"Display mode: {name} not supported.")
