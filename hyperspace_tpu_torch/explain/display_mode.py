"""Explain output display modes.

A copy of the JAX package's `explain/display_mode.py`
(index/plananalysis/DisplayMode.scala:24-89 of the reference): the explain
text renders in three modes, each defining how differing plan fragments
are highlighted and how lines are terminated:

- plaintext: highlight with `<----` suffix markers;
- console: ANSI reverse-video highlight;
- html: <b>/</b>-style tags (overridable via conf), newlines as <br/>.

Selected via conf key `hyperspace.explain.displayMode`.
"""

from __future__ import annotations

from hyperspace_tpu_torch.config import (  # noqa: F401  (re-exports)
    EXPLAIN_DISPLAY_MODE,
    EXPLAIN_HIGHLIGHT_BEGIN,
    EXPLAIN_HIGHLIGHT_END,
)


class DisplayMode:
    name = "base"
    newline = "\n"

    def highlight(self, line: str) -> str:
        raise NotImplementedError

    def finalize(self, text: str) -> str:
        return text


class PlainTextMode(DisplayMode):
    """Append a trailing marker to highlighted lines."""

    name = "plaintext"

    def highlight(self, line: str) -> str:
        return f"{line} <----"


class ConsoleMode(DisplayMode):
    """ANSI reverse video for highlighted lines."""

    name = "console"

    def highlight(self, line: str) -> str:
        return f"\x1b[7m{line}\x1b[27m"


class HTMLMode(DisplayMode):
    """Tag-wrapped highlights; tags overridable for notebook environments."""

    name = "html"
    newline = "<br/>"

    def __init__(self, begin_tag: str = "<b>", end_tag: str = "</b>"):
        self.begin_tag = begin_tag
        self.end_tag = end_tag

    def highlight(self, line: str) -> str:
        return f"{self.begin_tag}{line}{self.end_tag}"

    def finalize(self, text: str) -> str:
        # <pre> wrapper as in the reference (DisplayMode.scala) — without
        # it HTML collapses the leading-space indentation that carries the
        # plan-tree structure.
        return "<pre>" + text.replace("\n", self.newline) + "</pre>"


def display_mode_from_conf(conf) -> DisplayMode:
    name = "plaintext"
    if conf is not None:
        name = str(conf.get(EXPLAIN_DISPLAY_MODE, "plaintext")).lower()
    if name == "console":
        return ConsoleMode()
    if name == "html":
        begin, end = "<b>", "</b>"
        if conf is not None:
            begin = conf.get(EXPLAIN_HIGHLIGHT_BEGIN, begin)
            end = conf.get(EXPLAIN_HIGHLIGHT_END, end)
        return HTMLMode(begin, end)
    if name == "plaintext":
        return PlainTextMode()
    # Surface misconfiguration immediately (the reference's getDisplayMode
    # is an exhaustive match that errors on unknown values).
    raise ValueError(
        f"unknown {EXPLAIN_DISPLAY_MODE} value {name!r}; "
        "expected plaintext | console | html"
    )
