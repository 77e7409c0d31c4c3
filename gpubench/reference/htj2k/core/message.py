"""Coded messaging with pluggable sinks.

Mirrors the reference's 3-level messaging architecture
(ojph_message.h:60-292, others/ojph_message.cpp): INFO / WARNING /
ERROR, each with a stable 8-hex message code, routed to either a
stream (``set_*_stream``, None silences) or a user handler
(``configure_*``).  ERROR always raises after reporting.

Code space follows the reference's subsystem prefixes
(0x0001xxxx file-io, 0x0003xxxx codestream, 0x0005xxxx params,
0x0007xxxx resolution, 0x000Bxxxx coding, ...).  Where one of our
checks corresponds to an identifiable reference check we reuse the
reference's exact code (cited at the call site), so tooling keyed on
codes ports across.

``OjphError`` subclasses ValueError so byte-level parsing call sites
keep their conventional ``except ValueError`` contract.
"""
from __future__ import annotations

import sys
import warnings as _pywarnings
from typing import Callable, Optional, TextIO

Handler = Callable[[int, str, int, str], None]


class OjphError(ValueError):
    """Raised by :func:`error`; carries the stable message code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code

    def __str__(self):
        return super().__str__()


class OjphWarning(UserWarning):
    """Category used when warnings are routed through ``warnings``."""


class _Level:
    """One severity level: an output stream or a custom handler."""

    def __init__(self, name: str, stream: Optional[TextIO]):
        self.name = name
        self.stream = stream
        self.handler: Optional[Handler] = None

    def emit(self, code: int, file_name: str, line_num: int, msg: str):
        if self.handler is not None:
            self.handler(code, file_name, line_num, msg)
            return
        if self.stream is not None:
            self.stream.write(
                f'ojph {self.name} 0x{code:08X} at {file_name}:'
                f'{line_num}: {msg}\n')


# default: info/warning silent (the Python idiom is `warnings`, below),
# errors report through the raised exception, not a stream
_info = _Level('info', None)
_warning = _Level('warning', None)
_error = _Level('error', None)

# message levels (OJPH_MSG_LEVEL, ojph_message.h:47-56): messages below
# the global level are suppressed at their sink AND as Python warnings;
# NO_MSG (the highest) silences everything.  Errors always raise
# regardless of level.
ALL_MSG, INFO, WARN, ERROR, NO_MSG = 0, 1, 2, 3, 4
_level = INFO


def set_message_level(level: int) -> None:
    """Suppress messages below ``level`` (set_message_level,
    ojph_message.cpp; used by the reference's truncated-decode tests to
    silence resilient-mode chatter).  ``ERROR`` still raises."""
    global _level
    _level = level


def set_info_stream(s: Optional[TextIO]) -> None:
    """Route info messages to stream ``s`` (e.g. sys.stdout); None
    silences them (set_info_stream, ojph_message.h:135)."""
    _info.stream = s


def set_warning_stream(s: Optional[TextIO]) -> None:
    _warning.stream = s


def set_error_stream(s: Optional[TextIO]) -> None:
    _error.stream = s


def configure_info(handler: Optional[Handler]) -> None:
    """Override info handling with ``handler(code, file, line, msg)``
    (configure_info, ojph_message.h:145)."""
    _info.handler = handler


def configure_warning(handler: Optional[Handler]) -> None:
    _warning.handler = handler


def configure_error(handler: Optional[Handler]) -> None:
    """Override error reporting.  Unlike the reference (where the
    handler must throw), the raise happens after the handler returns —
    an error always terminates the operation."""
    _error.handler = handler


def _caller(depth: int = 2):
    f = sys._getframe(depth)
    return f.f_code.co_filename.rsplit('/', 1)[-1], f.f_lineno


def info(code: int, msg: str) -> None:
    if _level > INFO:
        return
    fn, ln = _caller()
    _info.emit(code, fn, ln, msg)


def warn(code: int, msg: str) -> None:
    """Report a recoverable condition.  Besides the sink, a Python
    ``OjphWarning`` is issued so standard warning filters apply."""
    if _level > WARN:
        return
    fn, ln = _caller()
    _warning.emit(code, fn, ln, msg)
    _pywarnings.warn(f'[0x{code:08X}] {msg}', OjphWarning, stacklevel=2)


def error(code: int, msg: str) -> None:
    """Report and raise.  Never returns."""
    if _level <= ERROR:
        fn, ln = _caller()
        _error.emit(code, fn, ln, msg)
    raise OjphError(code, msg)
