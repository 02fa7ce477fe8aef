"""Logging: printInfo/printError analogs (``support/ppPrint.h:29-39``).

Routed through Python logging so apps can install their own handlers (the
reference optionally routes through spdlog).  ``PUMIPIC_PRINT_ENABLED`` CMake
switch maps to :func:`set_print_enabled`.
"""
from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("pumipic_jax")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(message)s"))
    # cap the stdout handler below ERROR: errors go ONLY to the stderr
    # handler (round-5 review: _err was built but never added, so errors
    # went to stdout unprefixed; adding it without the cap would print
    # every error twice)
    _h.addFilter(lambda rec: rec.levelno < logging.ERROR)
    _logger.addHandler(_h)
    _err = logging.StreamHandler(sys.stderr)
    _err.setFormatter(logging.Formatter("ERROR: %(message)s"))
    _err.setLevel(logging.ERROR)
    _logger.addHandler(_err)
    _logger.setLevel(logging.INFO)

_enabled = True


def set_print_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def print_info(fmt: str, *args) -> None:
    if _enabled:
        _logger.info(fmt % args if args else fmt)


def print_error(fmt: str, *args) -> None:
    if _enabled:
        _logger.error(fmt % args if args else fmt)


def always_assert(cond: bool, msg: str = "") -> None:
    """PP_ALWAYS_ASSERT analog (``support/ppAssert.h``) — host-side."""
    if not cond:
        raise AssertionError(msg or "PP_ALWAYS_ASSERT failed")
