"""Leveled logging (port of plviwo_tpu/utils/logging.py; reference:
viw::Print_Logger PRINT0..PRINT4, Print_Logger.h:20-77, with optional
tee-to-file)."""

from __future__ import annotations

import sys
import time

ALL, DEBUG, INFO, WARNING, ERROR, SILENT = range(6)

_level = INFO
_file = None


def set_level(level: int):
    global _level
    _level = level


def open_file(path: str):
    """Tee output to a file (reference: Print_Logger::open_file)."""
    global _file
    _file = open(path, "a")


def close_file():
    global _file
    if _file:
        _file.close()
        _file = None


def _emit(level, tag, msg):
    if level < _level:
        return
    line = f"[{time.strftime('%H:%M:%S')}][{tag}] {msg}"
    print(line, file=sys.stderr if level >= WARNING else sys.stdout)
    if _file:
        _file.write(line + "\n")


def debug(msg):
    _emit(DEBUG, "D", msg)


def info(msg):
    _emit(INFO, "I", msg)


def warning(msg):
    _emit(WARNING, "W", msg)


def error(msg):
    _emit(ERROR, "E", msg)
