"""Typed error/warning handling with process exit codes.

Mirrors the reference's envs/error_handler.rs:5-45 (10 codes, error()
prints and exits with the code; warning() prints when verbosity >= 2).
"""

from __future__ import annotations

import sys

from . import logging as msg

ERR_UNKNOWN_MODULE = 0x01
ERR_ARGPARSE = 0x02
ERR_FILE_NOT_FOUND = 0x03
ERR_BINARY_NOT_FOUND = 0x04
ERR_MODULE_NOT_IMPLEMENTED = 0x05
ERR_GENERAL = 0x10
ERR_FILE_CREATE = 0x20
ERR_FILE_WRITE = 0x30
ERR_DB_INVALID = 0x40
ERR_INTERRUPTED = 0x50

WRN_GENERAL = 0x01

_NAMES = {
    ERR_UNKNOWN_MODULE: "Unknown module",
    ERR_ARGPARSE: "Argument parsing error",
    ERR_FILE_NOT_FOUND: "File not found",
    ERR_BINARY_NOT_FOUND: "Engine not available",
    ERR_MODULE_NOT_IMPLEMENTED: "Module not implemented",
    ERR_GENERAL: "Error",
    ERR_FILE_CREATE: "Could not create file",
    ERR_FILE_WRITE: "Could not write file",
    ERR_DB_INVALID: "Invalid database",
    ERR_INTERRUPTED: "Interrupted",
}


class UnicoreError(SystemExit):
    def __init__(self, code: int, message: str | None = None):
        self.err_code = code
        self.message = build_message(code, message)
        super().__init__(code)


def build_message(code: int, message: str | None) -> str:
    base = _NAMES.get(code, "Error")
    return f"{base}: {message}" if message else base


def error(code: int, message: str | None = None) -> "NoReturn":  # noqa: F821
    msg.eprintln_message(build_message(code, message), 1)
    raise UnicoreError(code, message)


def warning(code: int, message: str | None = None) -> None:
    msg.eprintln_message("Warning: " + build_message(code, message), 2)
