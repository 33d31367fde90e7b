"""Typed store errors (reference: src/common/errors.go:5-57)."""

from __future__ import annotations

import enum


class StoreErrType(enum.Enum):
    KEY_NOT_FOUND = "Not Found"
    TOO_LATE = "Too Late"
    PASSED_INDEX = "Passed Index"
    SKIPPED_INDEX = "Skipped Index"
    NO_ROOT = "No Root"
    UNKNOWN_PARTICIPANT = "Unknown Participant"
    EMPTY = "Empty"


class StoreErr(Exception):
    def __init__(self, data_type: str, err_type: StoreErrType, key: str = ""):
        self.data_type = data_type
        self.err_type = err_type
        self.key = key
        super().__init__(f"{data_type}, {key}, {err_type.value}")


def is_store_err(err: BaseException, err_type: StoreErrType) -> bool:
    return isinstance(err, StoreErr) and err.err_type is err_type
