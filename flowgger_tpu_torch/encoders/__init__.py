"""Encoders: Record → output bytes.

Parity model: flowgger src/flowgger/encoder/ — trait
``Encoder { encode(record: Record) -> Result<Vec<u8>> }``
(encoder/mod.rs:54-56).  Encode errors raise ``EncodeError``; the pipeline
drops the message and keeps going, like the reference.
"""

from __future__ import annotations

from ..record import Record


class EncodeError(Exception):
    pass


class Encoder:
    def encode(self, record: Record) -> bytes:
        raise NotImplementedError


from .gelf import GelfEncoder  # noqa: E402
from .ltsv import LTSVEncoder  # noqa: E402

__all__ = ["Encoder", "EncodeError", "GelfEncoder", "LTSVEncoder"]
