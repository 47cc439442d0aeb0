"""Scalar (per-line) decoders: the exactness oracle for rows the RFC5424,
RFC3164, JSON-lines, LTSV, GELF and DNS kernels flag ``ok=False`` and for lines longer than
``input.tpu_max_line_len``.

Parity model: flowgger src/flowgger/decoder/ — trait
``Decoder { decode(line: &str) -> Result<Record> }`` (decoder/mod.rs:44-46).
Decode errors are raised as ``DecodeError(str)``; the pipeline prints them
to stderr and drops the line (splitter/line_splitter.rs:37-39).
"""

from __future__ import annotations

from ..record import Record


class DecodeError(Exception):
    """Per-message decode failure; message text mirrors the reference's
    ``&'static str`` errors."""


class Decoder:
    def decode(self, line: str) -> Record:
        raise NotImplementedError


from .dns import DNSDecoder  # noqa: E402
from .gelf import GelfDecoder  # noqa: E402
from .jsonl import JSONLDecoder  # noqa: E402
from .ltsv import LTSVDecoder  # noqa: E402
from .rfc3164 import RFC3164Decoder  # noqa: E402
from .rfc5424 import RFC5424Decoder  # noqa: E402

__all__ = ["Decoder", "DecodeError", "DNSDecoder", "GelfDecoder", "JSONLDecoder",
           "LTSVDecoder", "RFC3164Decoder", "RFC5424Decoder"]
