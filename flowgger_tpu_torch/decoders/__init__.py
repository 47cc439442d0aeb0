"""Scalar (per-line) decoders: the scalar input formats' path, and the
exactness oracle for rows the RFC5424, RFC3164, JSON-lines, LTSV, GELF
and DNS kernels flag ``ok=False`` and for lines longer than
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


class InvalidDecoder(Decoder):
    """Placeholder paired with the capnp splitter, which never calls the
    decoder (decoder/invalid_decoder.rs:14-18, mod.rs:413-416)."""

    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        raise RuntimeError("The capnp decoder cannot be used for this input format")


from .dns import DNSDecoder  # noqa: E402
from .gelf import GelfDecoder  # noqa: E402
from .jsonl import JSONLDecoder  # noqa: E402
from .ltsv import LTSVDecoder  # noqa: E402
from .rfc3164 import RFC3164Decoder  # noqa: E402
from .rfc5424 import RFC5424Decoder  # noqa: E402

__all__ = ["Decoder", "DecodeError", "InvalidDecoder", "DNSDecoder",
           "GelfDecoder", "JSONLDecoder", "LTSVDecoder", "RFC3164Decoder",
           "RFC5424Decoder"]
