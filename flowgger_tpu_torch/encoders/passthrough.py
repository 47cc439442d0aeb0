"""Passthrough encoder: emit record.full_msg verbatim, with the optional
prepend-timestamp header.

Parity model: flowgger src/flowgger/encoder/passthrough_encoder.rs:22-46.
"""

from __future__ import annotations

from . import Encoder, EncodeError, build_prepend_ts, config_get_prepend_ts
from ..config import Config
from ..record import Record


class PassthroughEncoder(Encoder):
    def __init__(self, config: Config):
        self.header_time_format = config_get_prepend_ts(config)

    def encode(self, record: Record) -> bytes:
        if record.full_msg is None:
            raise EncodeError("Cannot output empty raw message")
        out = []
        if self.header_time_format is not None:
            out.append(build_prepend_ts(self.header_time_format))
        out.append(record.full_msg)
        return "".join(out).encode("utf-8")
