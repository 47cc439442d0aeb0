"""Cap'n Proto encoder.

Parity model: flowgger src/flowgger/encoder/capnp_encoder.rs:36-109 over
the wire format in ``capnp_wire.py``.  Missing facility / severity encode
as 0xff; only the first StructuredData element is representable (schema
limitation, capnp_encoder.rs:78-80); ``[output.capnp_extra]`` static
string pairs land in the ``extra`` list.

A copy of the JAX package's ``encoders/capnp.py``.
"""

from __future__ import annotations

from . import Encoder
from .. import capnp_wire
from ..config import Config, ConfigError
from ..record import Record


class CapnpEncoder(Encoder):
    def __init__(self, config: Config):
        extra_tbl = config.lookup_table(
            "output.capnp_extra", "output.capnp_extra must be a list of key/value pairs"
        )
        self.extra = []
        if extra_tbl is not None:
            for k, v in extra_tbl.items():
                if not isinstance(v, str):
                    raise ConfigError("output.capnp_extra values must be strings")
                self.extra.append((k, v))

    def encode(self, record: Record) -> bytes:
        return capnp_wire.encode_record(record, self.extra)
