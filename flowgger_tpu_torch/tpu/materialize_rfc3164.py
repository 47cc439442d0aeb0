"""The scalar RFC3164 oracle row: a line the rfc3164 kernel flagged, or
one longer than ``input.tpu_max_line_len``, decodes through the scalar
decoder (``decoders/rfc3164.py``), so its bytes and errors are the
reference's.

A trimmed copy of the JAX package's ``tpu/materialize_rfc3164.py``: its
``_scalar_3164``.  The Record-path materializer beside it comes with the
Record path (ROADMAP queue A item 5).
"""

from __future__ import annotations

from ..decoders import DecodeError
from ..decoders.rfc3164 import RFC3164Decoder
from .materialize import LineResult

_SCALAR = RFC3164Decoder()


def _scalar_3164(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
