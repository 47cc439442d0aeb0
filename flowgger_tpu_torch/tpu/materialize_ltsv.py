"""The scalar LTSV oracle row: a line the ltsv kernel flagged, or one
longer than ``input.tpu_max_line_len``, decodes through the handler's
scalar decoder (``decoders/ltsv.py``, with its schema and suffixes), so
its bytes, errors and "Missing value" notices are the reference's.

A trimmed copy of the JAX package's ``tpu/materialize_ltsv.py``: its
``_scalar_ltsv`` (without the reference's ``fallback_rows`` metric: the
port emits no metrics yet).  The Record-path materializer beside it comes
with the Record path (ROADMAP queue A item 3).
"""

from __future__ import annotations

from ..decoders import DecodeError
from ..decoders.ltsv import LTSVDecoder
from .materialize import LineResult


def _scalar_ltsv(decoder: LTSVDecoder, line: str) -> LineResult:
    try:
        return LineResult(decoder.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
