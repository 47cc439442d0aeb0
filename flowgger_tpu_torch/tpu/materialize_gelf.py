"""The scalar GELF oracle row: a line the flat structural index flagged,
or one longer than ``input.tpu_max_line_len``, or one outside the block
encoder's tier, decodes through the scalar decoder
(``decoders/gelf.py``), so its bytes and errors are the reference's.

A trimmed copy of the JAX package's ``tpu/materialize_gelf.py``: its
``_scalar_gelf`` (:60, without the reference's ``fallback_rows`` metric:
the port emits no metrics yet) and ``_PARSE_ERR`` (:28).  The
Record-path materializer beside them comes with the Record path
(ROADMAP queue A item 3).  A row without a ``timestamp`` is stamped with
the wall clock here, as the scalar decoder stamps it.
"""

from __future__ import annotations

from ..decoders import DecodeError
from ..decoders.gelf import GelfDecoder
from .materialize import LineResult

# the Record-path materializer's error for a span that does not parse
# (the scalar decoder's own message for a line that does not)
_PARSE_ERR = "Invalid GELF input, unable to parse as a JSON object"
_SCALAR = GelfDecoder()


def _scalar_gelf(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
