"""EncodedBlock: a batch of framed, encoded messages in one buffer.

The reference's queue carries one ``Vec<u8>`` per message
(flowgger src/flowgger/mod.rs:461-468) and every sink applies the
merger per message.  For the columnar fast path that per-message hop is
the bottleneck (one queue put + one frame + one write per row), so the
batched pipeline enqueues a single ``EncodedBlock`` per decode batch:
framing is pre-applied by the producer (with the pipeline's own merger,
so the bytes on the wire are identical) and sinks either write ``data``
wholesale (file/tls/debug — byte-stream sinks) or iterate per-message
slices (kafka, rotation-enabled file output) via ``bounds``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class EncodedBlock:
    """A contiguous buffer of framed messages.

    ``data``      — the framed bytes, in input order.
    ``bounds``    — int64 array of n+1 offsets; message i occupies
                    ``data[bounds[i]:bounds[i+1]]`` *including* framing.
    ``prefix_lens`` — per-message framing-prefix length (int64 array) or
                    None when the framing has no prefix.
    ``suffix_len`` — framing suffix length (0, or 1 for line/nul).
    ``ack_cb``    — durability ack hook (or None, the usual case): a
                    replayed spill record's block carries the callback
                    the sink fires once the bytes are flushed/sent
                    (``outputs.ack_item``) — only then does the WAL's
                    replay cursor advance (durability/manager.py).
    """

    __slots__ = ("data", "bounds", "prefix_lens", "suffix_len", "ack_cb")

    def __init__(self, data: bytes, bounds: np.ndarray,
                 prefix_lens: Optional[np.ndarray] = None,
                 suffix_len: int = 0, ack_cb=None):
        self.data = data
        self.bounds = bounds
        self.prefix_lens = prefix_lens
        self.suffix_len = suffix_len
        self.ack_cb = ack_cb

    def __len__(self) -> int:
        return len(self.bounds) - 1

    def iter_framed(self) -> Iterator[bytes]:
        data, b = self.data, self.bounds
        for i in range(len(b) - 1):
            yield data[b[i]:b[i + 1]]

    def iter_unframed(self) -> Iterator[bytes]:
        """Per-message payloads with framing stripped (what a sink that
        ignores framing — kafka — would have received)."""
        data, b, suf = self.data, self.bounds, self.suffix_len
        pre = self.prefix_lens
        for i in range(len(b) - 1):
            start = b[i] + (int(pre[i]) if pre is not None else 0)
            yield data[start:b[i + 1] - suf]
