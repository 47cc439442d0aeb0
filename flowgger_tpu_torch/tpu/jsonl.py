r"""Columnar JSON-lines decode: the structural index in nested mode.

Scalar spec: flowgger_tpu_torch/decoders/jsonl.py.  Stage 1 is the
structural index (tpu/jsonidx.py) with ``NESTED_DEPTH`` levels of
containers below the top object: top-level container values become
VT_OBJECT / VT_ARRAY spans, deeper rows — and anything structurally
surprising — flag to the scalar oracle.  Stage 2 (host,
tpu/encode_jsonl_block.py and tpu/materialize_jsonl.py) slices the spans.

Two-tier field budget: the batch decodes at ``DEFAULT_MAX_FIELDS``; rows
with more keys, up to ``RESCUE_MAX_FIELDS``, re-dispatch through the
24-field kernel in :func:`decode_jsonl_fetch`, so only rows beyond it
reach the oracle.

On a CUDA batch both tiers launch the hand-written kernel
(``csrc/structural_index.cu``); a batch on the CPU takes the plain
version (:func:`jsonidx.structural_index`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .jsonidx import KEYS_F, structural_index, unpack_channels
from .rfc5424 import rescue_refetch

DEFAULT_MAX_FIELDS = 8
RESCUE_MAX_FIELDS = 24
# containers below the top-level object may nest this many levels
NESTED_DEPTH = 4


def decode_jsonl(batch: torch.Tensor, lens: torch.Tensor,
                 max_fields: int = DEFAULT_MAX_FIELDS
                 ) -> Dict[str, torch.Tensor]:
    """The plain version of the JSON-lines decode (any device)."""
    return structural_index(batch, lens, max_fields, nested=NESTED_DEPTH)


def _decode_on(batch, lens, max_fields):
    """The decode of one batch, left on its device: the CUDA kernel's
    packed ``[C, N]`` int32 tensor for a CUDA batch, the plain version's
    channel dict for a CPU batch."""
    if batch.is_cuda:
        from .kernels import structural_index_cuda

        return structural_index_cuda(batch, lens, max_fields,
                                     nested=NESTED_DEPTH)
    return decode_jsonl(batch, lens, max_fields)


def _to_host(res, max_fields) -> Dict[str, np.ndarray]:
    if isinstance(res, dict):
        return {k: v.cpu().numpy() for k, v in res.items()}
    # one device-to-host copy of the packed channels, split on the host
    return {k: v.numpy() for k, v in
            unpack_channels(res.cpu(), max_fields).items()}


def decode_jsonl_submit(batch: torch.Tensor, lens: torch.Tensor):
    """Launch the decode of one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_jsonl_fetch`."""
    lens = lens.to(torch.int32)
    return (_decode_on(batch, lens, DEFAULT_MAX_FIELDS), batch, lens)


def decode_jsonl_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels; rows
    the 8-field pass rejected with 9-24 keys re-dispatch through the
    24-field kernel, and the field channels come back widened to
    RESCUE_MAX_FIELDS when any row needed it."""
    out, batch, lens = handle
    host = _to_host(out, DEFAULT_MAX_FIELDS)
    nf = host["n_fields"]
    over = np.flatnonzero(~host["ok"] & (nf > DEFAULT_MAX_FIELDS)
                          & (nf <= RESCUE_MAX_FIELDS))

    def dispatch(sub_b, sub_l):
        return _to_host(_decode_on(sub_b, sub_l, RESCUE_MAX_FIELDS),
                        RESCUE_MAX_FIELDS)

    return rescue_refetch(host, batch, lens, over, KEYS_F, dispatch,
                          RESCUE_MAX_FIELDS)


def decode_jsonl_host(batch, lens) -> Dict[str, np.ndarray]:
    """Synchronous submit + fetch."""
    return decode_jsonl_fetch(decode_jsonl_submit(batch, lens))
