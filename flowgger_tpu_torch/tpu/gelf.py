r"""Columnar GELF decode: the structural index in flat mode (BASELINE.json
config #3).

Scalar spec: flowgger_tpu_torch/decoders/gelf.py (reference
gelf_decoder.rs:34-125).  GELF messages are flat JSON objects of scalar
values, so stage 1 is the structural index (tpu/jsonidx.py) at
``nested=0``: any ``[`` or ``]`` outside a string flags the row, and a
nested object or array — like anything structurally surprising — goes
to the scalar oracle.  Stage 2 (host: tpu/encode_gelf_gelf_block.py and
tpu/materialize_gelf.py, or the device tier tpu/device_gelf_gelf.py)
slices the spans.

A trimmed copy of the JAX package's ``tpu/gelf.py``: ``decode_gelf``
(:74), ``decode_gelf_submit`` / ``decode_gelf_fetch`` (:89 / :116) with
the two-tier field budget — the batch decodes at ``DEFAULT_MAX_FIELDS``;
rows with more keys, up to ``RESCUE_MAX_FIELDS``, re-dispatch through
the 24-field decode in :func:`decode_gelf_fetch`, so only rows beyond
it reach the oracle.  The ``VT_*`` value classes come from the port's
own ``jsonidx`` (the reference's host modules reach them through its
JAX-importing ``tpu/gelf.py``; the port's import no JAX).

On a CUDA batch every width launches the hand-written kernel K5 in its
flat mode (``kernels.structural_index_cuda(..., nested=0)``, at 8, 16
and 24 fields); a batch on the CPU takes the plain version
(:func:`jsonidx.structural_index`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .jsonidx import KEYS_F, structural_index
from .jsonl import _to_host
from .rfc5424 import rescue_refetch

DEFAULT_MAX_FIELDS = 8
RESCUE_MAX_FIELDS = 24


def decode_gelf(batch: torch.Tensor, lens: torch.Tensor,
                max_fields: int = DEFAULT_MAX_FIELDS
                ) -> Dict[str, torch.Tensor]:
    """The plain version of the GELF decode (any device): the structural
    index at ``nested=0``, GELF's flat-only contract."""
    return structural_index(batch, lens, max_fields, nested=0)


def decode_on(batch: torch.Tensor, lens: torch.Tensor, max_fields: int):
    """The decode of one batch, left on its device: the CUDA kernel's
    packed ``[C, N]`` int32 tensor for a CUDA batch, the plain version's
    channel dict for a CPU batch."""
    if batch.is_cuda:
        from .kernels import structural_index_cuda

        return structural_index_cuda(batch, lens, max_fields, nested=0)
    return decode_gelf(batch, lens, max_fields)


def decode_gelf_submit(batch: torch.Tensor, lens: torch.Tensor):
    """Launch the decode of one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_gelf_fetch`.  The handle carries
    the batch, so the device tier reads it without a re-upload and the
    rescue slices its rows."""
    lens = lens.to(torch.int32)
    return (decode_on(batch, lens, DEFAULT_MAX_FIELDS), batch, lens)


def decode_gelf_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels; rows
    the 8-field pass rejected with 9-24 keys re-dispatch through the
    24-field decode, and the field channels come back widened to
    RESCUE_MAX_FIELDS when any row needed it."""
    out, batch, lens = handle
    host = _to_host(out, DEFAULT_MAX_FIELDS)
    nf = host["n_fields"]
    over = np.flatnonzero(~host["ok"] & (nf > DEFAULT_MAX_FIELDS)
                          & (nf <= RESCUE_MAX_FIELDS))

    def dispatch(sub_b, sub_l):
        return _to_host(decode_on(sub_b, sub_l, RESCUE_MAX_FIELDS),
                        RESCUE_MAX_FIELDS)

    return rescue_refetch(host, batch, lens, over, KEYS_F, dispatch,
                          RESCUE_MAX_FIELDS)
