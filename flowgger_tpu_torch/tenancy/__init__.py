"""Multi-tenant serving: per-tenant admission, weighted-fair QoS and
online template mining over the decoded columns (a trimmed copy of the
JAX package's ``tenancy`` package).

- ``registry``  — tenant specs keyed by source listener or peer (the
  ``[tenants]`` config table plus the ``tenant.default_*`` keys);
- ``admission`` — per-tenant token-bucket admission (lines/sec and
  bytes/sec with burst) applied at input-accept, *before* the queue;
- ``fairqueue`` — per-tenant sub-queues with deficit-round-robin
  dequeue and noisiest-tenant-first load shedding under global
  pressure (SHUTDOWN stays unsheddable);
- ``templates`` — an optional evolving template tree mining message
  templates from the decoded columns of each batch.

Everything here is opt-in: with no ``[tenants]`` table and
``tenant.templates`` off, the pipeline builds the same objects it built
before (``PolicyQueue``, bare handlers).

This module stays import-light: the batch handler's ingest only needs
the thread-local tenant tag the admission wrapper sets on each
connection thread.
"""

from __future__ import annotations

import threading
from typing import Optional

DEFAULT_TENANT = "default"

_tls = threading.local()


def set_current(name: Optional[str]) -> None:
    """Tag the calling thread with the tenant whose traffic it carries
    (the admission wrapper; one connection thread serves one tenant).
    ``None`` clears the tag."""
    _tls.tenant = name


def current_name() -> Optional[str]:
    """The calling thread's tenant tag, or None off a tagged thread
    (lane fetcher threads, timers, tests)."""
    return getattr(_tls, "tenant", None)


def current_or_default() -> str:
    name = current_name()
    return DEFAULT_TENANT if name is None else name
