"""Deterministic fault injection for the port's serving front.

Faults are declared per *site* — a named choke point the pipeline checks
as it runs — with a deterministic trigger spec (a trimmed copy of the
JAX package's ``utils/faultinject.py``).  Either source merges into one
plan (the environment wins per site):

    [faults]                       # TOML table, values are spec strings
    queue_pressure = "every:3"     # fire on every 3rd check
    tenant_flood = "once:5"        # fire on the 5th check only
                                   # (also first:N, after:N, off)

    FLOWGGER_FAULTS="queue_pressure=every:3,tenant_flood=first:2"

Sites the port checks:

- ``queue_pressure`` — makes the bounded queue (``utils/bounded_queue``)
  and the tenancy fair queue report Full to producers;
- ``tenant_flood`` — makes admission checks of *rate-limited* tenants
  deny as if their token bucket were empty (``tenancy/admission``).

Every other site of the reference's list is refused with a
``ConfigError`` that names the slice of the port that checks it:
``device_decode`` for good (a device or kernel failure ends the port's
run, so there is no degraded batch path for the site to exercise), the
rest until their slice lands.  A site outside the list, or a malformed
spec, raises ``FaultInjectError`` with the reference's words.

Counters are per site, process-wide and thread-safe; numbering is
1-based (``once:1`` fires on the first check).  The module is inert —
one ``None`` test per check — unless a plan is configured.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Tuple

from ..config import ConfigError

ENV_VAR = "FLOWGGER_FAULTS"

KNOWN_SITES = ("device_decode", "input_socket", "sink_write",
               "queue_pressure", "tenant_flood", "peer_partition",
               "host_kill", "coordinator_kill", "roster_corrupt",
               "route_throttle", "spill_io", "sink_ack_loss",
               "control_freeze")

# the sites the port does not check, and why
_UNWIRED = {
    "device_decode": "is not ported: a device or kernel failure ends the "
                     "port's run, so there is no degraded batch path to "
                     "exercise",
    "input_socket": "is wired in a later slice of the port (the "
                    "supervisor, ROADMAP A8.7)",
    "sink_write": "is wired in a later slice of the port (the supervisor, "
                  "ROADMAP A8.7)",
    "peer_partition": "is wired in a later slice of the port (the fleet, "
                      "ROADMAP A8.5)",
    "host_kill": "is wired in a later slice of the port (the fleet, "
                 "ROADMAP A8.5)",
    "coordinator_kill": "is wired in a later slice of the port (the fleet, "
                        "ROADMAP A8.5)",
    "roster_corrupt": "is wired in a later slice of the port (the fleet, "
                      "ROADMAP A8.5)",
    "route_throttle": "is wired in a later slice of the port "
                      "(observability, ROADMAP A8.4)",
    "spill_io": "is wired in a later slice of the port (durability, "
                "ROADMAP A8.3)",
    "sink_ack_loss": "is wired in a later slice of the port (durability, "
                     "ROADMAP A8.3)",
    "control_freeze": "is wired in a later slice of the port (control, "
                      "ROADMAP A8.6)",
}


class FaultInjectError(Exception):
    """Bad fault spec at configure time."""


def _parse_spec(site: str, spec: str) -> Optional[Tuple[str, int]]:
    spec = spec.strip().lower()
    if spec in ("off", "none", ""):
        return None
    kind, _, arg = spec.partition(":")
    if kind not in ("every", "once", "after", "first") or not arg.isdigit():
        raise FaultInjectError(
            f"fault spec for [{site}] must be off|every:N|once:N|after:N|"
            f"first:N, got [{spec}]")
    n = int(arg)
    if n < 1:
        raise FaultInjectError(f"fault spec for [{site}]: N must be >= 1")
    return kind, n


class FaultPlan:
    def __init__(self, specs: Dict[str, str]):
        self._rules: Dict[str, Tuple[str, int]] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        for site, spec in specs.items():
            parsed = _parse_spec(site, spec)
            if parsed is not None:
                self._rules[site] = parsed
                self._counts[site] = 0

    def fire(self, site: str) -> bool:
        """Count one check of ``site``; True when the fault triggers."""
        rule = self._rules.get(site)
        if rule is None:
            return False
        with self._lock:
            self._counts[site] += 1
            n = self._counts[site]
        kind, arg = rule
        if kind == "every":
            return n % arg == 0
        if kind == "once":
            return n == arg
        if kind == "after":
            return n > arg
        return n <= arg  # first:N

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)


_plan: Optional[FaultPlan] = None


def enabled() -> bool:
    return _plan is not None


def fire(site: str) -> bool:
    """One deterministic check of a fault site (1-based numbering)."""
    return _plan is not None and _plan.fire(site)


def count(site: str) -> int:
    """How many times ``site`` was checked under the active plan."""
    return _plan.count(site) if _plan is not None else 0


def reset() -> None:
    """Drop the active plan (tests)."""
    global _plan
    _plan = None


def configure(specs: Dict[str, str]) -> None:
    """Install a plan directly (tests)."""
    global _plan
    _plan = FaultPlan(specs) if specs else None


def configure_from(config) -> None:
    """Pipeline boot: merge the ``[faults]`` config table with the
    ``FLOWGGER_FAULTS`` env (env wins per site).  No sources → inert."""
    specs: Dict[str, str] = {}
    table = config.lookup_table("faults", "[faults] must be a table")
    if table:
        for site, spec in table.items():
            if not isinstance(spec, str):
                raise FaultInjectError(
                    f"[faults] {site} must be a spec string")
            specs[site] = spec
    env = os.environ.get(ENV_VAR, "")
    for part in filter(None, (p.strip() for p in env.split(","))):
        site, eq, spec = part.partition("=")
        if not eq:
            raise FaultInjectError(
                f"{ENV_VAR} entries must look like site=spec, got [{part}]")
        specs[site.strip()] = spec
    for site in specs:
        if site not in KNOWN_SITES:
            # a typo'd site would silently inject nothing
            raise FaultInjectError(
                f"unknown fault site [{site}] (known: "
                f"{', '.join(KNOWN_SITES)})")
    for site, spec in specs.items():
        if site in _UNWIRED and _parse_spec(site, spec) is not None:
            raise ConfigError(f"fault site [{site}] {_UNWIRED[site]}")
    configure(specs)
    if specs:
        print(f"faultinject: active plan {specs}", file=sys.stderr)
