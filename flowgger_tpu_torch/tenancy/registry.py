"""Tenant registry: specs from config, peer → tenant resolution (a copy
of the JAX package's ``tenancy/registry.py``).

Tenants are declared as ``[tenants.<name>]`` tables; the ``[tenant]``
table holds the defaults every spec inherits (and the catch-all
``default`` tenant uses):

    [tenant]
    default_rate = 0            # lines/sec admitted; 0 = unlimited
    default_byte_rate = 0       # bytes/sec admitted; 0 = unlimited
    default_burst = 0           # bucket depth, lines; 0 = 2x rate
    default_byte_burst = 0      # bucket depth, bytes; 0 = 2x byte rate
    default_weight = 1          # weighted-fair dequeue share
    default_queue_policy = "block"   # per-tenant overflow policy

    [tenants.alpha]
    peers = ["10.0.0.0/8", "192.0.2.7"]   # CIDR, exact IP, or exact
                                          # source label (file path)
    rate = 50000
    weight = 4
    queue_policy = "drop_oldest"

Resolution is first-match in declaration order; unmatched peers (and
peerless inputs: stdin, redis) land on the ``default`` tenant.  A
``[tenants.default]`` entry customizes the catch-all itself.

The registry is the enablement switch for the whole tenancy layer:
``from_config`` returns None when no ``[tenants]`` table and no
``tenant.default_*`` rate key is present, and the pipeline then builds
the exact pre-tenancy objects (no admission wrapper, PolicyQueue).
"""

from __future__ import annotations

import ipaddress
from typing import Dict, List, Optional, Tuple

from ..config import Config, ConfigError
from ..utils.bounded_queue import POLICIES
from . import DEFAULT_TENANT

_SPEC_KEYS = frozenset((
    "peers", "rate", "byte_rate", "burst", "byte_burst", "weight",
    "queue_policy", "templates",
))


class TenantSpec:
    __slots__ = ("name", "peers", "rate", "byte_rate", "burst",
                 "byte_burst", "weight", "queue_policy", "templates")

    def __init__(self, name: str, peers: List[str], rate: int,
                 byte_rate: int, burst: int, byte_burst: int, weight: int,
                 queue_policy: str, templates: bool):
        self.name = name
        self.peers = peers
        self.rate = rate
        self.byte_rate = byte_rate
        # bucket depth defaults to two seconds of the sustained rate so
        # a fresh connection can burst without tripping admission
        self.burst = burst if burst > 0 else 2 * rate
        self.byte_burst = byte_burst if byte_burst > 0 else 2 * byte_rate
        self.weight = weight
        self.queue_policy = queue_policy
        self.templates = templates

    @property
    def limited(self) -> bool:
        return self.rate > 0 or self.byte_rate > 0


def _spec_int(table: dict, name: str, key: str, default: int) -> int:
    v = table.get(key, default)
    if isinstance(v, bool) or not isinstance(v, int) or v < 0:
        raise ConfigError(
            f"[tenants.{name}] {key} must be a non-negative integer")
    return v


class TenantRegistry:
    """Parsed tenant specs plus the peer matchers.

    Admission state (token buckets, per-tenant counters) lives in
    ``admission.TenantState`` objects built once per tenant here, so
    every connection of one tenant shares one pair of buckets.
    """

    def __init__(self, specs: "Dict[str, TenantSpec]", default: TenantSpec,
                 clock=None):
        from .admission import TenantState

        self.specs = specs
        self.default = default
        # ordered matchers — resolution is first match in declaration
        # order, so a broad CIDR declared before an exact IP wins for
        # that IP (the docstring's contract).  _exact is a fast path
        # used only when no CIDR/"*" entry exists.
        self._matchers: List[Tuple[str, object, str]] = []
        self._exact: Dict[str, str] = {}
        for name, spec in specs.items():
            for peer in spec.peers:
                if peer == "*":
                    self._matchers.append(("star", None, name))
                    continue
                try:
                    net = ipaddress.ip_network(peer, strict=False)
                except ValueError:
                    # not an address: exact source label (file path,
                    # unix peer name)
                    self._matchers.append(("label", peer, name))
                    self._exact.setdefault(peer, name)
                    continue
                if net.num_addresses == 1:
                    addr = str(net.network_address)
                    self._matchers.append(("label", addr, name))
                    self._exact.setdefault(addr, name)
                else:
                    self._matchers.append(("net", net, name))
        self._exact_only = all(k == "label" for k, _, _ in self._matchers)
        self._states: Dict[str, TenantState] = {
            name: TenantState(spec, clock=clock)
            for name, spec in specs.items()
        }
        if DEFAULT_TENANT not in self._states:
            self._states[DEFAULT_TENANT] = TenantState(default, clock=clock)

    # -- config ------------------------------------------------------------
    @classmethod
    def from_config(cls, config: Config,
                    fallback_policy: str = "block",
                    clock=None) -> Optional["TenantRegistry"]:
        table = config.lookup_table(
            "tenants", "[tenants] must be a table of tenant tables")
        d_rate = config.lookup_int(
            "tenant.default_rate",
            "tenant.default_rate must be an integer (lines/sec)", 0)
        d_byte_rate = config.lookup_int(
            "tenant.default_byte_rate",
            "tenant.default_byte_rate must be an integer (bytes/sec)", 0)
        d_burst = config.lookup_int(
            "tenant.default_burst",
            "tenant.default_burst must be an integer (lines)", 0)
        d_byte_burst = config.lookup_int(
            "tenant.default_byte_burst",
            "tenant.default_byte_burst must be an integer (bytes)", 0)
        d_weight = config.lookup_int(
            "tenant.default_weight",
            "tenant.default_weight must be a positive integer", 1)
        d_policy = config.lookup_str(
            "tenant.default_queue_policy",
            'tenant.default_queue_policy must be "block", "drop_newest" '
            'or "drop_oldest"', fallback_policy)
        if table is None and not (d_rate or d_byte_rate):
            # tenancy off: the pipeline keeps its pre-tenancy objects
            return None
        if d_weight < 1:
            raise ConfigError("tenant.default_weight must be >= 1")
        if d_policy not in POLICIES:
            raise ConfigError(
                'tenant.default_queue_policy must be "block", '
                '"drop_newest" or "drop_oldest"')
        if any(v < 0 for v in (d_rate, d_byte_rate, d_burst, d_byte_burst)):
            raise ConfigError("tenant.default_* rates must be >= 0")

        def build(name: str, sub: dict) -> TenantSpec:
            unknown = set(sub) - _SPEC_KEYS
            if unknown:
                raise ConfigError(
                    f"[tenants.{name}] unknown key(s): "
                    f"{', '.join(sorted(unknown))} "
                    f"(known: {', '.join(sorted(_SPEC_KEYS))})")
            peers = sub.get("peers", [])
            if (not isinstance(peers, list)
                    or any(not isinstance(p, str) for p in peers)):
                raise ConfigError(
                    f"[tenants.{name}] peers must be a list of strings")
            policy = sub.get("queue_policy", d_policy)
            if policy not in POLICIES:
                raise ConfigError(
                    f'[tenants.{name}] queue_policy must be "block", '
                    '"drop_newest" or "drop_oldest"')
            templates = sub.get("templates", True)
            if not isinstance(templates, bool):
                raise ConfigError(
                    f"[tenants.{name}] templates must be a boolean")
            weight = _spec_int(sub, name, "weight", d_weight)
            if weight < 1:
                raise ConfigError(f"[tenants.{name}] weight must be >= 1")
            return TenantSpec(
                name, peers,
                rate=_spec_int(sub, name, "rate", d_rate),
                byte_rate=_spec_int(sub, name, "byte_rate", d_byte_rate),
                burst=_spec_int(sub, name, "burst", d_burst),
                byte_burst=_spec_int(sub, name, "byte_burst", d_byte_burst),
                weight=weight, queue_policy=policy, templates=templates)

        specs: Dict[str, TenantSpec] = {}
        for name, sub in (table or {}).items():
            if not isinstance(sub, dict):
                raise ConfigError(
                    f"[tenants.{name}] must be a table")
            specs[name] = build(name, sub)
        default = specs.get(DEFAULT_TENANT) or TenantSpec(
            DEFAULT_TENANT, [], rate=d_rate, byte_rate=d_byte_rate,
            burst=d_burst, byte_burst=d_byte_burst, weight=d_weight,
            queue_policy=d_policy, templates=True)
        return cls(specs, default, clock=clock)

    # -- resolution --------------------------------------------------------
    def resolve_name(self, peer: Optional[str]) -> str:
        """Tenant name for a source peer (IP, file path, or None for
        peerless inputs): first match in declaration order."""
        if peer is None:
            return DEFAULT_TENANT
        if self._exact_only:
            return self._exact.get(peer, DEFAULT_TENANT)
        try:
            addr = ipaddress.ip_address(peer)
        except ValueError:
            addr = None
        for kind, value, name in self._matchers:
            if kind == "star":
                return name
            if kind == "label":
                if peer == value:
                    return name
            elif addr is not None and addr in value:
                return name
        return DEFAULT_TENANT

    def resolve(self, peer: Optional[str]):
        return self._states[self.resolve_name(peer)]

    def state(self, name: str):
        """Admission/QoS state for a tenant name (the default tenant's
        state for unknown names, so queue attribution can never miss)."""
        return self._states.get(name) or self._states[DEFAULT_TENANT]

    def states(self):
        return self._states.values()

    def spec(self, name: str) -> TenantSpec:
        return self.specs.get(name, self.default)
