"""Online log structuration: an evolving template tree over decoded
message columns (USTEP style, arxiv 2304.12331; a trimmed copy of the
JAX package's ``tenancy/templates.py``).

The miner clusters each message into a *template* — its token sequence
with variable positions wildcarded — using a fixed-depth search tree:
level 0 groups by token count, levels 1..depth by leading token
(numeric-looking tokens descend the wildcard child, so ``pid=4137``
and ``pid=9001`` share a path), and each leaf holds the templates of
its group.  A message joins the best-matching template when the exact-
token similarity clears ``tenant.template_sim`` (mismatched positions
degrade to ``<*>``), else it seeds a new one.  Insertion order fully
determines the result: two runs over the same corpus produce the same
template set and the same IDs.

This is the first stage that *consumes* the decoded columns: on the
columnar block route the per-row message spans come straight from
the decode kernel's output channels (``extract_block``), with zero
re-parsing on the host — the host path is pinned while mining so the
span channels are actually fetched.  On the Record route the miner
observes ``record.msg``.

Everything is off unless ``tenant.templates = "on"``: ``from_config``
returns None and no handler holds a miner.

The reference's template counters and gauges are a later slice of the
port.

The optional ``tenant.template_enrich`` flag additionally stamps each
GELF record with a ``_template_id`` field — that rides the Record
route (see tpu/batch.py route gating).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import Config, ConfigError
from . import DEFAULT_TENANT

WILDCARD = "<*>"
_MAX_TOKENS = 48          # tokens considered per message
_MAX_MSG_BYTES = 512      # mining window into very long messages

DEFAULT_DEPTH = 4
DEFAULT_SIM = 0.5
DEFAULT_MAX_CHILDREN = 32
DEFAULT_MAX_TEMPLATES = 1024


def _looks_variable(token: str) -> bool:
    """Numeric-bearing tokens descend the wildcard branch so runs of
    ids/timestamps don't fan the tree out."""
    return any(c.isdigit() for c in token)


class TemplateMiner:
    """One tenant's evolving template tree.  Thread-safe; observation
    order determines IDs, so callers that need cross-run stability must
    observe in a deterministic order (the block route does: taps run
    under the lane sequencer, in batch order)."""

    def __init__(self, depth: int = DEFAULT_DEPTH, sim: float = DEFAULT_SIM,
                 max_children: int = DEFAULT_MAX_CHILDREN,
                 max_templates: int = DEFAULT_MAX_TEMPLATES):
        self.depth = max(1, depth)
        self.sim = sim
        self.max_children = max(2, max_children)
        self.max_templates = max_templates
        self._root: Dict = {}
        self._templates: Dict[int, List[str]] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def observe(self, msg) -> int:
        """Cluster one message; returns its template ID (0 = unmined:
        empty message or tenant at its template cap)."""
        if isinstance(msg, (bytes, bytearray, memoryview)):
            msg = bytes(msg[:_MAX_MSG_BYTES]).decode("utf-8", "replace")
        else:
            msg = (msg or "")[:_MAX_MSG_BYTES]
        tokens = msg.split()
        if not tokens:
            return 0
        tokens = tokens[:_MAX_TOKENS]
        with self._lock:
            return self._observe_locked(tokens)

    def _observe_locked(self, tokens: List[str]) -> int:
        # level 0: token count; levels 1..depth: leading tokens
        node = self._root.setdefault(len(tokens), {})
        for tok in tokens[: self.depth]:
            key = WILDCARD if _looks_variable(tok) else tok
            children = node.setdefault("c", {})
            child = children.get(key)
            if child is None:
                if key != WILDCARD and len(children) >= self.max_children:
                    key = WILDCARD  # full fan-out: overflow branch
                    child = children.get(key)
                if child is None:
                    child = children[key] = {}
            node = child
        leaf = node.setdefault("t", [])
        # best exact-token similarity among the leaf's templates
        best, best_sim = None, -1.0
        for entry in leaf:
            tmpl = entry[0]
            same = sum(1 for a, b in zip(tmpl, tokens) if a == b)
            s = same / len(tokens)
            if s > best_sim:
                best, best_sim = entry, s
        if best is not None and best_sim >= self.sim:
            tmpl = best[0]
            for i, tok in enumerate(tokens):
                if tmpl[i] != tok:
                    tmpl[i] = WILDCARD
            return best[1]
        if len(self._templates) >= self.max_templates:
            return 0
        tid = self._next_id
        self._next_id += 1
        tmpl = [WILDCARD if _looks_variable(t) else t for t in tokens]
        leaf.append((tmpl, tid))
        self._templates[tid] = tmpl
        return tid

    def distinct(self) -> int:
        with self._lock:
            return len(self._templates)

    def templates(self) -> Dict[int, str]:
        with self._lock:
            items = [(tid, list(t)) for tid, t in self._templates.items()]
        return {tid: " ".join(t) for tid, t in items}


# per-format block-route message span channels: (start key, end key);
# an end key of None means "to the end of the (clipped) line"
_BLOCK_SPANS = {
    "rfc5424": ("msg_trim_start", "trim_end"),
    "rfc3164": ("msg_start", None),
    "ltsv": ("msg_start", "msg_end"),
    "dns": ("qname_start", "qname_end"),
}


def _extract_jsonl(packed, host_out) -> list:
    """JSON-lines block tap: the ``message`` key has no dedicated
    kernel channel — scan each ok row's key spans for it (field counts
    are small and mining already pins the host path)."""
    chunk, starts, orig_lens = packed[2], packed[3], packed[4]
    n_real = int(packed[5])
    max_len = int(packed[0].shape[1])
    ok = host_out["ok"]
    n_fields = host_out["n_fields"]
    key_s, key_e = host_out["key_start"], host_out["key_end"]
    val_s, val_e = host_out["val_start"], host_out["val_end"]
    val_t = host_out["val_type"]
    msgs: list = []
    for i in range(n_real):
        if not bool(ok[i]):
            msgs.append(None)
            continue
        s = int(starts[i])
        ln = min(int(orig_lens[i]), max_len)
        msg = b""
        for f in range(int(n_fields[i])):
            a, b = int(key_s[i][f]), int(key_e[i][f])
            if chunk[s + a:s + b] == b"message" \
                    and int(val_t[i][f]) == 0:  # VT_STRING
                lo = min(int(val_s[i][f]), ln)
                hi = min(int(val_e[i][f]), ln)
                msg = chunk[s + lo:s + hi] if hi > lo else b""
                break
        msgs.append(msg)
    return msgs


class TemplateMinerSet:
    """Per-tenant miners, shared by the block tap and the Record-route
    hook."""

    def __init__(self, depth: int = DEFAULT_DEPTH, sim: float = DEFAULT_SIM,
                 max_children: int = DEFAULT_MAX_CHILDREN,
                 max_templates: int = DEFAULT_MAX_TEMPLATES,
                 enrich: bool = False, opted_out=()):
        self.depth = depth
        self.sim = sim
        self.max_children = max_children
        self.max_templates = max_templates
        self.enrich = enrich
        # tenants whose [tenants.<name>] spec set templates = false:
        # their rows are never mined (observe returns 0, no counters)
        self.opted_out = frozenset(opted_out)
        self._miners: Dict[str, TemplateMiner] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config: Config) -> Optional["TemplateMinerSet"]:
        mode = config.lookup_str(
            "tenant.templates",
            'tenant.templates must be "on" or "off"', "off")
        if mode not in ("on", "off"):
            raise ConfigError('tenant.templates must be "on" or "off"')
        enrich = config.lookup_bool(
            "tenant.template_enrich",
            "tenant.template_enrich must be a boolean", False)
        if mode != "on":
            if enrich:
                raise ConfigError(
                    'tenant.template_enrich needs tenant.templates = "on"')
            return None
        depth = config.lookup_int(
            "tenant.template_depth",
            "tenant.template_depth must be an integer", DEFAULT_DEPTH)
        sim = config.lookup_float(
            "tenant.template_sim",
            "tenant.template_sim must be a number in (0, 1]", DEFAULT_SIM)
        max_children = config.lookup_int(
            "tenant.template_max_children",
            "tenant.template_max_children must be an integer",
            DEFAULT_MAX_CHILDREN)
        max_templates = config.lookup_int(
            "tenant.template_max_templates",
            "tenant.template_max_templates must be an integer",
            DEFAULT_MAX_TEMPLATES)
        if not (0.0 < sim <= 1.0):
            raise ConfigError("tenant.template_sim must be in (0, 1]")
        if depth < 1 or max_children < 2 or max_templates < 1:
            raise ConfigError(
                "tenant.template_depth/max_children/max_templates must be "
                "positive (max_children >= 2)")
        tenants = config.lookup_table(
            "tenants", "[tenants] must be a table of tenant tables")
        opted_out = tuple(
            name for name, sub in (tenants or {}).items()
            if isinstance(sub, dict) and sub.get("templates") is False)
        return cls(depth=depth, sim=sim, max_children=max_children,
                   max_templates=max_templates, enrich=enrich,
                   opted_out=opted_out)

    def miner(self, tenant: str) -> TemplateMiner:
        with self._lock:
            m = self._miners.get(tenant)
            if m is None:
                m = self._miners[tenant] = TemplateMiner(
                    depth=self.depth, sim=self.sim,
                    max_children=self.max_children,
                    max_templates=self.max_templates)
            return m

    # -- observation -------------------------------------------------------
    def observe_msg(self, tenant: str, msg) -> int:
        """Mine one message for one tenant (0 = unmined: empty message,
        tenant at its cap, or tenant opted out)."""
        if tenant in self.opted_out:
            return 0
        return self.miner(tenant).observe(msg)

    # -- block-route tap ---------------------------------------------------
    def extract_block(self, fmt: str, packed, host_out) -> Optional[list]:
        """Pull per-row message bytes out of one fetched kernel output
        (pure extraction — safe on a concurrent lane fetcher thread;
        observation happens later, in sequenced batch order).  Returns
        None when the format has no mined span channels (gelf/auto)."""
        if fmt == "jsonl":
            if host_out.get("ok") is None:
                return None
            return _extract_jsonl(packed, host_out)
        spans = _BLOCK_SPANS.get(fmt)
        if spans is None:
            return None
        start_key, end_key = spans
        a = host_out.get(start_key)
        ok = host_out.get("ok")
        if a is None or ok is None:
            return None
        chunk, starts, orig_lens = packed[2], packed[3], packed[4]
        n_real = int(packed[5])
        max_len = int(packed[0].shape[1])
        b = host_out.get(end_key) if end_key is not None else None
        msgs: list = []
        for i in range(n_real):
            if not bool(ok[i]):
                msgs.append(None)  # undecodable row: nothing to mine
                continue
            s = int(starts[i])
            ln = min(int(orig_lens[i]), max_len)
            lo = min(int(a[i]), ln)
            hi = min(int(b[i]), ln) if b is not None else ln
            msgs.append(bytes(chunk[s + lo:s + hi]) if hi > lo else b"")
        return msgs

    def observe_rows(self, msgs: Sequence, runs: Optional[List[Tuple[str, int]]]) -> None:
        """Mine one batch's extracted messages, attributed to tenants by
        the ingest-order runs (None, or a count mismatch — e.g. rows the
        pack split differently — attributes the batch to ``default``)."""
        if not msgs:
            return
        if runs is None or sum(n for _, n in runs) != len(msgs):
            runs = [(DEFAULT_TENANT, len(msgs))]
        row = 0
        for tenant, n in runs:
            if n <= 0:
                continue
            if tenant in self.opted_out:
                row += n
                continue
            miner = self.miner(tenant)
            for msg in msgs[row:row + n]:
                if msg is not None:
                    miner.observe(msg)
            row += n


def make_gelf_enricher(miners: TemplateMinerSet):
    """Record hook for the GELF Record route: mines ``record.msg`` and
    stamps the template ID as a ``_template_id`` field (flattened to a
    top-level GELF key by the encoder's SD handling).  ``tenant`` is
    the row's attributed tenant when the caller knows it (the batch
    Record route passes its ingest runs); single-arg callers (the
    per-connection scalar path) fall back to the calling thread's
    tenant tag — the connection's own tenant there."""
    from ..record import SDValue, StructuredData
    from . import current_or_default

    def enrich(record, tenant: Optional[str] = None) -> None:
        tid = miners.observe_msg(tenant or current_or_default(),
                                 record.msg or "")
        sd = StructuredData(None)
        sd.pairs = [("_template_id", SDValue(SDValue.U64, tid))]
        if record.sd is None:
            record.sd = [sd]
        else:
            record.sd = list(record.sd) + [sd]

    return enrich
