"""Fleet metric federation: one scrape shows the whole world.

A federated world (doc/federation.md, doc/global_control.md) runs G
gateway processes, each with its own /metrics — until now an operator
summed G scrapes by hand to answer "how many messages is the FLEET
doing". Spider folds cross-node health digestion into the replication
plane itself and CheetahGIS argues fleet-level load visibility is what
makes streaming partitioning operable (PAPERS.md); this module does
the same with machinery we already have:

- **Digests ride the existing control epoch.** Every
  ``global_epoch_ms`` each gateway attaches a compact metric digest to
  the ``TrunkLoadReportMessage`` it already exports
  (federation/control.py): the curated counter families below (full
  label sets), a few summable gauges, and fixed-bucket histogram
  sketches. No extra messages, no extra connections.
- **Sketches merge exactly.** Counters add; histogram sketches share
  the code-pinned bucket edges of their source families, so merging is
  element-wise addition — the fleet view equals the sum of the
  per-gateway ledgers *exactly* (property-tested in
  tests/test_slo.py), not approximately.
- **Any gateway answers for the fleet.** ``/fleet``
  (core/opshttp.py) renders the merged families with a ``fleet_``
  prefix plus per-gateway health summaries
  (``fleet_gateway_up/_overload_level/_pressure/_entities/_cells``),
  the leader annotation (``fleet_leader``), and the shard map
  (``fleet_shard_block`` / ``fleet_shard_override``) — so one
  Prometheus job scraping one gateway sees every gateway, and a dead
  gateway shows as ``fleet_gateway_up 0`` with its last-known digest
  aged out.

Unfederated gateways serve /fleet too (a fleet of one — the same
dashboards work from the first process). Armed with the SLO plane
(``-slo``); disabled, the digest attach is one attribute load.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..utils.logger import get_logger

logger = get_logger("federation.obs")

# Counter families federated with their full label sets. Curated (not
# the whole registry) to keep the per-epoch digest compact; exactness
# holds per family by construction.
FLEET_COUNTERS = (
    "messages_in", "messages_out", "packets_in", "packets_out",
    "bytes_in", "bytes_out", "packets_drop",
    "handovers", "federation_handover", "redirects",
    "overload_sheds", "slo_breaches", "trace_dumps",
    "global_migrations", "gateway_adoptions", "gateway_deaths",
    "wal_records", "resurrection",
)
# Gauges whose fleet reading is the plain sum.
FLEET_SUM_GAUGES = (
    "connection_num", "channel_num", "tpu_entities", "asyncio_tasks",
)
# Histograms federated as fixed-bucket sketches (merge = element-wise
# add; edges are code-pinned in core/metrics.py).
FLEET_HISTS = (
    "delivery_latency_ms", "trunk_rtt_ms", "wal_fsync_ms",
)

# A stored digest older than this many seconds renders as a DOWN
# gateway (fleet_gateway_up 0); its counters still merge — totals must
# not dip just because a gateway died.
DIGEST_STALE_S = 10.0


def _label_key(labels: dict) -> str:
    return json.dumps(sorted(labels.items()), separators=(",", ":"))


def build_local_digest() -> dict:
    """The local registry's curated slice, in the exact-merge shape:
    ``{"counters": {family: {label_key: value}}, "gauges": {...},
    "hists": {family: {label_key: {"bucket": {le: cum}, "sum": s,
    "count": n}}}}``."""
    from ..core import metrics

    counters: dict[str, dict] = {f: {} for f in FLEET_COUNTERS}
    gauges: dict[str, dict] = {f: {} for f in FLEET_SUM_GAUGES}
    hists: dict[str, dict] = {f: {} for f in FLEET_HISTS}
    for family in metrics.registry.collect():
        if family.name in counters:
            out = counters[family.name]
            for s in family.samples:
                if s.name == family.name + "_total":
                    out[_label_key(dict(s.labels))] = s.value
        elif family.name in gauges:
            out = gauges[family.name]
            for s in family.samples:
                if s.name == family.name:
                    out[_label_key(dict(s.labels))] = s.value
        elif family.name in hists:
            out = hists[family.name]
            for s in family.samples:
                labels = dict(s.labels)
                le = labels.pop("le", None)
                key = _label_key(labels)
                entry = out.setdefault(
                    key, {"bucket": {}, "sum": 0.0, "count": 0.0})
                if s.name == family.name + "_bucket" and le is not None:
                    entry["bucket"][le] = s.value
                elif s.name == family.name + "_sum":
                    entry["sum"] = s.value
                elif s.name == family.name + "_count":
                    entry["count"] = s.value
    return {"counters": counters, "gauges": gauges, "hists": hists}


def merge_digests(digests: list[dict]) -> dict:
    """Element-wise exact merge: the fleet families equal the sum of
    the per-gateway ledgers (sketch edges are identical by
    construction, so histogram merge is plain addition)."""
    merged = {"counters": {}, "gauges": {}, "hists": {}}
    for d in digests:
        for family, rows in d.get("counters", {}).items():
            out = merged["counters"].setdefault(family, {})
            for key, v in rows.items():
                out[key] = out.get(key, 0.0) + v
        for family, rows in d.get("gauges", {}).items():
            out = merged["gauges"].setdefault(family, {})
            for key, v in rows.items():
                out[key] = out.get(key, 0.0) + v
        for family, rows in d.get("hists", {}).items():
            out = merged["hists"].setdefault(family, {})
            for key, entry in rows.items():
                acc = out.setdefault(
                    key, {"bucket": {}, "sum": 0.0, "count": 0.0})
                for le, v in entry.get("bucket", {}).items():
                    acc["bucket"][le] = acc["bucket"].get(le, 0.0) + v
                acc["sum"] += entry.get("sum", 0.0)
                acc["count"] += entry.get("count", 0.0)
    return merged


def _esc(value) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline) — one odd gateway id or label value must not invalidate
    the whole /fleet scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(key: str, extra: Optional[dict] = None) -> str:
    pairs = [(k, v) for k, v in json.loads(key)]
    if extra:
        pairs.extend(extra.items())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _valid_digest(digest) -> bool:
    """Structural check for a peer digest: each section is a dict of
    family -> {label_key: number} (hists: {label_key: {bucket: {edge:
    number}, sum: number, count: number}})."""
    if not isinstance(digest, dict):
        return False
    num = (int, float)
    for section in ("counters", "gauges"):
        fams = digest.get(section, {})
        if not isinstance(fams, dict):
            return False
        for rows in fams.values():
            if not isinstance(rows, dict):
                return False
            if not all(isinstance(v, num) for v in rows.values()):
                return False
    hists = digest.get("hists", {})
    if not isinstance(hists, dict):
        return False
    for rows in hists.values():
        if not isinstance(rows, dict):
            return False
        for entry in rows.values():
            if not isinstance(entry, dict):
                return False
            if not isinstance(entry.get("bucket", {}), dict):
                return False
            if not all(isinstance(v, num)
                       for v in entry.get("bucket", {}).values()):
                return False
            if not isinstance(entry.get("sum", 0.0), num) \
                    or not isinstance(entry.get("count", 0.0), num):
                return False
    return True


class FleetObs:
    """Process-wide fleet aggregator (one instance: ``fleet``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # gateway id -> (digest dict, stored monotonic time). Written
        # from the trunk reader (store_peer: a peer's digest arrived)
        # AND the ops HTTP thread (refresh_local via a stale /fleet):
        # every write is one GIL-atomic whole-entry store (the inner
        # digest is never mutated in place), and every reader snapshots
        # with dict()/list() first (doc/concurrency.md).
        self.digests: dict[str, tuple[dict, float]] = {}  # tpulint: shared=atomic
        self._local_refreshed = 0.0  # tpulint: shared=atomic

    # ---- intake ----------------------------------------------------------

    def local_id(self) -> str:
        from .directory import directory

        return directory.local_id or "local"

    def refresh_local(self) -> dict:
        """Rebuild the local digest (each control epoch; /fleet also
        refreshes when the local copy is stale so an unfederated
        gateway needs no epoch loop)."""
        digest = build_local_digest()
        self.digests[self.local_id()] = (digest, time.monotonic())
        self._local_refreshed = time.monotonic()
        return digest

    def attach_digest(self, msg) -> None:
        """Stamp the local digest onto an outbound TrunkLoadReportMessage
        (federation/control.py _export)."""
        msg.metricsJson = json.dumps(
            self.refresh_local(), separators=(",", ":")).encode()

    def store_peer(self, gateway_id: str, metrics_json: bytes) -> None:
        """A peer's digest arrived on its load report. Shape-validated
        before storing: digests are never evicted, so one malformed
        digest from a version-skewed peer would otherwise break every
        later /fleet merge on this gateway until restart."""
        if not metrics_json:
            return
        try:
            digest = json.loads(metrics_json)
        except ValueError:
            logger.warning("undecodable metric digest from %s", gateway_id)
            return
        if not _valid_digest(digest):
            logger.warning("malformed metric digest from %s dropped "
                           "(version skew?)", gateway_id)
            return
        self.digests[gateway_id] = (digest, time.monotonic())

    def drop_peer(self, gateway_id: str) -> None:
        self.digests.pop(gateway_id, None)

    # ---- rendering -------------------------------------------------------

    def _fresh_local(self) -> None:
        if time.monotonic() - self._local_refreshed > 1.0:
            self.refresh_local()

    def merged(self) -> dict:
        self._fresh_local()
        # Snapshot first: the ops HTTP handler renders from its own
        # thread while the event loop's store_peer may insert a newly
        # joined gateway mid-iteration.
        return merge_digests([d for d, _ in list(self.digests.values())])

    def render_prometheus(self) -> str:
        """The /fleet exposition: merged ``fleet_*`` families +
        per-gateway health + leader + shard map."""
        from .control import control
        from .directory import directory

        self._fresh_local()
        now = time.monotonic()
        out: list[str] = []
        # Snapshot: this renders on the ops HTTP thread while the event
        # loop's store_peer can insert a newly joined gateway.
        digests = dict(self.digests)
        merged = merge_digests([d for d, _ in digests.values()])

        out.append("# HELP fleet_gateways Gateways contributing digests "
                   "to this fleet view")
        out.append("# TYPE fleet_gateways gauge")
        out.append(f"fleet_gateways {len(digests)}")

        for family in sorted(merged["counters"]):
            rows = merged["counters"][family]
            if not rows:
                continue
            out.append(f"# HELP fleet_{family}_total Fleet sum of "
                       f"{family}_total across gateway digests")
            out.append(f"# TYPE fleet_{family}_total counter")
            for key in sorted(rows):
                out.append(f"fleet_{family}_total"
                           f"{_render_labels(key)} {rows[key]}")
        for family in sorted(merged["gauges"]):
            rows = merged["gauges"][family]
            if not rows:
                continue
            out.append(f"# HELP fleet_{family} Fleet sum of {family} "
                       "across gateway digests")
            out.append(f"# TYPE fleet_{family} gauge")
            for key in sorted(rows):
                out.append(f"fleet_{family}{_render_labels(key)} "
                           f"{rows[key]}")
        for family in sorted(merged["hists"]):
            rows = merged["hists"][family]
            if not rows:
                continue
            out.append(f"# HELP fleet_{family} Fleet-merged {family} "
                       "histogram sketch (exact element-wise sum)")
            out.append(f"# TYPE fleet_{family} histogram")
            for key in sorted(rows):
                entry = rows[key]

                def _le(edge: str) -> float:
                    return float("inf") if edge == "+Inf" else float(edge)

                for le in sorted(entry["bucket"], key=_le):
                    out.append(
                        f"fleet_{family}_bucket"
                        f"{_render_labels(key, {'le': le})} "
                        f"{entry['bucket'][le]}")
                out.append(f"fleet_{family}_sum{_render_labels(key)} "
                           f"{entry['sum']}")
                out.append(f"fleet_{family}_count{_render_labels(key)} "
                           f"{entry['count']}")

        # Per-gateway health summaries: digest freshness is the up
        # signal; the control plane's load vectors fill in the rest.
        vectors = dict(control.vectors) if control.active else {}
        gateways = sorted(set(digests) | set(vectors))
        for g in ("fleet_gateway_up", "fleet_gateway_overload_level",
                  "fleet_gateway_pressure", "fleet_gateway_entities",
                  "fleet_gateway_cells"):
            out.append(f"# TYPE {g} gauge")
        for gw in gateways:
            stored = digests.get(gw)
            up = int(stored is not None
                     and now - stored[1] < DIGEST_STALE_S
                     and gw not in (control.dead if control.active
                                    else ()))
            out.append(f'fleet_gateway_up{{gateway="{_esc(gw)}"}} {up}')
            v = vectors.get(gw)
            if v:
                out.append(f'fleet_gateway_overload_level'
                           f'{{gateway="{_esc(gw)}"}} {v.get("level", 0)}')
                out.append(f'fleet_gateway_pressure{{gateway="{_esc(gw)}"}} '
                           f'{round(v.get("pressure", 0.0), 4)}')
                out.append(f'fleet_gateway_entities{{gateway="{_esc(gw)}"}} '
                           f'{v.get("entities", 0)}')
                out.append(f'fleet_gateway_cells{{gateway="{_esc(gw)}"}} '
                           f'{v.get("cells", 0)}')

        # Leader annotation + shard map (directory truth, leader-eyed).
        out.append("# TYPE fleet_leader gauge")
        if control.active:
            leader = control.leader()
            if leader:
                out.append(f'fleet_leader{{gateway="{_esc(leader)}"}} 1')
        elif digests:
            out.append(f'fleet_leader{{gateway="{_esc(self.local_id())}"}} 1')
        if directory.active:
            out.append("# TYPE fleet_shard_block gauge")
            for idx, gw in sorted(directory._server_map.items()):
                out.append(f'fleet_shard_block{{block="{idx}",'
                           f'gateway="{_esc(gw)}"}} 1')
            overrides = directory.overrides()
            if overrides:
                out.append("# TYPE fleet_shard_override gauge")
                for cid, gw in sorted(overrides.items()):
                    out.append(f'fleet_shard_override{{cell="{cid}",'
                               f'gateway="{_esc(gw)}"}} 1')
            out.append("# TYPE fleet_directory_version gauge")
            out.append(f"fleet_directory_version "
                       f"{directory.override_version}")
        return "\n".join(out) + "\n"

    def render_json(self) -> dict:
        """The census form of /fleet (fleetctl's input)."""
        from .control import control
        from .directory import directory

        self._fresh_local()
        now = time.monotonic()
        digests = dict(self.digests)  # ops-thread snapshot (see above)
        vectors = dict(control.vectors) if control.active else {}
        gateways = {}
        for gw in sorted(set(digests) | set(vectors)):
            stored = digests.get(gw)
            gateways[gw] = {
                "up": bool(stored is not None
                           and now - stored[1] < DIGEST_STALE_S
                           and gw not in (control.dead if control.active
                                          else ())),
                "digest_age_s": (round(now - stored[1], 2)
                                 if stored else None),
                "vector": vectors.get(gw),
            }
        return {
            "local": self.local_id(),
            "leader": control.leader() if control.active else
                      self.local_id(),
            "gateways": gateways,
            "shard_map": directory.report() if directory.active else {},
            "merged": self.merged(),
        }


# The process-wide aggregator.
fleet = FleetObs()


def reset_fleet_obs() -> None:
    """Test hook."""
    fleet.reset()
