"""Per-rank collective traffic from the port's own counts.

The counterpart of ``repro/launch/hlo_stats.py``.  The reference walks the
compiled HLO text and applies ring-algorithm byte formulas to each
collective op; the port has no HLO, so it reads what its collectives
recorded as they ran (``sharding.collectives.CALLS``: for each kind, the
calls by collective, mesh axes and group size, with the bytes handed to
them) and applies the same formulas, with the group size P of each call:

  all_reduce                      2·B·(P−1)/P   (the reference's all-reduce)
  broadcast (a gather's block)    B·(P−1)/P     (its all-gather: a gather of
                                                 P blocks is P broadcasts)

A reduce-scatter runs as an ``all_reduce`` of the whole tensor in the port
(``collectives.reduce_scatter``), so it takes the all-reduce formula.  The
bytes handed to the collectives (``collectives.BYTES``) are kept beside the
ring bytes.  The reference's ``parse_shape_bytes`` reads the shapes of HLO
text and has no counterpart: the port counts bytes where they are handed
over.
"""
from __future__ import annotations

__all__ = ["RING_OP", "collective_stats"]

# the port's collective -> the reference's HLO op whose formula it takes
RING_OP = {"all_reduce": "all-reduce", "broadcast": "all-gather"}


def _ring_bytes(collective: str, nbytes: float, ranks: int) -> float:
    frac = (ranks - 1) / ranks if ranks > 1 else 0.0
    return (2.0 if collective == "all_reduce" else 1.0) * nbytes * frac


def collective_stats(bytes_by_kind=None) -> dict:
    """Returns ``{"total_bytes", "total_handoff_bytes", "by_kind": {kind:
    {"count", "bytes", "handoff_bytes", "op", "axes"}}, "by_axes": {axes:
    bytes}}``.

    ``bytes_by_kind``: ``{kind: {(collective, axes, group size): (calls,
    bytes handed over)}}``, default the live ``collectives.CALLS``.
    ``bytes`` are per-rank link traffic under ring algorithms (the
    reference's layout and formulas), ``handoff_bytes`` the bytes handed to
    the collectives (``collectives.BYTES``); ``by_axes`` keys, and each
    kind's ``axes`` (the groups it runs over, whose link the dry run's
    roofline names), are the mesh axes joined by ``+``.  Kinds with no call are left out, as the
    reference lists only the ops it finds."""
    if bytes_by_kind is None:
        from ..sharding.collectives import CALLS as bytes_by_kind
    by_kind, by_axes, total, handoff = {}, {}, 0.0, 0
    for kind, calls in bytes_by_kind.items():
        for (collective, axes, ranks), (count, nbytes) in calls.items():
            ring = _ring_bytes(collective, nbytes, ranks)
            rec = by_kind.setdefault(kind, {"count": 0, "bytes": 0.0, "handoff_bytes": 0, "op": set(), "axes": set()})
            key = "+".join(axes)
            rec["count"] += count
            rec["bytes"] += ring
            rec["handoff_bytes"] += nbytes
            rec["op"].add(RING_OP[collective])
            rec["axes"].add(key)
            by_axes[key] = by_axes.get(key, 0.0) + ring
            total += ring
            handoff += nbytes
    for rec in by_kind.values():
        rec["op"] = "/".join(sorted(rec["op"]))
        rec["axes"] = sorted(rec["axes"])
    return {"total_bytes": total, "total_handoff_bytes": handoff, "by_kind": by_kind, "by_axes": by_axes}
