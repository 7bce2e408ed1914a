"""Static ruleset analysis: which rules can NEVER get a hit.

The port's copy of the reference's ``runtime/staticanalysis.py``.  The
live pipeline answers "which rules got no hits", a fact of the traffic.
First-match semantics (configuration order, implicit deny, overlapping
rules) also pose a static question: a rule whose whole match space is
claimed by earlier rules of its ACL is provably dead, whatever the
traffic.  This module computes per-rule verdicts over the packed
``[R, RULE_COLS]`` tensor and joins them with live hit evidence:

  unused + dead       -> safe to delete (a static proof)
  unused + reachable  -> traffic-dependent (keep watching)
  hit    + dead       -> :class:`~..errors.AnalyzerContradiction`

Verdicts: ``redundant`` (an earlier single rule with the same action
covers every ACE), ``conflict`` (covered by earlier single rules of
another action), ``shadowed`` (dead otherwise: mixed or unknown actions,
or a union of earlier rules covers it, certified by witness exhaustion),
``partially-masked`` (earlier rules steal part of its space; a witness
packet, or an exhausted budget, says whether it is still reachable) and
``reachable`` (no earlier rule overlaps it).

Single-rule coverage is decided exactly from the pair relations of
ops/overlap.py (the ``relation_grid`` kernel on a CUDA device: every
analyzed ACL's pair tiles in one launch).  Union
coverage is certified: the corner-point grid of ``{lo}`` and the masking
rows' ``{hi+1}`` contains a witness packet iff one exists, and every
candidate runs through the production first-match route of ``run``
(``pipeline.ship_ruleset``, then ``first_match.first_match_rows``, the
``first_match`` kernel on a CUDA device, then ``match.rows_to_keys``).  A
rule is marked dead only with an exact single cover or a complete
witness-exhaustion record; past the witness budget it stays
``partially-masked`` and uncertified.

Every pair tile fires the ``analyze.tile`` fault site before any tile
is launched; an analysis that fails anywhere raises, so a returned
:class:`StaticAnalysis` is always complete.  Each ACL carries a content
signature, so a re-analysis with ``reuse=`` re-tiles only the ACLs that
changed and remaps the others' verdicts to their new key ids.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time

import numpy as np
import torch

from ..errors import AnalysisError, AnalyzerContradiction
from ..hostside import pack as pack_mod
from ..hostside.pack import _RANGE_COLS, NO_ACL, R_ACL, R_KEY
from ..models.pipeline import ship_ruleset
from ..ops import first_match
from ..ops import overlap as overlap_mod
from ..ops.hashing import u32_of
from ..ops.match import rows_to_keys
from . import faults
from .stream import resolve_device

REACHABLE = "reachable"
SHADOWED = "shadowed"
REDUNDANT = "redundant"
CONFLICT = "conflict"
PARTIAL = "partially-masked"

#: verdicts that assert "this rule can never get a hit"
DEAD_VERDICTS = frozenset({SHADOWED, REDUNDANT, CONFLICT})

#: evidence classes the unused-rule report joins verdicts into
CLASS_SAFE = "safe_to_delete"
CLASS_TRAFFIC = "traffic_dependent"
CLASS_UNDECIDED = "undecided"

#: per-rule cap on witness-grid enumeration (overridable per call); the
#: grid is exact when fully enumerated, so the budget only bounds WORK —
#: past it a verdict stays partially-masked/uncertified, never dead
DEFAULT_WITNESS_BUDGET = 4096

#: certifier batch: candidates go to the first_match kernel in chunks of
#: this many (the reference's, so the chunking is the same)
_CAND_CHUNK = 2048

#: derived from the pack layer's canonical range-column table (shared
#: with ops/overlap.py) — the witness grids and the relation predicates
#: must agree on the field set or exhaustion proofs become unsound
_FIELDS = tuple((lo, hi) for lo, hi, _name in _RANGE_COLS)


@dataclasses.dataclass
class RuleVerdict:
    """One configured rule's static verdict + its evidence."""

    key_id: int
    verdict: str
    basis: str  # single-cover | witness-exhaustion | witness | disjoint | ...
    certified: bool  # exact proof vs budget-truncated evidence
    cover_key: int | None = None  # exact single-rule cover (earliest)
    witness: list[int] | None = None  # [proto, src, sport, dst, dport]
    witnesses_checked: int = 0
    witness_grid: int = 0  # full corner-grid size (0 = no grid needed)

    @property
    def dead(self) -> bool:
        return self.verdict in DEAD_VERDICTS

    def to_obj(self, packed: pack_mod.PackedRuleset) -> dict:
        m = packed.key_meta[self.key_id]
        out = {
            "rule": f"{m.firewall} {m.acl} {m.index}",
            "key_id": self.key_id,
            "verdict": self.verdict,
            "basis": self.basis,
            "certified": self.certified,
        }
        if self.cover_key is not None:
            cm = packed.key_meta[self.cover_key]
            out["cover"] = f"{cm.firewall} {cm.acl} {cm.index}"
        if self.witness is not None:
            out["witness"] = list(self.witness)
        if self.witness_grid:
            # the witness-exhaustion record: how big the exact corner
            # grid was and how much of it was actually device-checked
            out["witness_grid"] = self.witness_grid
            out["witnesses_checked"] = self.witnesses_checked
        return out


@dataclasses.dataclass
class StaticAnalysis:
    """A COMPLETE verdict set over one packed ruleset."""

    verdicts: dict[int, RuleVerdict]  # key_id -> verdict (configured rules)
    meta: dict
    #: (firewall, acl) -> (signature, ordered key ids): the incremental
    #: reuse index a later :func:`analyze_ruleset` call consumes
    acl_index: dict[tuple[str, str], tuple[bytes, list[int]]]

    def dead_keys(self) -> set[int]:
        return {k for k, v in self.verdicts.items() if v.dead}

    def to_obj(self, packed: pack_mod.PackedRuleset) -> dict:
        return {
            "meta": dict(self.meta),
            "verdicts": [
                self.verdicts[k].to_obj(packed) for k in sorted(self.verdicts)
            ],
        }


# ---------------------------------------------------------------------------
# Device certifier: candidate packets through the production match route.
# ---------------------------------------------------------------------------


class _Certifier:
    """Runs candidate packets through the first-match route of ``run``.

    The ruleset ships once (``pipeline.ship_ruleset``: the padded rules,
    the kernels' rule tensor and ACL spans, the deny keys); each chunk of
    candidates goes to ``first_match.first_match_rows`` (the kernel on a
    CUDA device, its plain version on the CPU) and ``match.rows_to_keys``,
    so a witness IS a packet the live pipeline attributes to the rule.
    """

    def __init__(self, packed: pack_mod.PackedRuleset, device: torch.device,
                 chunk: int = _CAND_CHUNK):
        self.chunk = chunk
        self.device = device
        self._ruleset = ship_ruleset(packed, device)

    def match_keys(self, tuples: np.ndarray) -> np.ndarray:
        """``[N, 6] (acl, proto, src, sport, dst, dport)`` -> key per row."""
        rs = self._ruleset
        n = tuples.shape[0]
        out = np.empty(n, dtype=np.uint32)
        for c0 in range(0, n, self.chunk):
            c1 = min(c0 + self.chunk, n)
            # the tail (often a rule's whole tiny corner grid) pads to the
            # next power of two from 64, not the full chunk (the reference's)
            cap = 64
            while cap < c1 - c0:
                cap <<= 1
            block = np.zeros((min(cap, self.chunk), 6), dtype=np.uint32)
            block[: c1 - c0] = tuples[c0:c1]
            fields = [
                torch.from_numpy(np.ascontiguousarray(block[:, i]).view(np.int32)).to(self.device)
                for i in range(6)
            ]
            row = first_match.first_match_rows(fields, rs.rules_k, rs.acl_span)
            keys = rows_to_keys(u32_of(row), rs.rules, rs.deny_key, u32_of(fields[0]))
            out[c0:c1] = keys.cpu().numpy()[: c1 - c0]
        return out


# ---------------------------------------------------------------------------
# Witness-grid candidate generation (the corner-point construction).
# ---------------------------------------------------------------------------


def _grid_coords(
    sub: np.ndarray, a: int, maskers: np.ndarray
) -> list[list[int]]:
    """Per-field corner candidates for row ``a`` against ``maskers``.

    ``{lo_a}`` plus every masking row's ``hi+1`` that lands inside
    ``[lo_a, hi_a]``.  The cross-product grid contains an uncovered
    point iff row a's box minus the maskers' union is non-empty
    (minimal-uncovered-point argument; DESIGN §17), so full enumeration
    DECIDES union coverage — the budget only truncates work, never
    soundness of a dead verdict.
    """
    coords: list[list[int]] = []
    for lo, hi in _FIELDS:
        lo_a, hi_a = int(sub[a, lo]), int(sub[a, hi])
        vals = {lo_a}
        for b in maskers:
            v = int(sub[b, hi]) + 1
            if lo_a <= v <= hi_a:
                vals.add(v)
        coords.append(sorted(vals))
    return coords


def _grid_size(coords: list[list[int]]) -> int:
    n = 1
    for c in coords:
        n *= len(c)
    return n


def _enumerate_grid(coords: list[list[int]], cap: int) -> np.ndarray:
    """First ``cap`` grid points in lexicographic order, ``[n, 5]``."""
    out = []
    for p in itertools.product(*coords):
        out.append(p)
        if len(out) >= cap:
            break
    return np.asarray(out, dtype=np.uint32).reshape(-1, 5)


# ---------------------------------------------------------------------------
# Per-ACL signatures (incremental re-analysis on hot reload).
# ---------------------------------------------------------------------------


def _acl_signature(
    sub: np.ndarray, local_keys: np.ndarray, actions: list[int], v6_local: list[int]
) -> bytes:
    """Content signature of one ACL's analysis input.

    Covers exactly what verdicts depend on: the ordered interval rows
    (ACL gid column zeroed — renumbering gids must not fake a change),
    each row's key as a LOCAL ordinal (global renumbering preserves
    verdicts), per-key actions, and which local keys carry v6 rows.
    """
    img = sub.copy()
    img[:, R_ACL] = 0
    img[:, R_KEY] = local_keys
    h = hashlib.sha256(img.tobytes())
    h.update(np.asarray(actions, dtype=np.int64).tobytes())
    h.update(np.asarray(sorted(v6_local), dtype=np.int64).tobytes())
    return h.digest()


# ---------------------------------------------------------------------------
# The analyzer.
# ---------------------------------------------------------------------------


def analyze_ruleset(
    packed: pack_mod.PackedRuleset,
    *,
    tile: int | None = None,
    witness_budget: int = DEFAULT_WITNESS_BUDGET,
    device: str | torch.device = "cuda",
    reuse: StaticAnalysis | None = None,
) -> StaticAnalysis:
    """Full static analysis of a packed ruleset -> per-rule verdicts.

    O(Ra^2) pair tiles per ACL, all in one launch, on ``device``
    (``"cuda"``, the default, or ``"cpu"``, or a torch device; no card is
    :class:`~..errors.DeviceUnavailable`), then host aggregation and the
    witness pass on the same device.  ``reuse`` (a prior result, e.g.
    across a reload) skips ACLs whose content signature is unchanged,
    remapping their verdicts to the new key ids.  Raises typed on any
    failure: callers never see a partial table.
    """
    if witness_budget < 1:
        raise AnalysisError(
            f"witness budget must be >= 1, got {witness_budget}"
        )
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    tile = tile or overlap_mod.PAIR_TILE
    t0 = time.monotonic()
    rules = packed.rules
    real = rules[:, R_ACL] != NO_ACL
    pack_mod.validate_rule_ranges(rules[real])

    # keys carrying v6 rows: their v4-side analysis can bound but never
    # kill them (a v6 packet could still reach the rule; the v4 kernel
    # cannot certify that half)
    v6_keys: set[int] = set()
    if packed.has_v6:
        v6_keys = set(
            int(k) for k in packed.rules6[
                packed.rules6[:, pack_mod.R6_ACL] != NO_ACL, pack_mod.R6_KEY
            ]
        )

    gid_name = {gid: name for name, gid in packed.acl_gid.items()}
    reuse_index = dict(reuse.acl_index) if reuse is not None else {}
    reuse_verdicts = reuse.verdicts if reuse is not None else {}

    certifier: _Certifier | None = None
    verdicts: dict[int, RuleVerdict] = {}
    acl_index: dict[tuple[str, str], tuple[bytes, list[int]]] = {}
    analyzed_acls = 0
    reused_acls = 0
    tiles_run = 0
    witnesses_run = 0

    row_key = rules[:, R_KEY].astype(np.int64)
    row_acl = rules[:, R_ACL].astype(np.int64)
    # every key of each ACL (a pure-v6 rule has no v4 rows but still
    # needs a verdict); key ids ascend in config order by construction
    keys_by_name: dict[tuple[str, str], list[int]] = {}
    for kid, m in enumerate(packed.key_meta):
        if not m.implicit_deny:
            keys_by_name.setdefault((m.firewall, m.acl), []).append(kid)
    # first pass, in gid order: each ACL's slab, signature and reuse
    # decision; the slabs of the ACLs to analyze go to one tile launch
    todo: list[tuple] = []  # (acl_keys, prior or None, analysis inputs or None)
    for gid in range(packed.n_acls):
        name = gid_name.get(gid)
        rows_idx = np.nonzero(real & (row_acl == gid))[0]
        sub = np.ascontiguousarray(rules[rows_idx])
        keys = row_key[rows_idx]  # global key ids, config order
        acl_keys = keys_by_name.get(name, [])
        if not acl_keys:
            continue
        base = acl_keys[0]
        local_keys = keys - base
        actions = [packed.key_meta[k].action for k in acl_keys]
        v6_local = [k - base for k in acl_keys if k in v6_keys]
        sig = _acl_signature(sub, local_keys, actions, v6_local)
        acl_index[name] = (sig, acl_keys)

        prior = reuse_index.get(name)
        if prior is not None and prior[0] == sig and len(prior[1]) == len(acl_keys):
            todo.append((acl_keys, prior, None))
            reused_acls += 1
            continue
        analyzed_acls += 1
        todo.append((acl_keys, None, (gid, sub, keys)))

    # --- pair relations, device tiles: every analyzed ACL's tiles in one
    # launch a device -------------------------------------------------------
    def on_tile(_slab, _i0, _j0):
        nonlocal tiles_run
        tiles_run += 1
        # chaos seam: a tile failing mid-grid must abort the whole
        # analysis typed — never ship the tiles computed so far (every
        # seam fires before the launch, so none is computed yet)
        faults.fire("analyze.tile")

    # lower_only: slab rows are key-ascending, so tiles strictly
    # above the diagonal can never survive the earlier-key mask —
    # the tile grid halves with bit-identical verdicts
    relations = iter(overlap_mod.pair_relations_many(
        [inputs[1] for *_, inputs in todo if inputs is not None], tile=tile,
        devices=[device], on_tile=on_tile, lower_only=True,
    ))

    # second pass, in the same order: reuse remaps, the verdict loop and
    # the witness pass
    for acl_keys, prior, inputs in todo:
        if prior is not None:
            # unchanged ACL: remap the prior verdicts positionally (the
            # signature pins rows, local key ordinals, actions, and the
            # v6 set, so the verdicts are identical by construction)
            old_to_new = dict(zip(prior[1], acl_keys))
            for old_kid in prior[1]:
                ov = reuse_verdicts[old_kid]
                verdicts[old_to_new[old_kid]] = dataclasses.replace(
                    ov,
                    key_id=old_to_new[old_kid],
                    cover_key=(
                        old_to_new.get(ov.cover_key)
                        if ov.cover_key is not None
                        else None
                    ),
                )
            continue
        gid, sub, keys = inputs
        covered, ovl = next(relations)
        # earlier-rule mask: rows of EARLIER keys only (rows of the same
        # key attribute hits to the rule itself, so they never mask it)
        earlier = keys[None, :] < keys[:, None]  # [a, b]: b's key earlier
        cov_e = covered & earlier
        ovl_e = ovl & earlier

        for pos, kid in enumerate(acl_keys):
            rows_of_key = np.nonzero(keys == kid)[0]
            if rows_of_key.size == 0:
                # pure-v6 rule: nothing the v4 plane can say
                verdicts[kid] = RuleVerdict(
                    key_id=kid, verdict=PARTIAL, basis="v6-rows-unanalyzed",
                    certified=False,
                )
                continue
            v = _verdict_for_key(packed, keys, kid, rows_of_key, cov_e, ovl_e)
            if v is None:
                # witness pass needed: build lazily, batch per rule
                if certifier is None:
                    certifier = _Certifier(packed, device)
                v, n_checked = _witness_verdict(
                    packed, sub, keys, kid, rows_of_key, cov_e, ovl_e,
                    witness_budget, certifier, gid,
                )
                witnesses_run += n_checked
            if kid in v6_keys and v.dead:
                # v4-dead but v6 rows exist: the rule may still match v6
                # traffic — never claim dead from the v4 plane alone
                v = dataclasses.replace(
                    v, verdict=PARTIAL, basis="v4-dead-v6-unanalyzed",
                    certified=False,
                )
            verdicts[kid] = v

    counts: dict[str, int] = {}
    for v in verdicts.values():
        counts[v.verdict] = counts.get(v.verdict, 0) + 1
    meta = {
        "n_rules": packed.n_rules,
        "n_acls": packed.n_acls,
        "n_rows": int(real.sum()),
        "tile": tile,
        "witness_budget": witness_budget,
        "tiles_run": tiles_run,
        "witnesses_checked": witnesses_run,
        "analyzed_acls": analyzed_acls,
        "reused_acls": reused_acls,
        "duration_sec": round(time.monotonic() - t0, 4),
        "verdict_counts": counts,
        "dead": sum(counts.get(k, 0) for k in DEAD_VERDICTS),
        # a StaticAnalysis object only exists COMPLETE: any failure
        # raises before construction (the analyze.tile invariant)
        "complete": True,
    }
    return StaticAnalysis(verdicts=verdicts, meta=meta, acl_index=acl_index)


def _verdict_for_key(
    packed, keys, kid, rows_of_key, cov_e, ovl_e
) -> RuleVerdict | None:
    """Exact verdicts decidable from pair relations alone (None = needs
    the witness pass)."""
    covered_rows = cov_e[rows_of_key].any(axis=1)
    if covered_rows.all():
        # every ACE exactly covered by one earlier rule: dead, with the
        # redundant/conflict/shadowed split read off the cover actions
        my_action = packed.key_meta[kid].action
        cover_keys = []
        for a in rows_of_key:
            b = int(np.nonzero(cov_e[a])[0][0])  # earliest covering row
            cover_keys.append(int(keys[b]))
        cover_actions = {packed.key_meta[c].action for c in cover_keys}
        if my_action >= 0 and cover_actions == {my_action}:
            verdict = REDUNDANT
        elif my_action >= 0 and -1 not in cover_actions and my_action not in cover_actions:
            verdict = CONFLICT
        else:
            verdict = SHADOWED  # mixed or unknown actions: still dead
        return RuleVerdict(
            key_id=kid, verdict=verdict, basis="single-cover",
            certified=True, cover_key=cover_keys[0],
        )
    if not ovl_e[rows_of_key].any():
        return RuleVerdict(
            key_id=kid, verdict=REACHABLE, basis="disjoint", certified=True
        )
    return None


def _witness_verdict(
    packed, sub, keys, kid, rows_of_key, cov_e, ovl_e, witness_budget,
    certifier, gid,
) -> tuple[RuleVerdict, int]:
    """Union-coverage certification for one rule (the witness pass)."""
    grids: list[np.ndarray] = []
    grid_total = 0
    budget_left = witness_budget
    for a in rows_of_key:
        if cov_e[a].any():
            continue  # this ACE is exactly covered: no witness there
        maskers = np.nonzero(ovl_e[a])[0]
        coords = _grid_coords(sub, a, maskers)
        grid_total += _grid_size(coords)
        if budget_left > 0:
            g = _enumerate_grid(coords, budget_left)
            budget_left -= g.shape[0]
            grids.append(g)
    cand = (
        np.concatenate(grids, axis=0)
        if grids
        else np.zeros((0, 5), dtype=np.uint32)
    )
    tuples = np.zeros((cand.shape[0], 6), dtype=np.uint32)
    tuples[:, 0] = gid
    tuples[:, 1:] = cand
    matched = certifier.match_keys(tuples) if cand.shape[0] else np.zeros(0)
    hit = np.nonzero(matched == kid)[0]
    if hit.size:
        w = [int(x) for x in cand[int(hit[0])]]
        return (
            RuleVerdict(
                key_id=kid, verdict=PARTIAL, basis="witness", certified=True,
                witness=w, witnesses_checked=int(cand.shape[0]),
                witness_grid=grid_total,
            ),
            int(cand.shape[0]),
        )
    if grid_total <= witness_budget:
        # full corner grid enumerated, zero witnesses: the union of
        # earlier rules covers every ACE — dead, with the exhaustion
        # record as the proof object
        return (
            RuleVerdict(
                key_id=kid, verdict=SHADOWED, basis="witness-exhaustion",
                certified=True, witnesses_checked=int(cand.shape[0]),
                witness_grid=grid_total,
            ),
            int(cand.shape[0]),
        )
    # budget truncated the grid and no witness surfaced: honestly
    # undecided — NOT dead
    return (
        RuleVerdict(
            key_id=kid, verdict=PARTIAL, basis="witness-budget",
            certified=False, witnesses_checked=int(cand.shape[0]),
            witness_grid=grid_total,
        ),
        int(cand.shape[0]),
    )


# ---------------------------------------------------------------------------
# Report join: verdicts x live hit evidence.
# ---------------------------------------------------------------------------


def unused_class(verdict: dict) -> str:
    """Evidence class of an unused rule given its verdict object."""
    if verdict["verdict"] in DEAD_VERDICTS:
        return CLASS_SAFE
    if verdict["certified"] or verdict["verdict"] == REACHABLE:
        return CLASS_TRAFFIC
    return CLASS_UNDECIDED


def attach_static_obj(obj: dict, sa_obj: dict, *, strict: bool = True) -> dict:
    """Join a static-analysis object into a report JSON object, in place.

    Adds per-rule ``verdict``/``verdict_basis``/``verdict_certified``
    fields, a ``totals.static`` block (analysis meta + the unused-rule
    evidence classes), and enforces the contradiction invariant: a rule
    with live hits and a dead verdict raises
    :class:`~..errors.AnalyzerContradiction` when ``strict`` (reports
    whose counters belong entirely to the analyzed ruleset), else is
    recorded in ``totals.static.contradictions`` — visible either way,
    silent never.  ``strict=False`` is for reports whose counters span a
    ruleset reload (migrated windows, cumulative/merged views): hits
    earned under an OLD ruleset legitimately coexist with a dead verdict
    under the new one.
    """
    by_key = {v["key_id"]: v for v in sa_obj["verdicts"]}
    classes: dict[str, list[str]] = {
        CLASS_SAFE: [], CLASS_TRAFFIC: [], CLASS_UNDECIDED: []
    }
    contradictions: list[dict] = []
    for e in obj["per_rule"]:
        v = by_key.get(e["key_id"])
        if v is None:
            continue  # implicit-deny keys carry no verdict
        e["verdict"] = v["verdict"]
        e["verdict_basis"] = v["basis"]
        e["verdict_certified"] = v["certified"]
        rule = f"{e['firewall']} {e['acl']} {e['index']}"
        if e["hits"] == 0:
            classes[unused_class(v)].append(rule)
        elif v["verdict"] in DEAD_VERDICTS:
            contradictions.append(
                {"rule": rule, "hits": e["hits"], "verdict": v["verdict"]}
            )
    totals = obj["totals"]
    totals["static"] = {
        "meta": dict(sa_obj["meta"]),
        "unused_classes": classes,
    }
    if contradictions:
        if strict:
            first = contradictions[0]
            raise AnalyzerContradiction(
                f"rule {first['rule']} has {first['hits']} live hit(s) but "
                f"a certified '{first['verdict']}' (dead) verdict "
                f"({len(contradictions)} contradicting rule(s) total); the "
                "analyzer or the counters are wrong — refusing to publish "
                "the contradiction as a report"
            )
        totals["static"]["contradictions"] = contradictions
    return obj


def attach_static(rep, packed: pack_mod.PackedRuleset, sa: StaticAnalysis,
                  *, strict: bool = True):
    """:func:`attach_static_obj` for a :class:`~.report.Report` object."""
    attach_static_obj(
        {"per_rule": rep.per_rule, "totals": rep.totals},
        sa.to_obj(packed),
        strict=strict,
    )
    return rep


# ---------------------------------------------------------------------------
# CLI rendering (the `analyze` subcommand's text view).
# ---------------------------------------------------------------------------


def render_text(packed: pack_mod.PackedRuleset, sa_obj: dict) -> str:
    m = sa_obj["meta"]
    out = [
        f"# static analysis: {m['n_rules']} rules, {m['n_acls']} ACLs, "
        f"{m['n_rows']} ACE rows; {m['tiles_run']} pair tiles, "
        f"{m['witnesses_checked']} witness packets device-checked "
        f"({m['duration_sec']}s)"
    ]
    counts = ", ".join(
        f"{k}={v}" for k, v in sorted(m["verdict_counts"].items())
    )
    out.append(f"# verdicts: {counts}  (provably dead: {m['dead']})")
    by_acl: dict[str, list[dict]] = {}
    for v in sa_obj["verdicts"]:
        fw, acl, _ = v["rule"].rsplit(" ", 2)
        by_acl.setdefault(f"{fw} / {acl}", []).append(v)
    for name, vs in by_acl.items():
        out.append(f"\n== {name} ==")
        for v in vs:
            idx = v["rule"].rsplit(" ", 1)[1]
            extra = ""
            if v.get("cover"):
                extra = f"  covered by rule {v['cover'].rsplit(' ', 1)[1]}"
            elif v.get("witness"):
                extra = f"  witness={v['witness']}"
            elif v.get("witness_grid"):
                extra = (
                    f"  grid={v['witness_grid']} "
                    f"checked={v['witnesses_checked']}"
                )
            cert = "" if v["certified"] else "  [uncertified]"
            text = packed.key_meta[v["key_id"]].text
            out.append(
                f"  rule {idx:>4}: {v['verdict']:<16} ({v['basis']})"
                f"{extra}{cert}  | {text}"
            )
    return "\n".join(out)
