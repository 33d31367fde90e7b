"""Consensus decision provenance + first-divergence bisection.

Every divergence this repo has found so far was caught as a whole-run
digest mismatch and triaged by hand from flight-ring dumps. This module
turns the sweep from a divergence *detector* into a divergence
*debugger*: a `ProvenanceRecorder` records, per consensus round, the
content of the four voting tables plus *why* each fame decision landed,
and a `DivergenceBisector` diffs two recorders' streams and names the
earliest divergent (pass, table, round, witness) cell.

Capture seams — one per engine family, all host-side:

- the CPU hashgraph oracle hooks its three passes directly
  (divide_rounds / decide_fame at the decision point / the reception
  stamp in decide_round_received), which also captures the decision
  *why*: deciding voter, yay/nay tallies, strongly-seen count, deciding
  step (round diff) and coin-round traversals;
- every device engine (one-shot, doubling cold path, sharded mesh,
  queued dispatch) funnels through `engine.integrate_pass_results`,
  and the live engine through `live._integrate` — both capture from
  the ALREADY-FETCHED host numpy integration buffers, so provenance
  adds zero device work and zero host syncs to the staged paths (the
  jax-staging audit stays clean by construction).

Comparability contract: a table cell is keyed by event hash and holds
an engine-independent value (creator position, fame verdict, received
round, [lamport, *lastAncestors]). Cell writes are last-write-wins and
append nothing when the value is unchanged, so two engines that agree
converge to byte-identical per-round tables (``table_bytes()``) while
the full stream (``stream_bytes()``, which adds the whys and marks)
stays deterministic per backend and joins ``SimCluster.result()``'s
determinism fingerprint next to the flight recorder's.

The recorder is bounded: at most ``round_cap`` rounds are retained,
oldest-settled evicted first, and every eviction is recorded as a
``prov.truncate`` mark — so a stream is always complete or *cleanly*
truncated (``verify_complete_or_truncated()``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..common.clock import Clock, SYSTEM_CLOCK

# retained-round bound: at consensus rates this is minutes of history
# while keeping a full stream document comfortably small
DEFAULT_PROV_ROUND_CAP = 512

# bounded mark list (truncation/capture markers), drop-oldest
MAX_MARKS = 1024

# bisection compares tables in causal pass order within a round:
# DivideRounds assigns lastAncestors/lamport and the witness set, fame
# votes over witnesses, receptions require decided fame
PASS_TABLES: Tuple[Tuple[str, str], ...] = (
    ("divide", "lastAncestors"),
    ("divide", "witness"),
    ("fame", "fame"),
    ("received", "received"),
)
TABLES = tuple(t for _, t in PASS_TABLES)
PASS_OF_TABLE = {t: p for p, t in PASS_TABLES}


class RoundProvenance:
    """Per-round decision record: the four comparable tables plus the
    per-witness *why* metadata (engine-specific, excluded from the
    cross-engine table fingerprint)."""

    __slots__ = ("round", "final", "tables", "why")

    def __init__(self, round_number: int):
        self.round = round_number
        self.final = False
        self.tables: Dict[str, Dict[str, Any]] = {t: {} for t in TABLES}
        self.why: Dict[str, Dict[str, Any]] = {}

    def set_cell(self, table: str, key: str, value: Any) -> bool:
        """Last-write-wins cell write; returns True when the value is new
        or changed (idempotent re-stamps append nothing)."""
        cells = self.tables[table]
        if cells.get(key) == value:
            return False
        cells[key] = value
        return True

    def table_doc(self) -> Dict[str, Any]:
        """Engine-independent comparable content (sorted-key canonical)."""
        return {t: dict(self.tables[t]) for t in TABLES}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "round": self.round,
            "final": self.final,
            "tables": self.table_doc(),
            "why": {h: dict(w) for h, w in self.why.items()},
        }

    def fingerprint(self) -> str:
        """sha256 of the canonical table content — the unit the bisector
        (and the watchdog's stall triage) compares across engines."""
        blob = json.dumps(
            self.table_doc(), sort_keys=True, separators=(",", ":")
        ).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()


class ProvenanceRecorder:
    """Bounded per-node store of RoundProvenance keyed by ABSOLUTE round
    number, with FlightRecorder-style determinism guarantees."""

    def __init__(self, clock: Optional[Clock] = None, node_id: int = 0,
                 round_cap: int = DEFAULT_PROV_ROUND_CAP):
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.node_id = node_id
        self.round_cap = max(4, round_cap)
        self._lock = threading.Lock()
        # guarded-by: _lock — round number -> RoundProvenance
        self._rounds: Dict[int, RoundProvenance] = {}
        self._marks: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._mark_seq = 0  # guarded-by: _lock
        self._marks_dropped = 0  # guarded-by: _lock
        self.evicted_rounds = 0  # guarded-by: _lock
        # rounds strictly below this may have been evicted (truncation
        # floor; 0 == nothing evicted, the stream is complete)
        self.evicted_below = 0  # guarded-by: _lock

    # ------------------------------------------------------------------
    # cell capture (engine hooks)
    # ------------------------------------------------------------------

    def _round_locked(self, r: int) -> RoundProvenance:  # requires-lock: _lock
        rp = self._rounds.get(r)
        if rp is None:
            rp = self._rounds[r] = RoundProvenance(r)
            self._evict_locked()
        return rp

    def _evict_locked(self) -> None:  # requires-lock: _lock
        while len(self._rounds) > self.round_cap:
            # oldest-first: settled history goes before the live tail
            oldest = min(self._rounds)
            del self._rounds[oldest]
            self.evicted_rounds += 1
            self.evicted_below = max(self.evicted_below, oldest + 1)
            self._mark_locked("prov.truncate", round=oldest,
                             evicted=self.evicted_rounds)

    def note_event(self, h: str, round_number: int, lamport: int,
                   last_ancestors: Iterable[Any]) -> bool:
        """DivideRounds: event -> round assignment with its lamport stamp
        and lastAncestors row. `last_ancestors` accepts either the host
        coordinate tuples (index, hash) or the grid's int row."""
        la = [
            int(c[0]) if isinstance(c, (tuple, list)) else int(c)
            for c in last_ancestors
        ]
        with self._lock:
            return self._round_locked(round_number).set_cell(
                "lastAncestors", h, [int(lamport)] + la
            )

    def note_witness(self, h: str, round_number: int, creator: int) -> bool:
        """DivideRounds: witness flag (cell value = creator position)."""
        with self._lock:
            return self._round_locked(round_number).set_cell(
                "witness", h, int(creator)
            )

    def note_fame(self, h: str, round_number: int, famous: bool,
                  **why: Any) -> bool:
        """DecideFame: a landed fame verdict. `why` carries the deciding
        context (engine, voter, yays, nays, ss, step, coins, flips) and
        is stored per witness — outside the comparable tables, so
        engines with different levels of introspection still produce
        byte-identical table streams."""
        with self._lock:
            rp = self._round_locked(round_number)
            changed = rp.set_cell("fame", h, bool(famous))
            if changed and why:
                rp.why[h] = {
                    k: v for k, v in sorted(why.items()) if v is not None
                }
            return changed

    def note_received(self, h: str, round_received: int) -> bool:
        """DecideRoundReceived: event h received at round_received."""
        with self._lock:
            return self._round_locked(round_received).set_cell(
                "received", h, int(round_received)
            )

    def settle_round(self, round_number: int) -> None:
        """ProcessDecidedRounds materialized this round into a frame —
        its tables are now part of committed history."""
        with self._lock:
            rp = self._rounds.get(round_number)
            if rp is not None:
                rp.final = True

    # ------------------------------------------------------------------
    # marks (bounded, Clock-timestamped stream annotations)
    # ------------------------------------------------------------------

    def _mark_locked(self, name: str, **fields: Any) -> None:  # requires-lock: _lock
        self._marks.append({
            "seq": self._mark_seq,
            "t": round(self.clock.monotonic(), 9),
            "name": name,
            "fields": fields,
        })
        self._mark_seq += 1
        if len(self._marks) > MAX_MARKS:
            self._marks.pop(0)
            self._marks_dropped += 1

    def mark(self, name: str, **fields: Any) -> None:
        """Append one named stream marker. `name` must be a static string
        literal at the call site (obs-prov-static-name); fields must be
        deterministic values."""
        with self._lock:
            self._mark_locked(name, **fields)

    # ------------------------------------------------------------------
    # reading / fingerprints
    # ------------------------------------------------------------------

    def rounds(self) -> List[int]:
        with self._lock:
            return sorted(self._rounds)

    def round_provenance(self, r: int) -> Optional[RoundProvenance]:
        with self._lock:
            return self._rounds.get(r)

    def round_fingerprint(self, r: int) -> Optional[str]:
        with self._lock:
            rp = self._rounds.get(r)
        return None if rp is None else rp.fingerprint()

    def explain_round(self, r: int) -> Dict[str, Any]:
        """One round's full dossier (`GET /debug/explain`, CLI explain)."""
        with self._lock:
            rp = self._rounds.get(r)
            evicted_below = self.evicted_below
        if rp is None:
            return {
                "node": self.node_id, "round": r, "known": False,
                "evicted_below": evicted_below,
            }
        doc = rp.to_dict()
        doc.update({
            "node": self.node_id, "known": True,
            "fingerprint": rp.fingerprint(),
        })
        return doc

    def table_doc(self) -> Dict[str, Any]:
        """Engine-comparable stream: the per-round tables only."""
        with self._lock:
            rounds = {
                str(r): rp.table_doc() for r, rp in sorted(self._rounds.items())
            }
            return {"evicted_below": self.evicted_below, "rounds": rounds}

    def table_bytes(self) -> bytes:
        return json.dumps(self.table_doc(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def table_fingerprint(self) -> str:
        return hashlib.sha256(self.table_bytes()).hexdigest()

    def to_json(self) -> Dict[str, Any]:
        """Full stream document (export artifacts, /debug/explain?all)."""
        with self._lock:
            rounds = {
                str(r): rp.to_dict() for r, rp in sorted(self._rounds.items())
            }
            marks = [dict(m) for m in self._marks]
            doc = {
                "node": self.node_id,
                "round_cap": self.round_cap,
                "evicted_rounds": self.evicted_rounds,
                "evicted_below": self.evicted_below,
                "marks_dropped": self._marks_dropped,
                "rounds": rounds,
                "marks": marks,
            }
        return doc

    def stream_bytes(self) -> bytes:
        """Canonical byte serialization of the full stream — the unit of
        the sim's byte-identical-replay guarantee for provenance."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def fingerprint(self) -> str:
        """sha256 of ``stream_bytes()`` — joins ``SimCluster.result()``'s
        determinism fingerprint."""
        return hashlib.sha256(self.stream_bytes()).hexdigest()

    # ------------------------------------------------------------------
    # integrity
    # ------------------------------------------------------------------

    def verify_complete_or_truncated(self) -> List[str]:
        """The fault-plan stream contract: every retained round is above
        the truncation floor, every eviction left a ``prov.truncate``
        mark (unless the mark ring itself wrapped), every fame cell
        names a witness the same round knows, and the store respects its
        bound. Returns human-readable issues (empty == holds)."""
        issues: List[str] = []
        with self._lock:
            rounds = dict(self._rounds)
            evicted = self.evicted_rounds
            evicted_below = self.evicted_below
            marks = list(self._marks)
            marks_dropped = self._marks_dropped
        if len(rounds) > self.round_cap:
            issues.append(
                f"{len(rounds)} rounds retained > cap {self.round_cap}"
            )
        for r in rounds:
            if r < evicted_below:
                issues.append(
                    f"round {r} retained below truncation floor "
                    f"{evicted_below}"
                )
        if evicted > 0 and marks_dropped == 0:
            if not any(m["name"] == "prov.truncate" for m in marks):
                issues.append(
                    f"{evicted} rounds evicted but no prov.truncate mark"
                )
        for r, rp in rounds.items():
            witnesses = rp.tables["witness"]
            for h in rp.tables["fame"]:
                if h not in witnesses:
                    issues.append(
                        f"round {r}: fame cell {h[:18]}… has no witness cell"
                    )
        return issues


# ----------------------------------------------------------------------
# PassResults capture (benches / standalone engine comparisons)
# ----------------------------------------------------------------------

def grid_cell_keys(grid) -> List[str]:
    """Row -> stable cell key. Real grids carry event hashes; synthetic
    bench grids don't, so fall back to the row ordinal — rows are built
    identically on both sides of a byte-equality gate, so the keys still
    line up cell-for-cell."""
    hashes = getattr(grid, "hashes", None)
    if hashes:
        return hashes
    return ["row%08d" % r for r in range(grid.e)]


def capture_pass_results(grid, res, recorder: Optional[ProvenanceRecorder]
                         = None, engine: str = "device",
                         clock: Optional[Clock] = None) -> ProvenanceRecorder:
    """Fingerprint a raw PassResults against its DagGrid — the seam the
    benches' byte-equality gates bisect through. Reads only the staged
    host numpy buffers (no device work, no extra syncs)."""
    prov = recorder if recorder is not None else ProvenanceRecorder(
        clock=clock
    )
    keys = grid_cell_keys(grid)
    for row in range(grid.e):
        rnum = int(res.rounds[row])
        if rnum < 0:
            continue
        h = keys[row]
        prov.note_event(h, rnum, int(res.lamport[row]),
                        grid.last_ancestors[row])
        if bool(res.witness[row]):
            prov.note_witness(h, rnum, int(grid.creator[row]))
        rr = int(res.received[row])
        if rr >= 0:
            prov.note_received(h, rr)
    # kernel-level results (PipelineResult) have no rebasing offset
    round_offset = int(getattr(res, "round_offset", 0))
    for ti in range(res.witness_table.shape[0]):
        rnum = ti + round_offset
        for c in range(res.witness_table.shape[1]):
            wrow = int(res.witness_table[ti, c])
            if wrow < 0 or not bool(res.fame_decided[ti, c]):
                continue
            prov.note_fame(keys[wrow], rnum,
                           bool(res.famous[ti, c]), engine=engine)
    prov.mark("prov.capture", engine=engine, rounds=int(res.last_round) + 1)
    return prov


# ----------------------------------------------------------------------
# bisection
# ----------------------------------------------------------------------

class DivergenceBisector:
    """Diff two provenance streams; name the earliest divergent cell.

    Ordering is causal: rounds ascend, and within a round the tables are
    visited in pass order (divide:lastAncestors, divide:witness, fame,
    received) — a wrong witness set explains a wrong fame verdict
    explains a wrong reception, so the first difference in this order is
    the cell to debug. Cell keys tie-break lexicographically, so the
    localization (and its triage artifact) is deterministic."""

    def __init__(self, artifact_dir: str = "docs/artifacts"):
        self.artifact_dir = artifact_dir

    @staticmethod
    def _rounds_of(doc: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
        """Accepts a full `to_json()` doc or a bare `table_doc()`."""
        out: Dict[int, Dict[str, Any]] = {}
        for k, v in doc.get("rounds", {}).items():
            tables = v.get("tables", v if isinstance(v, dict) else {})
            out[int(k)] = {
                "tables": tables,
                "why": v.get("why", {}),
            }
        return out

    def bisect(self, a_name: str, a_doc: Dict[str, Any], b_name: str,
               b_doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Earliest divergent cell between two streams, or None when they
        agree over their common round window. Rounds outside one side's
        retained window (bounded recorder, truncation floor) are not
        comparable and are skipped, not flagged."""
        ra = self._rounds_of(a_doc)
        rb = self._rounds_of(b_doc)
        if not ra or not rb:
            return None
        floor_a = int(a_doc.get("evicted_below", 0))
        floor_b = int(b_doc.get("evicted_below", 0))
        lo = max(min(ra), min(rb), floor_a, floor_b)
        hi = min(max(ra), max(rb))
        for r in range(lo, hi + 1):
            in_a, in_b = r in ra, r in rb
            if not in_a and not in_b:
                continue
            if in_a != in_b:
                return self._loc(
                    r, "divide", "witness", None, a_name, b_name,
                    kind="missing-round",
                    a=("present" if in_a else "absent"),
                    b=("present" if in_b else "absent"),
                )
            ta, tb = ra[r]["tables"], rb[r]["tables"]
            for pass_name, table in PASS_TABLES:
                ca = ta.get(table, {})
                cb = tb.get(table, {})
                if ca == cb:
                    continue
                for key in sorted(set(ca) | set(cb)):
                    if ca.get(key) == cb.get(key):
                        continue
                    kind = ("value-mismatch" if key in ca and key in cb
                            else ("only-" + (a_name if key in ca else b_name)))
                    loc = self._loc(
                        r, pass_name, table, key, a_name, b_name,
                        kind=kind, a=ca.get(key), b=cb.get(key),
                    )
                    wa = ra[r]["why"].get(key, {})
                    wb = rb[r]["why"].get(key, {})
                    if wa or wb:
                        loc["why"] = {a_name: wa, b_name: wb}
                        voter = wa.get("voter") or wb.get("voter")
                        if voter is not None:
                            loc["voter"] = voter
                    return loc
        return None

    @staticmethod
    def _loc(r: int, pass_name: str, table: str, key: Optional[str],
             a_name: str, b_name: str, **extra: Any) -> Dict[str, Any]:
        loc: Dict[str, Any] = {
            "round": r,
            "pass": pass_name,
            "table": table,
            "cell": key,
            "a_name": a_name,
            "b_name": b_name,
        }
        loc.update(extra)
        return loc

    def localize(self, views: List[Tuple[str, Dict[str, Any]]]
                 ) -> Optional[Dict[str, Any]]:
        """First divergence across many streams: every stream is compared
        to the first; the earliest localization (by round, then pass
        order) wins."""
        if len(views) < 2:
            return None
        ref_name, ref_doc = views[0]
        best: Optional[Dict[str, Any]] = None
        order = {pt: i for i, pt in enumerate(PASS_TABLES)}
        for name, doc in views[1:]:
            loc = self.bisect(ref_name, ref_doc, name, doc)
            if loc is None:
                continue
            key = (loc["round"], order.get((loc["pass"], loc["table"]), 99))
            if best is None or key < (
                best["round"], order.get((best["pass"], best["table"]), 99)
            ):
                best = loc
        return best

    # -- artifacts ------------------------------------------------------

    def flight_fields(self, loc: Dict[str, Any]) -> Dict[str, Any]:
        """Compact deterministic field set for the `divergence.localized`
        flight record."""
        cell = loc.get("cell")
        return {
            "round": loc["round"],
            "pass_name": loc["pass"],
            "table": loc["table"],
            "cell": (cell[:18] if isinstance(cell, str) else ""),
            "kind": loc.get("kind", ""),
            "a_name": loc["a_name"],
            "b_name": loc["b_name"],
        }

    def export(self, loc: Dict[str, Any], filename: str,
               context: Optional[Dict[str, Any]] = None,
               directory: Optional[str] = None) -> str:
        """Write the triage artifact. The filename is the caller's and
        must be deterministic (seed/block/label — never timestamps); the
        JSON is canonical sorted-key, so repeat runs are byte-identical."""
        directory = directory if directory is not None else self.artifact_dir
        os.makedirs(directory, exist_ok=True)
        doc = {
            "kind": "babble-tpu-divergence-localization",
            "localized": loc,
            "context": dict(context or {}),
        }
        path = os.path.join(directory, filename)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path


def bisect_pass_results(grid, a_name: str, res_a, b_name: str, res_b,
                        artifact_dir: str = "docs/artifacts",
                        label: str = "bench") -> Tuple[Optional[Dict[str, Any]],
                                                       Optional[str]]:
    """Bench byte-equality gate hook: capture both engines' PassResults
    against the same grid, bisect, export the triage artifact. Returns
    (localization, artifact_path) — (None, None) when the streams agree
    (the arrays differed some other way, e.g. padding)."""
    prov_a = capture_pass_results(grid, res_a, engine=a_name)
    prov_b = capture_pass_results(grid, res_b, engine=b_name)
    bis = DivergenceBisector(artifact_dir)
    loc = bis.bisect(a_name, prov_a.to_json(), b_name, prov_b.to_json())
    if loc is None:
        return None, None
    path = bis.export(
        loc, f"bisect-{label}-{a_name}-vs-{b_name}.json",
        context={"label": label},
    )
    return loc, path


# ----------------------------------------------------------------------
# CI smoke (scripts/ci_lint.sh: 3-seed bisector self-test)
# ----------------------------------------------------------------------

def _smoke_recorder(seed: int) -> ProvenanceRecorder:
    """A deterministic synthetic stream: N witnesses per round over a few
    rounds, cells derived from a seeded PRNG (stdlib random so the smoke
    stays jax-free and sub-second)."""
    import random

    rng = random.Random(seed)
    prov = ProvenanceRecorder(node_id=0)
    n = 4
    for r in range(6):
        for c in range(n):
            h = "%016x" % rng.getrandbits(64)
            prov.note_event(h, r, r * n + c,
                            [rng.randrange(16) for _ in range(n)])
            prov.note_witness(h, r, c)
            prov.note_fame(h, r, rng.random() < 0.8, engine="smoke",
                           voter="%016x" % rng.getrandbits(64),
                           yays=3, nays=0, step=2)
        if r >= 2:
            prov.settle_round(r - 2)
    return prov


def run_bisector_smoke(seeds: int = 3) -> List[str]:
    """Per seed: identical streams must bisect to None; one seeded
    single-cell fame flip must localize to exactly that cell. Returns
    failure strings (empty == pass)."""
    import random

    failures: List[str] = []
    bis = DivergenceBisector()
    for seed in range(seeds):
        clean = _smoke_recorder(seed)
        if bis.bisect("a", clean.to_json(), "b",
                      _smoke_recorder(seed).to_json()) is not None:
            failures.append(f"seed {seed}: clean streams reported divergent")
            continue
        mutated = _smoke_recorder(seed)
        rng = random.Random(seed + 1000)
        target_round = rng.randrange(3, 6)
        rp = mutated.round_provenance(target_round)
        target_cell = sorted(rp.tables["fame"])[
            rng.randrange(len(rp.tables["fame"]))
        ]
        rp.tables["fame"][target_cell] = not rp.tables["fame"][target_cell]
        loc = bis.bisect("clean", clean.to_json(),
                         "mutated", mutated.to_json())
        if loc is None:
            failures.append(f"seed {seed}: injected flip not detected")
        elif (loc["round"], loc["table"], loc["cell"]) != (
            target_round, "fame", target_cell
        ):
            failures.append(
                f"seed {seed}: localized {loc['round']}/{loc['table']}/"
                f"{loc['cell']} != injected {target_round}/fame/{target_cell}"
            )
    return failures
