"""Web-admin gamification: achievements, XP levels, streaks.

Capability parity with the reference's dashboard gamification
(neumann_server/src/gamification/{achievements,progress}.rs): a static
achievement catalog (tiers bronze->platinum, categories, optional
count thresholds, hidden entries), per-user progress with an XP level
curve, day streaks, and unlock evaluation driven by the router's
query metrics.

The port's copy of ``neumann_tpu/server/gamification.py``, unchanged.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

TIERS = ("bronze", "silver", "gold", "platinum")
TIER_XP = {"bronze": 50, "silver": 150, "gold": 400, "platinum": 1000}
CATEGORIES = ("discovery", "performance", "mastery", "dedication")


@dataclass(frozen=True)
class Achievement:
    id: str
    name: str
    description: str
    tier: str
    category: str
    threshold: Optional[int] = None
    hidden: bool = False

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name,
                "description": self.description, "tier": self.tier,
                "category": self.category, "threshold": self.threshold,
                "hidden": self.hidden}


ACHIEVEMENTS: List[Achievement] = [
    # discovery
    Achievement("first_query", "Hello, Neumann", "Run your first query",
                "bronze", "discovery"),
    Achievement("first_vector", "Nearest Neighbor",
                "Run your first SIMILAR search", "bronze", "discovery"),
    Achievement("first_graph", "Six Degrees",
                "Create your first graph edge", "bronze", "discovery"),
    Achievement("first_table", "Schema Author",
                "Create your first table", "bronze", "discovery"),
    Achievement("all_engines", "Unified Theory",
                "Touch the relational, graph, and vector engines in one "
                "session", "silver", "discovery"),
    Achievement("hybrid_query", "Connected Thinking",
                "Run a SIMILAR ... CONNECTED TO hybrid query", "silver",
                "discovery"),
    # performance
    Achievement("queries_100", "Centurion", "Run 100 queries", "bronze",
                "performance", threshold=100),
    Achievement("queries_1000", "Kiloquery", "Run 1,000 queries",
                "silver", "performance", threshold=1000),
    Achievement("queries_10000", "Megamind", "Run 10,000 queries",
                "gold", "performance", threshold=10000),
    Achievement("sub_ms", "MXU Whisperer",
                "Run a query that completes in under 1 ms", "silver",
                "performance"),
    # mastery
    Achievement("embeddings_1000", "Corpus Builder",
                "Store 1,000 embeddings", "silver", "mastery",
                threshold=1000),
    Achievement("embeddings_100000", "HBM Resident",
                "Store 100,000 embeddings", "gold", "mastery",
                threshold=100_000),
    Achievement("cypher_user", "Pattern Matcher",
                "Run a Cypher MATCH", "silver", "mastery"),
    Achievement("checkpointer", "Time Traveler",
                "Roll back to a checkpoint", "gold", "mastery",
                hidden=True),
    # dedication
    Achievement("streak_3", "Warming Up", "A 3-day usage streak",
                "bronze", "dedication", threshold=3),
    Achievement("streak_7", "Regular", "A 7-day usage streak", "silver",
                "dedication", threshold=7),
    Achievement("streak_30", "Devoted", "A 30-day usage streak",
                "platinum", "dedication", threshold=30),
]

_BY_ID = {a.id: a for a in ACHIEVEMENTS}


def get_achievement(aid: str) -> Optional[Achievement]:
    return _BY_ID.get(aid)


def xp_for_level(level: int) -> int:
    """Total XP needed to REACH a level (quadratic curve)."""
    return 100 * (level - 1) * level // 2 if level > 1 else 0


@dataclass
class UserProgress:
    xp: int = 0
    unlocked: Set[str] = field(default_factory=set)
    queries: int = 0
    best_latency_ms: float = float("inf")
    streak_days: int = 0
    last_day: Optional[int] = None
    engines_used: Set[str] = field(default_factory=set)

    @property
    def level(self) -> int:
        lvl = 1
        while self.xp >= xp_for_level(lvl + 1):
            lvl += 1
        return lvl

    def level_progress(self) -> dict:
        lvl = self.level
        base, nxt = xp_for_level(lvl), xp_for_level(lvl + 1)
        return {"level": lvl, "xp": self.xp,
                "into_level": self.xp - base,
                "needed": nxt - base}

    def unlock(self, aid: str) -> int:
        """Unlock by id; returns XP awarded (0 if already unlocked)."""
        a = _BY_ID.get(aid)
        if a is None or aid in self.unlocked:
            return 0
        self.unlocked.add(aid)
        gained = TIER_XP[a.tier]
        self.xp += gained
        return gained

    def update_streak(self, day: int) -> None:
        """day = days-since-epoch; consecutive days grow the streak."""
        if self.last_day is None or day - self.last_day > 1:
            self.streak_days = 1
        elif day - self.last_day == 1:
            self.streak_days += 1
        self.last_day = day
        for n in (3, 7, 30):
            if self.streak_days >= n:
                self.unlock(f"streak_{n}")


class ProgressTracker:
    """Derives unlocks from live query activity (thread-safe)."""

    _ENGINE_KINDS = {
        "relational": ("Select", "Insert", "CreateTable", "Update",
                       "Delete"),
        "graph": ("NodeCreate", "EdgeCreate", "Neighbors", "Traverse",
                  "Cypher"),
        "vector": ("Similar", "EmbedStore", "Find"),
    }

    def __init__(self):
        self.progress = UserProgress()
        self._lock = threading.Lock()

    def record(self, kind: str, latency_ms: float,
               connected_to: bool = False) -> List[str]:
        """Record one executed statement; returns newly unlocked ids."""
        with self._lock:
            p = self.progress
            before = set(p.unlocked)
            p.queries += 1
            p.best_latency_ms = min(p.best_latency_ms, latency_ms)
            p.unlock("first_query")
            for engine, kinds in self._ENGINE_KINDS.items():
                if kind in kinds:
                    p.engines_used.add(engine)
            if kind == "Similar":
                p.unlock("first_vector")
            if kind == "EdgeCreate":
                p.unlock("first_graph")
            if kind == "CreateTable":
                p.unlock("first_table")
            if kind == "Cypher":
                p.unlock("cypher_user")
            if kind == "CheckpointRollback":
                p.unlock("checkpointer")
            if connected_to:
                p.unlock("hybrid_query")
            if len(p.engines_used) == 3:
                p.unlock("all_engines")
            if latency_ms < 1.0:
                p.unlock("sub_ms")
            for t in (100, 1000, 10000):
                if p.queries >= t:
                    p.unlock(f"queries_{t}")
            return sorted(p.unlocked - before)

    def record_embeddings(self, total: int) -> None:
        with self._lock:
            for t in (1000, 100_000):
                if total >= t:
                    self.progress.unlock(f"embeddings_{t}")

    def snapshot(self) -> dict:
        with self._lock:
            p = self.progress
            return {
                **p.level_progress(),
                "queries": p.queries,
                "streak_days": p.streak_days,
                "unlocked": sorted(p.unlocked),
                "achievements": [
                    {**a.as_dict(),
                     "unlocked": a.id in p.unlocked}
                    for a in ACHIEVEMENTS
                    if not a.hidden or a.id in p.unlocked],
            }
