"""Deterministic workload generators: zipfian hot-sets, size distributions,
and full op sequences.

Replay identity is the contract: the same scenario + seed must produce the
byte-identical op sequence on every machine and every run, so a report
diff across PRs compares the system, not the dice. Everything here draws
from one `random.Random(seed)` in one fixed order; op generation is
pre-run (a list), never interleaved with execution timing.

The zipfian generator is the YCSB construction (Gray et al.'s bounded
zipfian via the zeta closed form): rank popularity follows 1/rank^theta,
and a seeded permutation scrambles ranks onto key ids so "hot" keys are
spread across the namespace instead of clustering at key_0..key_k (which
would alias with any prefix-sharded placement).
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import NamedTuple

from .spec import Phase, Scenario


class ZipfianGenerator:
    """Bounded zipfian over ranks [0, n) with parameter theta in [0, 1).

    theta=0 degenerates to uniform; theta->1 concentrates mass on the head
    (YCSB default 0.99 gives ~10% of keys ~60% of traffic at n=256).
    """

    def __init__(self, n: int, theta: float, rng: random.Random,
                 perm_rng: random.Random | None = None):
        if n <= 0:
            raise ValueError("zipfian needs n > 0")
        if not (0.0 <= theta < 1.0):
            raise ValueError("theta must be in [0, 1)")
        self.n = n
        self.theta = theta
        self._rng = rng
        if theta > 0.0:
            self._zetan = sum(1.0 / (i + 1) ** theta for i in range(n))
            self._alpha = 1.0 / (1.0 - theta)
            zeta2 = sum(1.0 / (i + 1) ** theta for i in range(min(2, n)))
            self._eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / self._zetan)
        # Scramble ranks -> key ids so the hot set is namespace-spread.
        # perm_rng (when given) decouples WHICH keys are hot from the draw
        # stream: phases seeded differently still agree on the hot set, so
        # a warmed cache phase actually re-reads the keys that warmed it.
        self._perm = list(range(n))
        (perm_rng or rng).shuffle(self._perm)

    def next_rank(self) -> int:
        """Next popularity rank (0 = hottest)."""
        if self.theta <= 0.0:
            return self._rng.randrange(self.n)
        u = self._rng.random()
        uz = u * self._zetan
        if uz < 1.0:
            return 0
        if uz < 1.0 + 0.5 ** self.theta:
            return 1
        return int(self.n * (self._eta * u - self._eta + 1.0) ** self._alpha)

    def next_key(self) -> int:
        """Next key id in [0, n) (rank scrambled through the permutation)."""
        rank = self.next_rank()
        if rank >= self.n:  # closed-form rounding can land exactly on n
            rank = self.n - 1
        return self._perm[rank]


class SizeDistribution:
    """Object-size sampler built from a validated `sizes` spec dict."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.kind = spec.get("kind", "fixed")
        if self.kind == "choice":
            self._choices = [int(c["bytes"]) for c in spec["choices"]]
            self._weights = [float(c.get("weight", 1.0)) for c in spec["choices"]]

    def sample(self, rng: random.Random) -> int:
        if self.kind == "fixed":
            return int(self.spec["bytes"])
        if self.kind == "uniform":
            return rng.randint(int(self.spec["min"]), int(self.spec["max"]))
        if self.kind == "lognormal":
            mean = float(self.spec["mean"])
            sigma = float(self.spec.get("sigma", 1.0))
            # Parameterized by the distribution MEAN (what operators state),
            # so mu = ln(mean) - sigma^2/2.
            mu = math.log(mean) - sigma * sigma / 2.0
            v = int(rng.lognormvariate(mu, sigma))
            lo = int(self.spec.get("min", 1))
            hi = int(self.spec.get("max", 1 << 30))
            return min(max(v, lo), hi)
        return rng.choices(self._choices, weights=self._weights, k=1)[0]


class Op(NamedTuple):
    index: int
    kind: str       # GET/PUT/DELETE/LIST/MULTIPART/SELECT
    key: str        # object key ("" for LIST)
    size: int       # payload bytes (PUT/MULTIPART total; 0 otherwise)
    prefix: str     # list prefix (LIST only)


def _key_name(scenario: Scenario, kid: int) -> str:
    return f"{scenario.prefix}key-{kid:06d}"


def generate_ops(scenario: Scenario, phase: Phase, count: int) -> list[Op]:
    """The deterministic op sequence for one phase.

    Maintains a model of which keys exist (prepopulated set, mutated by
    PUT/DELETE as generated) so GET/DELETE/SELECT target keys that should
    exist at that point of the replay -- a generator that GETs
    never-written keys measures the 404 path, not the read path. Zipf
    draws landing on absent keys redraw (bounded), then fall back to the
    hottest existing key; with an empty keyspace the op degrades to PUT.
    """
    seed = (scenario.seed * 1_000_003 + _phase_ordinal(scenario, phase)) & 0x7FFFFFFF
    rng = random.Random(seed)
    theta = scenario.zipf_theta if phase.zipf_theta is None else phase.zipf_theta
    # The rank->key permutation is scenario-seeded (NOT phase-seeded): the
    # hot set is a property of the workload, stable across phases.
    zipf = ZipfianGenerator(
        scenario.keys, theta, rng, perm_rng=random.Random(scenario.seed ^ 0x5A1F)
    )
    sizes = SizeDistribution(phase.sizes or scenario.sizes)
    kinds = sorted(phase.mix)
    weights = [phase.mix[k] for k in kinds]
    existing = set(range(min(scenario.prepopulate, scenario.keys)))
    ops: list[Op] = []
    for i in range(count):
        kind = rng.choices(kinds, weights=weights, k=1)[0]
        key = ""
        size = 0
        prefix = ""
        if kind == "LIST":
            prefix = scenario.prefix
        else:
            kid = zipf.next_key()
            if kind in ("PUT", "MULTIPART"):
                existing.add(kid)
            else:  # GET/DELETE/SELECT need a live key
                if kid not in existing:
                    for _ in range(8):
                        kid = zipf.next_key()
                        if kid in existing:
                            break
                    else:
                        kid = min(existing) if existing else -1
                if kid < 0:
                    kind, kid = "PUT", zipf.next_key()
                    existing.add(kid)
            if kind == "DELETE":
                existing.discard(kid)
            key = _key_name(scenario, kid)
            if kind == "PUT":
                size = sizes.sample(rng)
            elif kind == "MULTIPART":
                size = scenario.multipart_parts * scenario.multipart_part_size
        ops.append(Op(i, kind, key, size, prefix))
    return ops


def _phase_ordinal(scenario: Scenario, phase: Phase) -> int:
    for i, p in enumerate(scenario.phases):
        if p is phase or p.name == phase.name:
            return i
    return len(scenario.phases)


def op_sequence_hash(ops: list[Op]) -> str:
    """sha256 over the canonical op tuples -- the replay-identity witness
    two same-seed runs must agree on."""
    h = hashlib.sha256()
    for op in ops:
        h.update(f"{op.index}|{op.kind}|{op.key}|{op.size}|{op.prefix}\n".encode())
    return h.hexdigest()
