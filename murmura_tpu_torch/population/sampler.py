# Copy of murmura_tpu/population/sampler.py.
"""Seed-deterministic cohort sampling over a virtual population.

Every draw is a pure function of ``(seed, draw_index)`` — two processes
(or a crashed-and-restarted one) reconstruct the identical cohort sequence
with zero communication, the same determinism contract the fault schedule
(faults/schedule.py) and the mobility model already carry.  numpy's
``SeedSequence([seed, draw_idx])`` keys an independent, collision-resistant
stream per draw, so draw ``r`` never depends on having generated draws
``0..r-1`` first (a resumed run at round 1000 pays O(1), not O(rounds)).

Samplers (the ``population.sampler`` schema enum — MUR602 pins the
bijection with this registry):

- ``uniform``: cohort drawn uniformly without replacement from all U users.
- ``stratified``: the user-id space is split into ``cohort_size``
  contiguous strata and one user drawn per stratum — every region of the
  population is touched every round, and slot ``j`` always hosts a user
  from stratum ``j`` (useful when user ids encode a meaningful partition,
  e.g. geography or device class).
"""

from typing import Callable, Dict

import numpy as np


def _rng(seed: int, draw_idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(draw_idx)]))


def uniform_cohort(
    virtual_size: int, cohort_size: int, draw_idx: int, seed: int
) -> np.ndarray:
    """[cohort_size] int64 user ids, uniform without replacement."""
    return _rng(seed, draw_idx).choice(
        virtual_size, size=cohort_size, replace=False
    ).astype(np.int64)


def stratified_cohort(
    virtual_size: int, cohort_size: int, draw_idx: int, seed: int
) -> np.ndarray:
    """[cohort_size] int64 user ids, one per contiguous id stratum."""
    bounds = np.linspace(0, virtual_size, cohort_size + 1).astype(np.int64)
    rng = _rng(seed, draw_idx)
    lo, hi = bounds[:-1], bounds[1:]
    # Every stratum is non-empty (virtual_size >= cohort_size, schema-
    # validated), so hi > lo holds and the draw is well-defined.
    return (lo + rng.integers(0, hi - lo)).astype(np.int64)


SAMPLERS: Dict[str, Callable[[int, int, int, int], np.ndarray]] = {
    "uniform": uniform_cohort,
    "stratified": stratified_cohort,
}


def draw_cohort(
    sampler: str, virtual_size: int, cohort_size: int, draw_idx: int, seed: int
) -> np.ndarray:
    """One cohort draw — pure in (sampler, sizes, draw_idx, seed)."""
    if sampler not in SAMPLERS:
        raise ValueError(
            f"unknown population sampler {sampler!r} "
            f"(registered: {sorted(SAMPLERS)})"
        )
    if not 0 < cohort_size <= virtual_size:
        raise ValueError(
            f"cohort_size={cohort_size} must be in (0, virtual_size="
            f"{virtual_size}]"
        )
    return SAMPLERS[sampler](virtual_size, cohort_size, draw_idx, seed)
