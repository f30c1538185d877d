# Copy of set_seed from murmura_tpu/utils/seed.py.
"""Seeding of the host-side generators.

Every random stream of a round is a generator seeded from (seed, round)
(core/rounds.py ``round_generators``), so there is no hidden framework
state to pin; this seeds the host-side generators that partitioners,
topology generation and attack selection may read.
"""

import random

import numpy as np


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
