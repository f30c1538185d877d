"""Cohort streaming over a virtual population (the PyTorch counterpart of
murmura_tpu/population/):

- :mod:`sampler`: cohort draws, a pure function of (seed, draw index);
- :mod:`bank`: the lazily initialised per-user rows on the host;
- :mod:`engine`: :class:`PopulationNetwork`, the cohort-streaming
  orchestrator with its double-buffered swap.
"""

from murmura_tpu_torch.population.bank import PopulationBank
from murmura_tpu_torch.population.engine import PopulationNetwork, PopulationSpec
from murmura_tpu_torch.population.sampler import SAMPLERS, draw_cohort

__all__ = [
    "PopulationBank",
    "PopulationNetwork",
    "PopulationSpec",
    "SAMPLERS",
    "draw_cohort",
]
