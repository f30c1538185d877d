"""One round of the CelebA CNN through the PyTorch port's round program
against the JAX package's round, on the CPU: the setting, the JAX stages
and the checks are tests/test_torch_models_rounds.py's."""

import pytest

from test_torch_models_rounds import RULES, check_round, jax_round_stages


@pytest.fixture(scope="module")
def celeba_stages():
    return jax_round_stages("celeba")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_one_round_matches_jax(celeba_stages, rule):
    check_round(celeba_stages, rule)
