"""``murmura_tpu_torch.utils.seed.set_seed`` against the JAX package's: after
either package's ``set_seed(s)`` the host generators it seeds (``random``
and ``numpy.random``) draw the same values, and it seeds nothing else (the
torch generator is left as it was)."""

import random

import numpy as np
import pytest
import torch

from murmura_tpu.utils.seed import set_seed as jax_set_seed
from murmura_tpu_torch.utils.seed import set_seed


def _draws():
    return (random.random(), random.randrange(10 ** 9), np.random.rand(4).tolist(),
            np.random.permutation(16).tolist())


@pytest.mark.parametrize("seed", [0, 42, 7 + 3])
def test_set_seed_draws_equal_the_jax_packages(seed):
    jax_set_seed(seed)
    ref = _draws()
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    set_seed(seed)
    assert _draws() == ref
    # The torch stream is not touched, as the JAX package has none.
    assert torch.equal(torch.rand(3), before)
