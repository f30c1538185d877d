"""One round of the char-LSTM (here) and of the CelebA CNN
(tests/test_torch_models_rounds_cnn.py, which takes the helpers from here:
each JAX round compile is one file's cost, and --dist loadfile spreads the
two) through the PyTorch port's round program against the JAX package's
round, on the CPU.

8 nodes on k-regular(4), 25% gaussian attack (std 10), from one spread
initial state (node 0's parameters plus offsets of distinct scales, so
that no Krum pick sits on a float32 tie), the JAX round's own draws (its
epoch shuffle ``u`` and attack noise, split from the round key as
murmura_tpu/core/rounds.py splits it) fed to the port.  The JAX side is
its round's stages on the same inputs: the program's ``train_flat`` (the
trained rows, one compile a model), its attack, and each rule's
``aggregate``: Krum dense, Krum circulant (ppermute's offsets) and the
circulant median.  The port runs its whole ``train_step`` a rule.

Held: the trained rows and the post-round parameters within a scaled 1e-4,
Krum's picks equal and Krum selecting (not its own-state fallback), the
median's ``agg_*`` stats equal.  The LSTM round's tokens are int64 from
the adapter's int32 arrays to the embedding (training, probe and eval
batches); the CelebA round's images float32.  The models run at narrow
widths (hidden 16, seq_len 12; 8x8 images, channels 2-4-4, whose JAX
round compiles in a fraction of the time a wider one takes); the published
widths are held in tests/test_torch_models_surface.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.cnn import make_celeba_cnn as jax_celeba
from murmura_tpu.models.lstm import make_char_lstm as jax_lstm
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.cnn import make_celeba_cnn
from murmura_tpu_torch.models.lstm import make_char_lstm

N = 8
SEED = 3
OFFSETS = [1, 2, 6, 7]
HP = dict(local_epochs=1, batch_size=8, lr=0.05, seed=SEED)
RULES = {
    "krum_dense": ("krum", {"num_compromised": 1, "max_candidates": 5}),
    "krum_circulant": ("krum", {"num_compromised": 1, "exchange_offsets": OFFSETS}),
    "median_circulant": ("median", {"exchange_offsets": OFFSETS}),
}
MODELS = {
    "lstm": (("synthetic_sequences", {"num_samples": 160, "seq_len": 12, "vocab_size": 20}),
             dict(vocab_size=20, embed_dim=8, hidden=16, seq_len=12),
             jax_lstm, make_char_lstm),
    "celeba": (("synthetic", {"num_samples": 160, "input_shape": [8, 8, 3],
                              "num_classes": 2}),
               dict(image_size=8, channels=(2, 4, 4), fc_dim=8),
               jax_celeba, make_celeba_cnn),
}


def _scaled_delta(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _spread(jprog):
    rng = np.random.default_rng(SEED)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)


def jax_round_stages(name):
    """The JAX round's stages for one model: (name, data, init, comp, key,
    trained rows, broadcast, adjacency)."""
    (adapter, params), widths, jax_make, _ = MODELS[name]
    data = jax_data(adapter, params, num_nodes=N, seed=SEED)
    jattack = jax_gaussian(N, 0.25, noise_std=10.0, seed=SEED)
    jprog = jax_build_round(jax_make(**widths), JAX_AGGREGATORS["fedavg"](), data,
                            attack=jattack, **HP)
    init = _spread(jprog)
    adj = jnp.asarray(np.asarray(
        [[1.0 if (j - i) % N in OFFSETS else 0.0 for j in range(N)] for i in range(N)],
        np.float32))
    comp = jattack.compromised.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    own, _ = jax.jit(jprog.train_flat)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key, adj,
        jnp.asarray(comp), jnp.asarray(0.0, jnp.float32),
        {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()})
    _, attack_key = jax.random.split(key)
    bcast = jattack.apply(own, jnp.asarray(comp), attack_key, jnp.asarray(0.0, jnp.float32))
    return name, data, init, comp, key, own, bcast.astype(own.dtype), adj


def _port_draws(key, mask_shape, n_comp, model_dim):
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    return {"u": [np.array(jax.random.uniform(perm_key, mask_shape))],
            "noise": np.array(jax.random.normal(attack_key, (n_comp, model_dim)))}


def check_round(stages, rule):
    """The port's round of ``rule`` against the JAX round's ``stages``."""
    name, data, init, comp, key, own, bcast, adj = stages
    algorithm, params = RULES[rule]
    jagg = JAX_AGGREGATORS[algorithm](**params)
    j_new, _, j_stats = jax.jit(lambda o, b, a, st: jagg.aggregate(
        o, b, a, jnp.asarray(0.0, jnp.float32), st, JaxCtx(apply_fn=None, unravel=None)))(
        own, bcast, adj, jagg.init_state(N))
    widths, make = MODELS[name][1], MODELS[name][3]
    prog = build_round_program(
        make(**widths), AGGREGATORS[algorithm](**params), data,
        attack=make_gaussian_attack(N, 0.25, noise_std=10.0, seed=SEED),
        init_params=init, device="cpu", **HP)
    init_ref = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(init))
    assert np.array_equal(prog.init_flat.numpy(), init_ref)
    want = torch.int64 if name == "lstm" else torch.float32
    for k in ("x", "probe_x", "eval_x"):
        assert prog.data[k].dtype == want, k
    draws = _port_draws(key, tuple(prog.data["mask"].shape), int(comp.sum()), prog.model_dim)
    tadj = torch.from_numpy(np.array(adj))
    trained, _ = prog.train_flat(prog.init_flat, prog.init_agg_state, tadj,
                                 torch.from_numpy(comp), 0.0, draws=draws)
    assert _scaled_delta(trained.numpy(), own) <= 1e-4
    flat, _, metrics = prog.train_step(prog.init_flat, prog.init_agg_state, tadj,
                                       torch.from_numpy(comp), 0.0, draws=draws)
    assert _scaled_delta(flat.numpy(), j_new) <= 1e-4
    if algorithm == "krum":
        assert np.array_equal(metrics["agg_selected_index"].numpy(),
                              np.asarray(j_stats["selected_index"]))
        assert not bool(metrics["agg_selected_own"].all())
    else:
        for k, v in j_stats.items():
            np.testing.assert_array_equal(metrics[f"agg_{k}"].numpy(), np.asarray(v), err_msg=k)
    ev = prog.eval_step(flat)
    assert all(bool(torch.isfinite(v).all()) for v in ev.values())


@pytest.fixture(scope="module")
def lstm_stages():
    return jax_round_stages("lstm")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_one_round_matches_jax(lstm_stages, rule):
    check_round(lstm_stages, rule)
