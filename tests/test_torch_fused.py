"""Fused multi-round dispatch (``tpu.rounds_per_dispatch``) in the port, on
the CPU, and what a dropped Network leaves behind.

- A fused run's history, final parameters and carried state are bit-equal
  to per-round dispatch of the same config: a ragged last chunk, an
  ``eval_every`` that cuts across chunks, the faulted chaos_churn.yaml,
  the int8 and top-k codecs carrying their residual and reference, and
  the tiny flagship through the CLI with ``tpu.rounds_per_dispatch: 2``;
  splitting the rounds across ``train`` calls changes no number either.
- The port's fused history of chaos_churn.yaml has the JAX package's fused
  history's keys and rounds, its ``agg_alive`` and ``agg_quarantined``
  exactly, and its accuracy within the band of tests/test_torch_slice.py
  (the two packages draw from independent RNGs).
- A dropped Network frees its parameters at once, without the cycle
  collector (checked in a fresh interpreter with the collector off).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from murmura_tpu.config import load_config as jax_load_config
from murmura_tpu.utils.factories import build_network_from_config as jax_build_network
from murmura_tpu_torch import cli
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "examples" / "configs"
ACCURACY_BAND = 0.15


def _config(name, **compression):
    config = load_config(CONFIGS / f"{name}.yaml")
    config.experiment.verbose = False
    for k, v in compression.items():
        setattr(config.compression, k, v)
    return config


CASES = {
    # case: (config, compression overrides, rounds, rounds_per_dispatch, eval_every)
    "ragged_last_chunk": ("compressed_exchange", {}, 5, 2, 1),
    "eval_every_across_chunks": ("compressed_exchange", {}, 7, 3, 2),
    "faulted_chaos_churn": ("chaos_churn", {}, 5, 2, 1),
    "int8_residual": ("compressed_exchange", {"block": 64}, 4, 4, 1),
    "topk_residual_and_reference": (
        "compressed_exchange", {"algorithm": "topk", "topk_ratio": 0.05}, 5, 3, 1),
}


def _assert_same_run(a, b):
    assert a.history == b.history
    assert torch.equal(a.flat, b.flat)
    assert set(a.agg_state) == set(b.agg_state)
    for k in a.agg_state:
        assert torch.equal(a.agg_state[k], b.agg_state[k]), k
    assert a.current_round == b.current_round


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_per_round(case):
    name, compression, rounds, chunk, eval_every = CASES[case]
    per_round = build_network_from_config(_config(name, **compression), device="cpu")
    per_round.train(rounds, eval_every=eval_every)
    fused = build_network_from_config(_config(name, **compression), device="cpu")
    fused.train(rounds, eval_every=eval_every, rounds_per_dispatch=chunk)
    _assert_same_run(per_round, fused)
    assert per_round.history["round"] == list(range(eval_every, rounds + 1, eval_every))
    assert len(fused.round_times) == rounds
    # One amortised time a round: equal within a chunk.
    for c0 in range(0, rounds, chunk):
        assert len(set(fused.round_times[c0:c0 + chunk])) == 1
    keys = {"compressed_exchange": ("agg_compress_error", "agg_compress_residual_norm"),
            "chaos_churn": ("agg_alive", "agg_quarantined", "agg_attack_scrubbed")}[name]
    for k in keys:
        assert len(fused.history[k]) == len(fused.history["round"]), k


def test_split_train_calls_change_no_number():
    ref = build_network_from_config(_config("chaos_churn"), device="cpu")
    ref.train(5)
    got = build_network_from_config(_config("chaos_churn"), device="cpu")
    got.train(1)
    got.train(3, rounds_per_dispatch=2)
    got.train(1, rounds_per_dispatch=3)
    _assert_same_run(ref, got)
    assert len(got.round_times) == 5


def test_flagship_cli_fused_equals_per_round(tmp_path):
    raw = yaml.safe_load((CONFIGS / "femnist_krum_tpu.yaml").read_text())
    raw["experiment"].update(rounds=4, verbose=False)
    raw["model"]["factory"] = "leaf.femnist.tiny"
    raw["data"]["params"] = {"num_samples": 16 * 40}
    raw["training"].update(local_epochs=1, batch_size=16)
    runs = {}
    for k in (1, 2):
        raw["tpu"]["rounds_per_dispatch"] = k
        path = tmp_path / f"flagship_rpd{k}.yaml"
        path.write_text(yaml.safe_dump(raw))
        runs[k] = cli.run(path, output=tmp_path / f"h{k}.json", device="cpu")
    (h1, n1), (h2, n2) = runs[1], runs[2]
    assert h1 == h2 and h1["round"] == [1, 2, 3, 4]
    _assert_same_run(n1, n2)
    assert n2.round_times[0] == n2.round_times[1] and n2.round_times[2] == n2.round_times[3]


def test_fused_history_matches_jax_fused():
    rounds, chunk = 4, 2
    got = build_network_from_config(_config("chaos_churn"), device="cpu").train(
        rounds, rounds_per_dispatch=chunk)
    jcfg = jax_load_config(CONFIGS / "chaos_churn.yaml")
    jcfg.experiment.verbose = False
    ref = jax_build_network(jcfg).train(rounds, rounds_per_dispatch=chunk)
    assert set(got) == set(ref)
    assert got["round"] == ref["round"] == [1, 2, 3, 4]
    for k in ("agg_alive", "agg_quarantined", "agg_attack_scrubbed"):
        assert got[k] == ref[k], k
    assert all(math.isfinite(v) for v in got["mean_loss"])
    for k in ("mean_accuracy", "honest_accuracy"):
        assert abs(got[k][-1] - ref[k][-1]) <= ACCURACY_BAND, k


_DROP = r"""
import gc, sys, weakref
gc.disable()
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.utils.factories import build_network_from_config
config = load_config(sys.argv[1])
config.experiment.verbose = False
for dispatch in (1, 2, 1):
    network = build_network_from_config(config, device="cpu")
    network.train(2, rounds_per_dispatch=dispatch)
    flat, state = weakref.ref(network.flat), weakref.ref(network.agg_state["compress_residual"])
    del network
    assert flat() is None and state() is None, dispatch
print("freed")
"""


def test_dropped_network_frees_its_parameters_without_gc():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _DROP, str(CONFIGS / "compressed_exchange.yaml")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "freed" in proc.stdout, proc.stdout + proc.stderr[-3000:]
