"""The port's CLI against the JAX package's on the cut-down flagship, on
the CPU (split from tests/test_torch_slice.py so that --dist loadfile runs
these two long subprocess tests beside that file's others).

- ``python -m murmura_tpu_torch run <yaml> --device cpu`` against
  ``python -m murmura_tpu run <yaml>`` on a cut-down flagship (the committed
  femnist_krum_tpu.yaml with the tiny CNN, fewer and easier samples, six
  rounds): both exit 0, their history JSON has the same keys, and the
  port's accuracy climbs to within a stated band of the JAX package's.
  The two packages draw their shuffles and noise from independent RNGs, so
  the trajectories are compared in a band, not value for value.
- The tiny flagship with ``aggregation: sketchguard`` (carried state, the
  ``total_rounds`` schedule) runs through both CLIs with the same history
  keys, the same acceptance and accuracy in the same band.
"""

from test_torch_slice import ACCURACY_BAND, MIN_CLIMB, _run, _tiny_flagship


def test_cli_matches_jax_package(tmp_path):
    ref = _run("murmura_tpu", _tiny_flagship(tmp_path, "allgather"), tmp_path / "jax.json")
    got = {
        ex: _run("murmura_tpu_torch", _tiny_flagship(tmp_path, ex),
                 tmp_path / f"torch_{ex}.json", "--device", "cpu")
        for ex in ("allgather", "ppermute")
    }
    for hist in got.values():
        assert set(hist) == set(ref)
        assert hist["round"] == ref["round"] == list(range(1, 7))
        acc = hist["mean_accuracy"]
        assert acc[-1] - acc[0] >= MIN_CLIMB, acc
        assert abs(acc[-1] - ref["mean_accuracy"][-1]) <= ACCURACY_BAND
        assert abs(hist["honest_accuracy"][-1] - ref["honest_accuracy"][-1]) <= ACCURACY_BAND
    # num_compromised 3 with 4 neighbours fails Krum's c < (m-2)/2, so every
    # node keeps its own state in both exchange modes and the two runs
    # train identically.
    assert got["allgather"]["agg_selected_own"] == [1.0] * 6
    assert got["allgather"]["mean_accuracy"] == got["ppermute"]["mean_accuracy"]


def test_sketchguard_cli_matches_jax_package(tmp_path):
    # Every node starts from its own random initialisation, so averaging
    # with neighbours holds the accuracy near chance for these few rounds in
    # both packages (Krum above keeps each node's own state and climbs);
    # the check is the filter's decisions and the band.
    cfg = _tiny_flagship(tmp_path, "allgather", "sketchguard", rounds=4)
    ref = _run("murmura_tpu", cfg, tmp_path / "jax.json")
    got = _run("murmura_tpu_torch", cfg, tmp_path / "torch.json", "--device", "cpu")
    assert set(got) == set(ref)
    assert got["round"] == ref["round"] == list(range(1, 5))
    # The three std-10 senders are rejected by each of their 4 receivers, so
    # at most 52 of the 64 edges are accepted in any round.  The honest
    # edges' distances follow each package's own training draws, so the two
    # may part on an edge or two near the decaying threshold.
    for hist in (got, ref):
        assert max(hist["agg_acceptance_rate"]) <= 52 / 64
    assert got["agg_acceptance_rate"][0] == ref["agg_acceptance_rate"][0] == 52 / 64
    assert all(abs(a - b) <= 2 / 64 + 1e-9
               for a, b in zip(got["agg_acceptance_rate"], ref["agg_acceptance_rate"]))
    assert abs(got["mean_accuracy"][-1] - ref["mean_accuracy"][-1]) <= ACCURACY_BAND
    assert abs(got["honest_accuracy"][-1] - ref["honest_accuracy"][-1]) <= ACCURACY_BAND
