"""The ZMQ backend's DMTT node process (murmura_tpu_torch/dmtt/
node_process.py) against the JAX package's, in-process, on the CPU, with
the topology liar (wrapping the gaussian attack) on dmtt_mobility.yaml's
scenario cut to 8 nodes, under mobility and on the static graph
(``dmtt.allow_static``):

- ``_make_claim``: a liar's and an honest node's claims equal;
- ``_verify_claims``: the Beta evidence (alpha, beta) after two rounds of
  claims within rtol 1e-6;
- ``_select_collaborators`` (TopB) and ``_mean_topo_trust``: the picks
  equal (the collaboration scores are drawn with gaps far above float32
  noise) and the mean topology trust within rtol 1e-6;
- the probe evaluation of received states (step 7: accuracy and vacuity of
  each state on the node's probe batch, then the model score) within rtol
  1e-5, the JAX node's parameters carried over.
"""

import numpy as np
import pytest
import yaml

from murmura_tpu.config import Config as JaxConfig
from murmura_tpu.dmtt.node_process import DMTTNodeProcess as JaxDMTTNodeProcess
from murmura_tpu.dmtt.protocol import model_score as jax_model_score
from murmura_tpu.utils.factories import build_attack as jax_build_attack
from murmura_tpu.utils.factories import build_mobility as jax_build_mobility
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.dmtt.node_process import DMTTNodeProcess
from murmura_tpu_torch.utils.factories import build_attack, build_mobility

N = 8


def _raw(tmp_path, mobility: bool):
    raw = yaml.safe_load(open("examples/configs/dmtt_mobility.yaml"))
    raw["topology"]["num_nodes"] = N
    raw["attack"]["percentage"] = 0.25
    raw["data"]["params"].update(num_samples=N * 40, input_dim=12, num_classes=4)
    raw["model"]["params"] = {"input_dim": 12, "hidden_dims": [16], "num_classes": 4,
                              "evidential": True}
    raw["backend"] = "distributed"
    raw["distributed"] = {"ipc_dir": str(tmp_path), "round_duration_s": 60.0}
    if not mobility:
        raw.pop("mobility")
        raw["topology"] = {"type": "k-regular", "num_nodes": N, "k": 4}
        raw["dmtt"]["allow_static"] = True
    return raw


def _pair(tmp_path, mobility, node_id):
    raw = _raw(tmp_path, mobility)
    jcfg, tcfg = JaxConfig.model_validate(raw), Config.model_validate(raw)
    jattack, tattack = jax_build_attack(jcfg), build_attack(tcfg)
    compromised = sorted(jattack.get_compromised_nodes())
    assert compromised == sorted(np.flatnonzero(tattack.compromised).tolist())
    procs = []
    for cls, cfg, attack, mob in ((JaxDMTTNodeProcess, jcfg, jattack, jax_build_mobility),
                                  (DMTTNodeProcess, tcfg, tattack, build_mobility)):
        kw = {} if cls is JaxDMTTNodeProcess else {"device": "cpu"}
        proc = cls(cfg, node_id=node_id, run_id="d", t_start=0.0,
                   compromised_ids=compromised, **kw)
        proc.attack, proc.mobility = attack, mob(cfg)
        procs.append(proc)
    return procs, compromised


def _truth(proc, round_idx):
    if proc.mobility is not None:
        return proc.mobility.neighbors_at(round_idx)[proc.node_id]
    return sorted(proc._static_ground_truth()[proc.node_id])


@pytest.mark.parametrize("mobility", [True, False], ids=["mobility", "static"])
def test_claims_verification_and_selection_match_jax(tmp_path, mobility):
    _, compromised = _pair(tmp_path, mobility, 0)
    liar, honest = compromised[0], next(i for i in range(N) if i not in compromised)
    rng = np.random.default_rng(5)
    for node_id in (liar, honest):
        (jproc, tproc), _ = _pair(tmp_path, mobility, node_id)
        for round_idx in (0, 1):
            true_nb = _truth(jproc, round_idx)
            assert _truth(tproc, round_idx) == true_nb
            assert tproc._make_claim(true_nb) == jproc._make_claim(true_nb)
            # Claims from every other node: the liars' inflated ones, the
            # honest nodes' true ones, and one with a made-up neighbour.
            claims = {}
            for j in range(N):
                if j == node_id:
                    continue
                (jj, _), _ = _pair(tmp_path, mobility, j)
                claims[j] = jj._make_claim(_truth(jj, round_idx))
            claims[next(iter(claims))] = claims[next(iter(claims))] + [node_id]
            jproc._verify_claims(claims, round_idx)
            tproc._verify_claims(claims, round_idx)
            for attr in ("_alpha", "_beta"):
                got, ref = getattr(tproc, attr), getattr(jproc, attr)
                assert set(got) == set(ref)
                for k in ref:
                    assert got[k] == pytest.approx(ref[k], rel=1e-6), (attr, k)
            # Link reliability and model scores with gaps of 1e-3 or more.
            for proc in (jproc, tproc):
                proc._c_hat = {j: 0.5 + 0.01 * j for j in true_nb}
            scores = {j: float(s) for j, s in zip(
                true_nb, rng.permutation(len(true_nb)) * 0.05 + 0.2)}
            jproc._select_collaborators(true_nb, scores)
            tproc._select_collaborators(true_nb, scores)
            assert tproc._collaborators == jproc._collaborators
            assert tproc._mean_topo_trust(true_nb) == pytest.approx(
                jproc._mean_topo_trust(true_nb), rel=1e-6)
            # A liar claims its true neighbours and the whole coalition.
            coalition = set(compromised) - {node_id} if node_id == liar else set()
            assert set(tproc._make_claim(true_nb)) == {int(j) for j in true_nb} | coalition


def test_probe_scores_match_jax(tmp_path):
    (jproc, tproc), compromised = _pair(tmp_path, True, 1)
    for proc in (jproc, tproc):
        proc._build_node()
    tproc.node.set_flat_state(jproc.node.get_flat_state())
    own = jproc.node.get_flat_state()
    rng = np.random.default_rng(2)
    states = {j: (own + 0.3 * (1 + j) * rng.normal(size=own.shape)).astype(np.float32)
              for j in (0, 2, 5)}
    got = tproc._score_models(states)
    for j, flat in states.items():
        probe = jproc.node.probe_eval_flat(flat)
        ref = float(jax_model_score(np.float32(probe["accuracy"]),
                                    np.float32(probe["vacuity"]), jproc.dmtt))
        assert got[j] == pytest.approx(ref, rel=1e-5), j
        t_probe = tproc.node.probe_eval_flat(flat)
        assert t_probe["accuracy"] == pytest.approx(probe["accuracy"], abs=1e-6)
        assert t_probe["vacuity"] == pytest.approx(probe["vacuity"], rel=1e-5)
        assert 0.0 < t_probe["vacuity"] < 1.0
