"""The port's executable contract families (durability, adaptive,
staleness, pipeline, sharded, compose) and the whole ``check``, on the CPU.

- ``python -m murmura_tpu_torch check --device cpu`` (in process, through
  ``cli.main``) over the package prints ``murmura check: clean``: the lint,
  the static contracts and every executable family, one gloo group of 2
  ranks among them (analysis/sharded.py), the file's only group.  One
  module-scoped run of it (:func:`full_check`) gives each family's own
  findings and the group's recorded collectives to the tests below.
- (g) The Krum dense durability cell, started from the JAX package's
  cell's initial parameters, runs the save -> restore -> replay probe to
  the JAX package's history: decisions equal, floats within rtol 1e-5 /
  atol 1e-6 (every node trains on its whole shard in one batch, so the two
  packages' shuffles reorder only the sums).
- Each rule fires on a planted defect: a restore that perturbs the
  parameters or builds (MUR901/902), a build during a warm chunk
  (MUR1001/1101/1201/1401, the gang's re-aim too), recorded collectives
  with an extra [N, P] all_reduce or a missing turn (MUR1300), a build
  after the first round (MUR1301), two networks that differ (MUR1302),
  perturbed parameters (MUR1303), an extra collective in a lever's round
  (MUR1002/1102/1202), a compatible pair whose config refuses (MUR1401),
  a composed state missing a key and out-of-order stages (MUR1402).
"""

import io
import tempfile
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.analysis.durability import _cell_config as jax_cell_config
from murmura_tpu.utils.factories import build_network_from_config as jax_build_network
from murmura_tpu_torch import cli
from murmura_tpu_torch.analysis import FAMILIES
from murmura_tpu_torch.analysis import adaptive as A
from murmura_tpu_torch.analysis import composition as C
from murmura_tpu_torch.analysis import durability as D
from murmura_tpu_torch.analysis import pipeline as P
from murmura_tpu_torch.analysis import sharded as SH
from murmura_tpu_torch.analysis import staleness as S
from murmura_tpu_torch.analysis.sanitizers import note_program_build
from murmura_tpu_torch.core import gang as gang_mod
from murmura_tpu_torch.core import network as net_mod


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(scope="module")
def full_check():
    """``check --device cpu`` over the package, once: its output, each
    family's findings (the family entries wrapped to record what they
    return) and the sharded group's results, as ``run_group`` returns them."""
    import importlib

    out, per_family, ranks = io.StringIO(), {}, []
    real_group = SH.run_group

    def recording_group(device):
        ranks.append(real_group(device))
        return ranks[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SH, "run_group", recording_group)
        for name, module, entry in FAMILIES:
            mod = importlib.import_module(f"murmura_tpu_torch.analysis.{module}")

            def recording(device, _real=getattr(mod, entry), _name=name):
                per_family[_name] = _real(device)
                return per_family[_name]

            mp.setattr(mod, entry, recording)
        with redirect_stdout(out):
            cli.main(["check", "--device", "cpu"])
    return {"output": out.getvalue(), "families": per_family, "ranks": ranks[0],
            "summaries": C.compose_summaries()}


def test_full_check_is_clean(full_check):
    assert full_check["output"].strip() == "murmura check: clean"
    rows = full_check["summaries"]
    assert len(rows) == 55 and sum(r["verdict"] == "composes" for r in rows) == 41
    assert all(r["clean"] and r["recompiles"] == 0 for r in rows if r["verdict"] == "composes")


@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_each_family_holds(full_check, name):
    assert full_check["families"][name] == []


# -- (g) one durability cell against the JAX package ----------------------------


def _probe(net, **kw):
    with tempfile.TemporaryDirectory() as d:
        net.train(rounds=2, **kw)
        net.save_checkpoint(d)
        net.train(rounds=2, **kw)
        assert net.restore_checkpoint(d) == 2
        net.train(rounds=2, **kw)
    return net.history


def test_krum_dense_cell_matches_the_jax_package():
    jnet = jax_build_network(jax_cell_config("krum", "dense"))
    pnet = D.build_network(D.cell_raw("krum", "dense"), "cpu")
    init = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(jnet.params))
    assert tuple(pnet.flat.shape) == init.shape
    pnet.flat = torch.from_numpy(init.copy())
    theirs, ours = _probe(jnet, verbose=False), _probe(pnet)
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = np.asarray(theirs[k], dtype=np.float64), np.asarray(ours[k], dtype=np.float64)
        if k.startswith("agg_selected") or k == "round":
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)
    assert D.resume_cell_findings("krum", "dense", "cpu") == []


# -- planted defects -----------------------------------------------------------


def test_mur901_fires_on_a_restore_that_perturbs_the_parameters():
    net = D.build_network(D.cell_raw("krum", "dense"), "cpu")
    restore = net.restore_checkpoint

    def perturbing(directory):
        r = restore(directory)
        net.flat = net.flat + 1e-3
        return r

    net.restore_checkpoint = perturbing
    found = D.resume_cell_findings("krum", "dense", "cpu", network=net)
    assert _rules(found) == ["MUR901"]
    assert any("parameters diverge" in f.message for f in found)


def test_mur901_fires_on_a_restore_that_drops_carried_state():
    net = D.build_network(D.with_exchange(D.base_raw("d", "krum"), "dense"), "cpu")
    net.agg_state["planted_state"] = torch.zeros(5)
    restore = net.restore_checkpoint

    def dropping(directory):
        r = restore(directory)
        net.agg_state.pop("planted_state", None)
        return r

    net.restore_checkpoint = dropping
    found = D.resume_cell_findings("krum", "dense", "cpu", network=net)
    assert any("'planted_state'" in f.message and f.rule == "MUR901" for f in found)


def test_mur902_fires_on_a_restore_that_builds():
    net = D.build_network(D.cell_raw("median", "circulant"), "cpu")
    restore = net.restore_checkpoint

    def building(directory):
        note_program_build()
        return restore(directory)

    net.restore_checkpoint = building
    assert _rules(D.resume_cell_findings("median", "circulant", "cpu", network=net)) == ["MUR902"]


@pytest.fixture
def warm_builds(monkeypatch):
    """Every train call after a network's or gang's first builds a program."""
    for cls in (net_mod.Network, gang_mod.GangNetwork):
        real = cls.train

        def train(self, *args, _real=real, **kwargs):
            if getattr(self, "_planted_warm", False):
                note_program_build()
            self._planted_warm = True
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(cls, "train", train)


@pytest.mark.parametrize("probe,rule", [
    (lambda: A.recompile_cell_findings("krum", "gaussian", "cpu"), "MUR1001"),
    (lambda: A.gang_reset_findings("cpu"), "MUR1001"),
    (lambda: S.recompile_cell_findings("median", "sparse", "cpu"), "MUR1101"),
    (lambda: P.recompile_cell_findings("krum", "dense", "cpu"), "MUR1201"),
    (lambda: C.grid_cell_findings("compression", "faults", "cpu"), "MUR1401"),
], ids=["adaptive", "gang_reset", "stale", "pipeline", "compose"])
def test_a_build_during_a_warm_chunk_fires(warm_builds, probe, rule):
    found = probe()
    assert _rules(found) == [rule], found
    assert "built" in found[0].message


def test_mur1001_holds_on_a_cell():
    assert A.recompile_cell_findings("balance", "ipm", "cpu") == []


def _recorded(full_check, label="krum/circulant"):
    cases = SH.group_cases()
    i = [c["label"] for c in cases].index(label)
    return cases[i], full_check["ranks"][0][i]["calls"]


def test_mur1300_fires_on_an_extra_full_width_all_reduce_and_a_missing_turn(full_check):
    case, calls = _recorded(full_check)
    bound = SH.all_reduce_bound(case["raw"])
    assert SH.inventory_cell_findings("krum", "krum", calls, bound) == []
    n, p = 5, 100
    extra = calls + [{"op": "all_reduce", "numel": n * p, "caller": "reduce_partial_"}]
    found = SH.inventory_cell_findings("krum", "krum", extra, bound)
    assert _rules(found) == ["MUR1300"] and str(n * p) in found[0].message
    assert SH.oversized_all_reduces(extra, bound) == [n * p]
    one_way = [c for c in calls if c["caller"] != "columns_to_rows"]
    found = SH.inventory_cell_findings("krum", "krum", one_way, bound)
    assert _rules(found) == ["MUR1300"] and "all_to_all turns" in found[0].message
    # The probe rules' extra turns are exempt, the size bound is not.
    assert SH.inventory_cell_findings("ubar", "ubar", one_way, bound) == []


@pytest.mark.parametrize("lever,rule", [("adaptive", "MUR1002"), ("stale", "MUR1102"),
                                        ("pipeline", "MUR1202")])
def test_lever_parity_fires_on_an_extra_collective(full_check, lever, rule):
    _, plain = _recorded(full_check)
    assert SH.inventory_parity_findings(rule, "krum", lever, plain, plain) == []
    lever_calls = plain + [{"op": "all_gather", "numel": 5, "caller": "gather_rows_extra"}]
    found = SH.inventory_parity_findings(rule, "krum", lever, plain, lever_calls)
    assert _rules(found) == [rule] and "gather_rows_extra" in found[0].message


def test_mur1301_mur1303_fire():
    assert SH.warm_build_findings("krum", "krum", 0) == []
    assert _rules(SH.warm_build_findings("krum", "krum", 1)) == ["MUR1301"]
    a = np.linspace(-1, 1, 500, dtype=np.float32).reshape(5, 100)
    assert SH.execution_parity_findings("krum", "krum", a + 1e-7, a) == []
    assert _rules(SH.execution_parity_findings("krum", "krum", a + 1e-3, a)) == ["MUR1303"]


def test_mur1302_fires_on_networks_that_differ():
    raw = SH.sharded_raw("fedavg", "circulant", shards=1)
    other = {**raw, "experiment": {**raw["experiment"], "seed": 8}}
    nets = [D.build_network(r, "cpu") for r in (raw, raw, other)]
    for net in nets:
        net.train(rounds=2)
    assert SH.shards1_findings("fedavg", nets[0], nets[1]) == []
    found = SH.shards1_findings("fedavg", nets[0], nets[2])
    assert _rules(found) == ["MUR1302"] and "parameters differ" in found[0].message


def test_mur1401_fires_on_a_compatible_pair_that_refuses(monkeypatch):
    monkeypatch.setattr(C, "pair_raw", lambda a, b: C.census_raw(
        C.REFUSAL_CONFIGS[("adaptive", "dmtt", None)]))
    found = C.grid_cell_findings("adaptive", "faults", "cpu")
    assert _rules(found) == ["MUR1401"] and "refuses at validation" in found[0].message


def test_mur1402_fires_on_a_dropped_key_and_out_of_order_stages():
    found = C.composed_state_findings("compression", "faults", {"compress_ref"},
                                      {"compression": {"compress_ref", "compress_residual"}},
                                      set())
    assert _rules(found) == ["MUR1402"] and "compress_residual" in found[0].message
    order = ["murmura.train", "murmura.stale", "murmura.compress", "murmura.aggregate"]
    found = C.stage_order_findings("compression", "staleness", order, pipelined=False)
    assert _rules(found) == ["MUR1402"] and "out of STAGE_ORDER" in found[0].message
    found = C.stage_order_findings("pipeline", "staleness", ["murmura.train"], pipelined=True)
    assert len(found) == 2 and all("opens stage" in f.message for f in found)
    drained = ["murmura.aggregate", "murmura.train", "murmura.stale", "murmura.pipeline"]
    assert C.stage_order_findings("pipeline", "staleness", drained, pipelined=True) == []
