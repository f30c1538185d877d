"""The port's serving and observability contracts (analysis/serve.py,
analysis/observe.py: MUR1600-1603, MUR1700-1703), on the CPU, each holding
on the tree and firing on a planted defect:

- MUR1600: the planned grid's buckets against the cells' independently
  built program descriptions (stages with the rule and attack on theirs,
  the carried state, the kernels a round reaches); a description that
  differs inside a bucket, or is shared across buckets, fires.
- MUR1601: an admission into a warm bucket that builds fires.
- MUR1602: a survivor whose history differs from the unadmitted gang's,
  and a frozen lane that keeps recording, fire.
- MUR1603: a daemon whose recover does nothing leaves its killed
  generation running: it fires.
- MUR1700: a round event added to a tenant's stream after the scrape
  fires; MUR1701: a build or a diverging history under scraping fires;
  MUR1702: a stream without its serve lifecycle events fires; MUR1703: a
  schema version without its bump or migration note fires.
"""

import json
import shutil
import tempfile
from pathlib import Path

from murmura_tpu_torch.analysis import observe as O
from murmura_tpu_torch.analysis import serve as SV
from murmura_tpu_torch.analysis.sanitizers import note_program_build
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core import gang as gang_mod
from murmura_tpu_torch.serve import daemon as daemon_mod
from murmura_tpu_torch.serve.scheduler import cell_program, plan_grid


def _rules(findings):
    return sorted({f.rule for f in findings})


def _grid():
    config = Config.model_validate(SV.grid_raw())
    return config, config.grid, plan_grid(config, config.grid)


def test_mur1600_descriptions_name_rule_attack_and_kernels():
    config, g, buckets = _grid()
    assert len(buckets) == 3
    krum = next(b for b in buckets if b.rule == "krum")
    cell = krum.cells[0]
    stages, flat, state, data, offsets, kernels = SV.program_description(
        cell_program(config, g, cell, device="cpu"), cell.rule, cell.attack)
    assert "murmura.aggregate:krum" in stages and "murmura.exchange:gaussian" in stages
    assert kernels == ("pairwise_sq_distances",)
    assert SV.check_bucket_key_soundness("cpu") == []


def test_mur1600_fires_on_unsound_buckets():
    _, _, buckets = _grid()
    per_cell = SV.bucket_key_findings(buckets, lambda cell: cell.cell_id)
    assert _rules(per_cell) == ["MUR1600"] and "different from" in per_cell[0].message
    shared = SV.bucket_key_findings(buckets, lambda cell: "one program")
    assert _rules(shared) == ["MUR1600"] and "equal round programs" in shared[0].message


def test_mur1601_fires_on_an_admission_that_builds(monkeypatch):
    real = gang_mod.GangNetwork.reset_run

    def building(self, *args, **kwargs):
        note_program_build()
        return real(self, *args, **kwargs)

    assert SV.check_admission_recompile("cpu") == []
    monkeypatch.setattr(gang_mod.GangNetwork, "reset_run", building)
    found = SV.check_admission_recompile("cpu")
    assert _rules(found) == ["MUR1601"]


def test_mur1602_holds_and_fires():
    assert SV.check_frozen_lane_interference("cpu") == []
    solo = {"round": [1, 2, 3], "mean_loss": [1.0, 0.9, 0.8]}
    pair = [{"round": [1, 2, 3], "mean_loss": [1.0, 0.9, 0.7]}, {"round": [1, 2, 3]}]
    found = SV.frozen_lane_findings(pair, solo, "gang.py", 1)
    assert _rules(found) == ["MUR1602"] and len(found) == 2


def test_mur1603_fires_when_recover_does_nothing(monkeypatch):
    monkeypatch.setattr(daemon_mod.ServeDaemon, "recover", lambda self: [])
    found = SV.check_resume_completeness("cpu")
    assert _rules(found) == ["MUR1603"]
    assert "still 'running'" in found[0].message


def test_mur1700_fires_on_an_event_added_after_the_scrape(tmp_path):
    from murmura_tpu_torch.telemetry.metrics import render_openmetrics

    daemon = O._drained_daemon(tmp_path / "state", "cpu")
    daemon.close()
    text = render_openmetrics(daemon.metrics_registry())
    assert O.metrics_ledger_parity(daemon, text) == []
    sub_id = sorted(daemon._ledger)[0]
    events = daemon.state_dir / "telemetry" / sub_id / "events.jsonl"
    with open(events, "a") as f:
        f.write(json.dumps({"type": "round", "seq": 10_000, "round": 99}) + "\n")
    problems = O.metrics_ledger_parity(daemon, text)
    assert len(problems) == 1 and sub_id in problems[0] and "round events" in problems[0]


def test_mur1701_fires_on_a_build_or_a_diverging_history():
    assert O.interference_problems(0, [("s", {"a": [1.0]}, {"a": [1.0]})]) == []
    problems = O.interference_problems(1, [("s", {"a": [1.0]}, {"a": [2.0]})])
    assert len(problems) == 2


def test_mur1702_holds_and_fires_on_a_stream_without_its_lifecycle(tmp_path):
    daemon = O._drained_daemon(tmp_path / "state", "cpu")
    daemon.close()
    sub_id = sorted(daemon._ledger)[0]
    run_dir = daemon.state_dir / "telemetry" / sub_id
    assert O.span_findings(run_dir, sub_id, "spans.py", 1) == []
    events = run_dir / "events.jsonl"
    kept = [line for line in events.read_text().splitlines()
            if json.loads(line).get("type") != "serve"]
    events.write_text("\n".join(kept) + "\n")
    found = O.span_findings(run_dir, sub_id, "spans.py", 1)
    assert _rules(found) == ["MUR1702"]
    assert any("'queued'" in f.message for f in found)


def test_mur1703_holds_and_fires():
    assert O.check_schema_discipline() == []
    assert len(O.schema_discipline_problems(1, "### v2")) == 2
    tmp = Path(tempfile.mkdtemp())
    try:
        assert O.v1_stream_problems(tmp / "v1") == []
    finally:
        shutil.rmtree(tmp)
