"""The port's observability plane (telemetry/metrics.py, spans.py,
registry.py, top.py, report.render_grid, and the CLI's ``metrics``,
``top``, ``runs``, ``report --latest`` and ``--trace``) against the JAX
package's modules, on the CPU.

They are host readers of one event schema (v2), so the parity is exact: on
the run directories a port daemon writes (three tenants, snapshots every
round: two killed after round 1 and recovered by a new daemon, then a
third through the warm bucket), the port's
``fold_run_events`` -> ``render_openmetrics`` equals the JAX module's text
for text, ``build_spans`` equals the JAX module's (``validate_spans``
passes in both, the round spans summing to the phase times),
``index_runs`` / ``render_rows`` / ``find_latest`` equal the JAX module's
over the daemon's state dir, and ``grid_tables`` holds the rows the JAX
``render_grid`` puts in its tables.
"""

import io
import json
import re
import threading

import pytest

from murmura_tpu.telemetry import metrics as JM
from murmura_tpu.telemetry import registry as JR
from murmura_tpu.telemetry import spans as JS
from murmura_tpu.telemetry.report import render_grid as jax_render_grid
from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core import gang as gang_mod
from murmura_tpu_torch.serve.daemon import ServeDaemon
from murmura_tpu_torch.serve.protocol import send_request
from murmura_tpu_torch.telemetry import metrics as TM
from murmura_tpu_torch.telemetry import registry as TR
from murmura_tpu_torch.telemetry import spans as TSP
from murmura_tpu_torch.telemetry.report import grid_tables, render_grid
from murmura_tpu_torch.telemetry.writer import iter_events

TENANTS = ("sub-00001", "sub-00002", "sub-00003")


def _tenant(seed, lr=0.05, rule="krum"):
    return {
        "experiment": {"name": f"tenant-{seed}", "seed": seed, "rounds": 2},
        "topology": {"type": "ring", "num_nodes": 5},
        "aggregation": {"algorithm": rule},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": lr},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 40, "input_shape": [6], "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 6, "hidden_dims": [8], "num_classes": 3}},
        "backend": "simulation",
    }


def _daemon(state_dir):
    raw = _tenant(0)
    raw["serve"] = {"state_dir": str(state_dir), "capacity": 2, "checkpoint_every": 1,
                    "poll_interval_s": 0.05}
    return ServeDaemon(Config.model_validate(raw), device="cpu")


class _Kill(BaseException):
    pass


@pytest.fixture(scope="module")
def state_dir(tmp_path_factory):
    """A daemon's state dir: tenants 1-2 killed after round 1 and recovered
    by a new daemon, then tenant 3 (another lr) through the warm bucket."""
    root = tmp_path_factory.mktemp("serve") / "state"
    d = _daemon(root)
    d.submit_config(_tenant(5))
    d.submit_config(_tenant(6, lr=0.02))
    real_train = gang_mod.GangNetwork.train

    def dying_train(self, rounds, **kwargs):
        real_train(self, rounds=1, **kwargs)
        raise _Kill()

    gang_mod.GangNetwork.train = dying_train
    try:
        with pytest.raises(_Kill):
            d.drain()
    finally:
        gang_mod.GangNetwork.train = real_train
    revived = _daemon(root)
    assert len(revived.recover()) == 2
    revived.submit_config(_tenant(7, lr=0.01))
    revived.drain()
    assert {r["state"] for r in revived._ledger.values()} == {"done"}
    return root


@pytest.mark.parametrize("tenant", TENANTS)
def test_openmetrics_fold_equals_jax(state_dir, tenant):
    run_dir = state_dir / "telemetry" / tenant
    got = TM.render_openmetrics(TM.fold_run_events(TM.MetricsRegistry(), run_dir,
                                                   labels={"tenant": tenant}))
    ref = JM.render_openmetrics(JM.fold_run_events(JM.MetricsRegistry(), run_dir,
                                                   labels={"tenant": tenant}))
    assert got == ref
    scraped = TM.parse_openmetrics(got)
    assert scraped == JM.parse_openmetrics(ref) and got.endswith("# EOF\n")
    assert scraped[("murmura_rounds_total", (("tenant", tenant),))] == 2.0
    resumes = scraped.get(("murmura_resumes_total", (("tenant", tenant),)), 0.0)
    assert resumes == (1.0 if tenant != "sub-00003" else 0.0)


@pytest.mark.parametrize("tenant", TENANTS)
def test_spans_equal_jax(state_dir, tenant):
    run_dir = state_dir / "telemetry" / tenant
    got, ref = TSP.build_spans(run_dir), JS.build_spans(run_dir)
    assert got == ref
    total = sum(e["wall_s"] for e in iter_events(run_dir) if e["type"] == "phase_times")
    assert TSP.validate_spans(got, phase_total=total) == [] == JS.validate_spans(
        ref, phase_total=total)
    names = [s["name"] for s in got]
    assert {"run", "queued", "generation", "round 0", "round 1"} <= set(names)
    assert TSP.to_chrome_trace([got]) == JS.to_chrome_trace([ref])


def test_run_index_equals_jax(state_dir):
    got, ref = TR.index_runs([state_dir]), JR.index_runs([state_dir])
    assert got == ref and TR.render_rows(got) == JR.render_rows(ref)
    assert TR.find_latest([state_dir]) == JR.find_latest([state_dir])
    kinds = [r["kind"] for r in got]
    assert kinds.count("submission") == 3 and kinds.count("run") == 3
    assert len({r["fingerprint"] for r in got}) == 1 and not any(r["torn_tail"] for r in got)


def _jax_table_rows(artifact, monkeypatch):
    """The rows the JAX package's render_grid adds to its rich tables, with
    the markup stripped."""
    from rich.console import Console
    from rich.table import Table

    rows = []
    real = Table.add_row
    monkeypatch.setattr(Table, "add_row", lambda self, *cells, **kw: (
        rows.append([re.sub(r"\[/?[a-z ]+\]", "", c) for c in cells]), real(self, *cells, **kw)))
    jax_render_grid(artifact, console=Console(file=io.StringIO(), width=300))
    return rows


def test_grid_tables_hold_the_jax_rows(monkeypatch):
    artifact = {
        "experiment": "x", "grid": {"num_nodes": 5, "rounds": 2, "seeds": [7]},
        "total_cells": 3, "total_compiles": 3,
        "buckets": [{"key": "a1", "rule": "krum", "attack": "gaussian", "topology": "dense",
                     "cells": ["c1", "c2"], "batch": 2, "gang_size": 2, "compiles": 2,
                     "wall_s": 0.123456},
                    {"key": "b2", "rule": "median", "attack": "none", "topology": "sparse",
                     "cells": ["c3"], "batch": 1, "gang_size": 1, "compiles": 1,
                     "wall_s": float("nan")}],
        "cells": [{"id": "c1", "bucket": "a1", "strength": 0.5, "seed": 7,
                   "final_accuracy": 0.25, "honest_accuracy": None,
                   "phase_times": {"mean_round_s": 0.0123}},
                  {"id": "c2", "bucket": "a1", "strength": 4.0, "seed": 7,
                   "final_accuracy": 0.5, "honest_accuracy": 0.6666, "phase_times": {}},
                  {"id": "c3", "bucket": "b2", "strength": 0.0, "seed": 7,
                   "final_accuracy": None, "honest_accuracy": None}],
    }
    tables = grid_tables(artifact)
    assert [r for _, _, rows in tables for r in rows] == _jax_table_rows(artifact, monkeypatch)
    lines = []
    render_grid(artifact, out=lines.append)
    assert lines[0].endswith("3 cells in 2 buckets, 3 compiles") and len(lines) == 10


def test_cli_reads_the_daemon_and_its_runs(state_dir, tmp_path, capsys, monkeypatch):
    run_dir = state_dir / "telemetry" / "sub-00001"
    cli.main(["metrics", str(run_dir)])
    assert capsys.readouterr().out == JM.render_openmetrics(
        JM.fold_run_events(JM.MetricsRegistry(), run_dir)) + "\n"
    cli.main(["runs", str(state_dir), "--json"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == json.loads(json.dumps(JR.index_runs([state_dir])))
    trace = tmp_path / "trace.json"
    cli.main(["report", str(run_dir), "--trace", str(trace)])
    assert "trace span(s)" in capsys.readouterr().out
    assert json.loads(trace.read_text()) == JS.to_chrome_trace([JS.build_spans(run_dir)])
    monkeypatch.chdir(state_dir)
    cli.main(["report", "--latest", "--json"])
    latest = json.loads(capsys.readouterr().out)
    assert latest["accuracy"]["rounds_recorded"] == 2
    # A live daemon: metrics over its socket, and one frame of top.
    d = _daemon(tmp_path / "live")
    thread = threading.Thread(target=d.serve_forever, daemon=True)
    thread.start()
    try:
        send_request(d.socket_path, {"op": "ping"})
        cli.main(["metrics", d.socket_path])
        assert capsys.readouterr().out.rstrip().endswith("# EOF")
        cli.main(["top", "--socket", d.socket_path, "--iterations", "1"])
        frame = capsys.readouterr().out
        assert "murmura top — pid" in frame and "buckets: (none warm)" in frame
    finally:
        send_request(d.socket_path, {"op": "shutdown"}, retries=1)
        thread.join(timeout=15)
    assert not thread.is_alive()


def test_writer_lines_stay_whole_across_threads(tmp_path):
    # The serve daemon's listener writes an eviction into a tenant's stream
    # while the generation thread writes its rounds: every line stays whole
    # and every sequence number unique.
    from murmura_tpu_torch.telemetry.writer import TelemetryWriter

    writer = TelemetryWriter(tmp_path / "run")
    pad = "x" * 4096

    def spam(tag):
        for i in range(300):
            writer.emit("probe", tag=tag, i=i, pad=pad)

    threads = [threading.Thread(target=spam, args=(t,)) for t in ("a", "b", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    writer.close()
    events = list(iter_events(tmp_path / "run"))
    assert [e["seq"] for e in events] == list(range(901))
    assert sorted((e["tag"], e["i"]) for e in events if e["type"] == "probe") == sorted(
        (t, i) for t in "abc" for i in range(300))
