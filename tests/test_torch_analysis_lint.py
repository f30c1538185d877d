"""The port's lint (murmura_tpu_torch/analysis/lint.py) and the check
command's output formats, on the CPU.

- ``format_findings`` and ``format_findings_json`` print the JAX package's
  text for the same findings.
- On a corpus of plain-Python snippets (a syntax error, code with no round
  scope, an ``aggregate`` protocol function branching on a parameter, with
  and without ``# murmura: ignore[...]``) both packages' lints give the
  same rules on the same lines, and the same MUR000 message.
- Each torch rule fires on a planted defect (MUR001-006) and holds on its
  legal twin (shape, size(), static AggContext fields, ``is None``,
  dtype given, a marker-less helper).
- The port's own tree lints clean (its suppressions carry their reasons).
- ``check PATH --no-contracts`` on a defect prints the JAX package's lines
  and exits 1; the JAX-only flags are refused by name with exit 2.
"""

import io
import json
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from murmura_tpu.analysis import format_findings as jax_format
from murmura_tpu.analysis import format_findings_json as jax_format_json
from murmura_tpu.analysis import run_check as jax_run_check
from murmura_tpu.analysis.lint import Finding as JaxFinding
from murmura_tpu.analysis.lint import lint_file as jax_lint_file
from murmura_tpu_torch import cli
from murmura_tpu_torch.analysis import (
    format_findings,
    format_findings_json,
    run_check,
    run_check_detailed,
)
from murmura_tpu_torch.analysis.lint import RULES, Finding, lint_file, lint_paths

PORT = Path(__file__).resolve().parent.parent / "murmura_tpu_torch"


def _write(tmp_path, src, name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return p


def _rules(findings):
    return sorted((f.rule, f.line) for f in findings)


@pytest.mark.parametrize("rule", ["MUR000", "MUR003", "MUR901", "MUR1300", "MUR1703"])
def test_formats_equal_the_jax_packages(rule):
    rows = [("a/b.py", 3, "first message"), ("c.py", 1, "second — with a dash")]
    ours = [Finding(rule, p, ln, m) for p, ln, m in rows]
    theirs = [JaxFinding(rule, p, ln, m) for p, ln, m in rows]
    assert format_findings(ours) == jax_format(theirs)
    records = [{"kind": "compose_summary", "pair": ["a", "b"], "clean": True}, {"x": 1}]
    assert format_findings_json(ours, records) == jax_format_json(theirs, records)
    assert format_findings_json([], None) == jax_format_json([], None) == ""
    first = json.loads(format_findings_json(ours).splitlines()[0])
    assert first["name"] == RULES[rule] and first["kind"] == "finding"


CORPUS = {
    "syntax_error": "def f(:\n    pass\n",
    "plain": """
        import numpy as np

        def helper(x):
            if x.sum() > 0:
                return float(x.sum())
            return 0.0
        """,
    "protocol_branch": """
        def aggregate(own, bcast, adj, round_idx, state, ctx):
            if own.sum() > 0:
                return own
            assert bcast.max() < 1
            return bcast
        """,
    "protocol_suppressed": """
        def aggregate(own, bcast, adj, round_idx, state, ctx):
            if own.sum() > 0:  # murmura: ignore[MUR001]
                return own
            assert bcast.max() < 1  # murmura: ignore
            return bcast
        """,
    "protocol_static": """
        def aggregate(own, bcast, adj, round_idx, state, ctx):
            if own.shape[0] > 4 and ctx.evidential:
                return own
            if state is None:
                return bcast
            return own
        """,
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_both_lints_agree_on_the_plain_python_corpus(tmp_path, name):
    p = _write(tmp_path, CORPUS[name])
    ours, theirs = lint_file(p), jax_lint_file(p)
    assert _rules(ours) == _rules(theirs)
    if name == "syntax_error":
        assert [f.message for f in ours] == [f.message for f in theirs]
        assert ours[0].rule == "MUR000"
    if name == "protocol_branch":
        assert _rules(ours) == [("MUR001", 3), ("MUR002", 5)]
    if name in ("plain", "protocol_suppressed", "protocol_static"):
        assert ours == []


FIRES = {
    "MUR001": """
        def aggregate(own, bcast, adj, round_idx, state, ctx):
            while (own - bcast).abs().max() > 1e-3:
                own = own * 0.5
            return own
        """,
    "MUR002": """
        def run(x):  # murmura: traced
            assert torch.isfinite(x).all()
            return x
        """,
    "MUR003": """
        import numpy as np
        import torch

        def step(flat, state):  # murmura: traced
            a = flat.sum().item()
            b = flat.tolist()
            c = flat.cpu()
            d = float(flat.max())
            e = np.asarray(flat)
            torch.cuda.synchronize()
            print(flat)
            return flat
        """,
    "MUR004": """
        import torch
        from murmura_tpu_torch.ops import _build

        def setup(names):
            for n in names:
                _build.build_all([n])
                torch.compile(n)

        def step(flat, k):  # murmura: traced
            for i in range(k.sum()):
                flat = flat + 1
            return flat
        """,
    "MUR005": """
        import torch

        TABLE = torch.zeros(4)
        CARDS = torch.cuda.device_count()
        ONE = torch.ones(2).cuda()
        TWO = torch.ones(2).to("cuda")
        THREE = torch.ones(2).to(device="cuda:0")
        """,
    "MUR006": """
        import torch

        def aggregate(own, bcast, adj, round_idx, state, ctx):
            return own * torch.ones(own.shape[1]) + torch.tensor([0.5, 0.5]) * bcast
        """,
}
FIRE_COUNTS = {"MUR001": 1, "MUR002": 1, "MUR003": 7, "MUR004": 3, "MUR005": 8, "MUR006": 2}


@pytest.mark.parametrize("rule", sorted(FIRES))
def test_each_rule_fires_on_a_planted_defect(tmp_path, rule):
    found = lint_file(_write(tmp_path, FIRES[rule]))
    assert [f.rule for f in found] == [rule] * FIRE_COUNTS[rule], found
    assert all(f.name == RULES[rule] for f in found)


HOLDS = {
    "MUR001": """
        def aggregate(own, bcast, adj, round_idx, state, ctx):
            if own.size(0) > 2 and own.dim() == 2 and ctx.audit and len(bcast) > 1:
                return own
            for row in own:
                own = own + row
            return own
        """,
    "MUR002": """
        def run(x, k):  # murmura: traced
            assert x.shape[0] == 4 and k is not None
            return x
        """,
    "MUR004": """
        from murmura_tpu_torch.ops import _build

        def setup(names):
            _build.build_all(names)
            for n in names:
                print(n)

        def step(flat, k):  # murmura: traced
            for i in range(flat.shape[0]):
                flat = flat + 1
            return flat
        """,
    "MUR003": """
        def helper(flat):
            return flat.sum().item()

        def step(flat, state):  # murmura: traced
            return flat.to(torch.float32)
        """,
    "MUR005": """
        import torch

        DTYPE = torch.float32

        def later():
            return torch.zeros(4).cuda()
        """,
    "MUR006": """
        import torch

        def aggregate(own, bcast, adj, round_idx, state, ctx):
            scale = torch.tensor(0.5)
            return own * torch.ones(own.shape[1], dtype=own.dtype) + scale * bcast
        """,
}


@pytest.mark.parametrize("rule", sorted(HOLDS))
def test_each_rule_holds_on_its_legal_twin(tmp_path, rule):
    assert lint_file(_write(tmp_path, HOLDS[rule])) == []


def test_vmapped_functions_are_round_scopes(tmp_path):
    src = """
        from torch.func import vmap

        def one(x):
            return x.item()

        def outer(xs):
            return vmap(one)(xs)
        """
    assert _rules(lint_file(_write(tmp_path, src))) == [("MUR003", 5)]


def test_the_port_tree_lints_clean():
    assert lint_paths([PORT]) == []


def test_check_on_a_defect_prints_the_jax_packages_lines(tmp_path):
    p = _write(tmp_path, CORPUS["syntax_error"], "broken.py")
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        cli.main(["check", str(p), "--no-contracts", "--device", "cpu"])
    assert exit_.value.code == 1
    lines = out.getvalue().splitlines()
    expected = jax_format(jax_run_check([p], contracts=False))
    assert lines[0] == expected == format_findings(run_check([p], contracts=False, device="cpu"))
    assert lines[0].startswith(f"{p}:1: MUR000 [syntax-error] ")
    assert "1 finding(s)" in lines[-1]


def test_check_json_lines(tmp_path):
    p = _write(tmp_path, FIRES["MUR002"], "traced.py")
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        cli.main(["check", str(p), "--no-contracts", "--json", "--device", "cpu"])
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [(r["kind"], r["rule"], r["line"]) for r in rows] == [("finding", "MUR002", 3)]


def test_check_on_a_clean_file(tmp_path):
    p = _write(tmp_path, CORPUS["plain"], "clean.py")
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["check", str(p), "--device", "cpu"])
    assert out.getvalue().strip() == "murmura check: clean"


@pytest.mark.parametrize("flag,module", [
    ("--ir", "murmura_tpu/analysis/ir.py"), ("--flow", "murmura_tpu/analysis/flow.py"),
    ("--memory", "murmura_tpu/analysis/memory.py"),
    ("--update-budgets", "murmura_tpu/analysis/BUDGETS.json"),
    ("--update-memory", "murmura_tpu/analysis/MEMORY.json"),
])
def test_jax_only_flags_are_refused_by_name(capsys, flag, module):
    with pytest.raises(SystemExit) as exit_:
        cli.main(["check", flag, "--device", "cpu"])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and module in err and "PyTorch port" in err


def test_lint_off_runs_no_lint(tmp_path):
    p = _write(tmp_path, CORPUS["syntax_error"], "broken.py")
    timings = {}
    assert run_check_detailed([p], contracts=False, device="cpu", timings=timings) != ([], [])
    assert "lint" in timings
    timings = {}
    assert run_check_detailed([p], contracts=False, device="cpu", lint=False,
                              timings=timings) == ([], [])
    assert timings == {}
