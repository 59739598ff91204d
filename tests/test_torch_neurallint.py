"""The port's static checks (``repro_torch.analysis``,
``tools/torch_neurallint.py``), case for case the twin of
``tests/test_neurallint.py``: both engines, the command line, and the
silent-downgrade regression; plus the tile step of ``kernels.gating``
against the dense product."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import RULES as JAX_RULES
from repro_torch.analysis import (RULES, junit_xml, lint_source, render,
                                  verify_contracts)
from repro_torch.analysis.lint import lint_paths

REPO = Path(__file__).resolve().parent.parent
NEURALLINT = [sys.executable, str(REPO / "tools" / "torch_neurallint.py")]

#: a port path that no rule exempts, for the fixture snippets
SRC = "src/repro_torch/models/fixture.py"


def _rules(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------ engine 2: fixtures
# (one good and one bad snippet per AST rule; the bad one must trip exactly
# its rule, so that the fixtures are precision tests too)
FIXTURES = {
    "NL-REGISTRY-BYPASS": (
        "from repro_torch import ops\ny = ops.matmul\n",
        "from repro_torch.kernels.spike_matmul import spike_matmul_cuda\n"),
    "NL-HOST-SYNC": (
        "import torch\n\n@torch.compile\ndef f(x):\n    return x.sum()\n",
        "import torch\n\n@torch.compile\ndef f(x):\n"
        "    return float(x.sum())\n"),
    "NL-BARE-HEAVISIDE": (
        "from repro_torch.core.surrogate import spike\n\n\ndef f(v, t):\n"
        "    return spike(v - t)\n",
        "def f(v, t):\n    return (v > t).to(torch.float32)\n"),
    "NL-INTERPRET-HARDCODE": (
        "def run(x, device=None):\n"
        "    return go(x, device=resolve_device(device))\n",
        "def run(x, device='cpu'):\n    return go(x, device=device)\n"),
    "NL-MUTABLE-DEFAULT": (
        "def f(x, acc=None):\n    return acc\n",
        "def f(x, acc=[]):\n    return acc\n"),
    "NL-LEGACY-FLAGS": (
        "y = ops.matmul(x, w, policy='fused_dense')\n",
        "y = ops.matmul(x, w, use_event_kernels=True)\n"),
    "NL-LEGACY-FORKS": (
        "y = snn_cnn.forward(params, x)\n",
        "y = snn_cnn.apply_fused(params, x)\n"),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_fixture_pair(rule):
    good, bad = FIXTURES[rule]
    assert rule not in _rules(lint_source(good, SRC)), f"{rule} good fixture"
    hits = [f for f in lint_source(bad, SRC) if f.rule == rule]
    assert hits, f"{rule} bad fixture did not trip"
    assert hits[0].path == SRC and hits[0].line > 0


def test_bad_fixtures_are_precise():
    for rule, (_, bad) in FIXTURES.items():
        assert _rules(lint_source(bad, SRC)) == {rule}, rule


def test_lt_cast_is_not_a_heaviside():
    # `< rate` casts make random spike masks, not Heavisides
    src = "def f(u, rate):\n    return (u < rate).to(torch.int8)\n"
    assert not lint_source(src, SRC)


@pytest.mark.parametrize("cast", [".float()", ".to(torch.float32)",
                                  ".to(v.dtype)"])
def test_every_comparison_cast_is_a_heaviside(cast):
    src = f"def f(v, t):\n    return (v >= t){cast}\n"
    assert _rules(lint_source(src, SRC)) == {"NL-BARE-HEAVISIDE"}


def test_host_sync_only_inside_traced_code():
    src = "def f(x):\n    return float(x.sum())\n"   # eager: fine
    assert not lint_source(src, SRC)


@pytest.mark.parametrize("call", ["x.item()", "x.tolist()", "x.cpu()",
                                  "int(x)", "np.asarray(x)",
                                  "torch.cuda.synchronize()"])
def test_host_sync_in_a_tick_path(call):
    src = f"def tick(x):\n    return {call}\n"
    assert _rules(lint_source(src, SRC)) == {"NL-HOST-SYNC"}
    assert not lint_source(f"def step(x):\n    return {call}\n", SRC)


def test_cpu_defaults_are_flagged_outside_resolve_device():
    bad = ("import torch\n\n\ndef f(x, dev=torch.device('cpu')):\n"
           "    return x\n")
    assert _rules(lint_source(bad, SRC)) == {"NL-INTERPRET-HARDCODE"}
    field = ("import dataclasses\n\n\n@dataclasses.dataclass\nclass C:\n"
             "    device: str = 'cpu'\n")
    assert _rules(lint_source(field, SRC)) == {"NL-INTERPRET-HARDCODE"}
    ok = "def resolve_device(device='cpu'):\n    return device\n"
    assert not lint_source(ok, SRC)


def test_suppression_same_line_and_line_above():
    _, bad = FIXTURES["NL-MUTABLE-DEFAULT"]
    line = bad.splitlines()[0]
    same = f"{line}  # neurallint: disable=NL-MUTABLE-DEFAULT\n    return acc\n"
    above = ("# justified  # neurallint: disable=NL-MUTABLE-DEFAULT\n"
             f"{bad}")
    assert not lint_source(same, SRC)
    assert not lint_source(above, SRC)
    # suppressing another rule does not silence this one
    other = f"{line}  # neurallint: disable=NL-HOST-SYNC\n    return acc\n"
    assert _rules(lint_source(other, SRC)) == {"NL-MUTABLE-DEFAULT"}


def test_port_is_clean_and_rule_catalog_is_big_enough():
    findings, checked = lint_paths(root=REPO)
    assert not findings, render(findings)
    assert checked > 50
    assert len(RULES) >= 10
    assert list(RULES) == list(JAX_RULES)


# ------------------------------------------- engine 1: the contract sweep
@pytest.fixture(scope="module")
def report():
    return verify_contracts()


def test_sweep_totality_and_zero_violations(report):
    # every registered (op, mode) pair is reachable by the sweep
    assert report.coverage == report.registered, sorted(report.uncovered)
    assert len(report.registered) >= 24
    assert not report.findings, render(report.findings)


def test_sweep_is_fast(report):
    assert report.duration_s < 60.0
    assert report.cells > 100
    # the cells whose plain versions read operand values ran concretely,
    # and are counted apart
    assert 0 < report.concrete < report.cells
    assert report.abstract + report.concrete == report.cells


def test_silent_downgrade_regression(monkeypatch):
    # a fused_pe dispatch resolving the reference while the policy asked
    # for the fused kernels
    from repro_torch.ops import dispatch, registry

    real = registry.lookup

    def downgrading(op, mode):
        if op == "fused_pe" and mode.startswith("fused"):
            mode = mode.replace("fused", "reference")
        return real(op, mode)

    monkeypatch.setattr(dispatch, "lookup", downgrading)
    report = verify_contracts(only_ops={"fused_pe"})
    assert "NL-SILENT-DOWNGRADE" in _rules(report.findings), \
        render(report.findings)


def test_sweep_leaves_no_sticky_demotions():
    from repro_torch.ops import fallback

    before = fallback.demotions()
    verify_contracts(only_ops={"matmul"})
    assert fallback.demotions() == before


def test_shared_memory_budget_is_enforced(monkeypatch):
    import dataclasses

    from repro_torch.analysis import contracts
    from repro_torch.kernels import contract

    real = contract.kernel_contracts

    def too_big():
        out = real()
        out["lif_update"] = dataclasses.replace(
            out["lif_update"], smem_bytes=lambda *_: 232448 + 1)
        return out

    monkeypatch.setattr(contracts, "kernel_contracts", too_big)
    found = contracts._smem_budget(contracts.kernel_contracts())
    assert _rules(found) == {"NL-VMEM-BUDGET"}
    assert "shared memory per block" in found[0].message
    assert not contracts._smem_budget(real())


# ------------------------------------------------------------ CLI + junit
def test_junit_report_shape():
    from repro_torch.analysis import Finding

    xml = junit_xml([], checked=7)
    assert 'tests="%d"' % len(RULES) in xml and 'failures="0"' in xml
    xml = junit_xml([Finding("NL-HOST-SYNC", "a.py", 3, "sync")], checked=7)
    assert 'failures="1"' in xml and "a.py:3" in xml


def test_finding_requires_catalogued_rule():
    from repro_torch.analysis import Finding

    with pytest.raises(AssertionError):
        Finding("NL-NOT-A-RULE", "a.py", 1, "x")


def test_cli_red_on_seeded_bad_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(FIXTURES["NL-INTERPRET-HARDCODE"][1])
    r = subprocess.run(NEURALLINT + ["--lint-only", "--paths", str(bad)],
                       capture_output=True, text=True)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "NL-INTERPRET-HARDCODE" in r.stdout

    good = tmp_path / "good.py"
    good.write_text(FIXTURES["NL-INTERPRET-HARDCODE"][0])
    r = subprocess.run(NEURALLINT + ["--lint-only", "--paths", str(good)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_junit_artifact(tmp_path):
    out = tmp_path / "lint.xml"
    r = subprocess.run(
        NEURALLINT + ["--lint-only", "--paths",
                      str(REPO / "tools" / "torch_neurallint.py"),
                      "--junit", str(out)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert out.exists() and "<testsuite" in out.read_text()


def test_cli_usage_error_exits_2():
    r = subprocess.run(NEURALLINT + ["--select", "NL-NOT-A-RULE"],
                       capture_output=True, text=True)
    assert r.returncode == 2, r.stdout + r.stderr


# ------------------------------------------------------- kernels.gating
@pytest.mark.parametrize("occ", [None, 0b1011, 0, -1])
def test_accum_tile_packed_with_stripe_skip_equals_dense(occ):
    from repro_torch.core.events import LANE_BITS, pack_words
    from repro_torch.kernels.gating import accum_tile, accum_tile_t

    gen = torch.Generator().manual_seed(0)
    bm, bk, bn = 16, 4 * LANE_BITS, 24
    x = (torch.rand((bm, bk), generator=gen) < 0.3).to(torch.int8)
    keep = [c for c in range(bk // LANE_BITS)
            if occ is None or (occ >> c) & 1]
    # the stripes the bitmap marks silent are silent in x
    for c in range(bk // LANE_BITS):
        if c not in keep:
            x[:, c * LANE_BITS:(c + 1) * LANE_BITS] = 0
    w = torch.randn((bk, bn), generator=gen)
    g = torch.randn((bm, bn), generator=gen)
    want = x.to(torch.float32) @ w
    want_t = x.to(torch.float32).T @ g
    for packed in (False, True):
        xin = pack_words(x) if packed else x
        o = torch.zeros((bm, bn))
        accum_tile(o, xin, w, packed_in=packed, occ_bits=occ)
        torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-5)
        o_t = torch.zeros((bk, bn))
        accum_tile_t(o_t, xin, g, packed_in=packed, occ_bits=occ)
        torch.testing.assert_close(o_t, want_t, rtol=1e-6, atol=1e-5)
