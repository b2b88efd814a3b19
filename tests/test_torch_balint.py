"""balint turned on the port (``repro_torch.analysis``), on the CPU.

* The determinism pass finds, on ``tests/balint_fixtures/`` (outside
  both packages, so every rule applies), exactly the reference pass's
  ``(rule, file, line)`` set; its own RNG rule takes ``torch.rand*``
  without a ``generator=``.
* Suppressions and the baseline partition behave as the reference's
  (``tests/test_balint.py``).
* ``run_analysis()`` over ``src/repro_torch`` is strict-clean against
  the port's baseline, and the protocol pass is clean.
* The host-sync census reproduces ``BENCH_sync_census.json``'s ticks in
  all six arms, counts the same twice, and each fused arm reads the
  device back less often a tick than its tick arm.
"""
from __future__ import annotations

import json
import pathlib

import pytest
import torch

from repro.analysis import determinism as jdeterminism
from repro_torch.analysis import run_analysis
from repro_torch.analysis import census, determinism, protocol, purity
from repro_torch.analysis.report import Report, render_json, render_text
from repro_torch.analysis.violations import (DEFAULT_BASELINE, RULES,
                                             RULE_FAMILIES, Baseline,
                                             Violation, apply_suppressions)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "balint_fixtures"
BENCH = json.loads((ROOT / "BENCH_sync_census.json").read_text())["census"]


def _key(vs):
    return {(v.rule, v.path, v.line) for v in vs}


# ---------------------------------------------------------------------------
# determinism: the reference's findings on the fixtures, and torch's RNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           FIXTURES.glob("*.py")))
def test_fixture_findings_are_the_references(fixture):
    got = _key(determinism.run([FIXTURES / fixture]))
    want = _key(jdeterminism.run([FIXTURES / fixture]))
    assert got == want


@pytest.mark.parametrize("fixture,rule,count", [
    ("bad_wall_clock.py", "wall-clock", 4),
    ("bad_rng.py", "unseeded-rng", 3),
    ("bad_set_iter.py", "set-iteration", 3),
    ("bad_dict_order.py", "dict-order", 1),
    ("bad_mutable_default.py", "mutable-default", 3),
])
def test_rule_positive(fixture, rule, count):
    found = [v for v in determinism.run([FIXTURES / fixture])
             if v.rule == rule]
    assert len(found) == count, [(v.line, v.message) for v in found]


def test_clean_fixture_is_clean():
    assert determinism.run([FIXTURES / "good_clean.py"]) == []


def test_torch_rng_without_a_generator_is_flagged(tmp_path):
    f = tmp_path / "torch_rng.py"
    f.write_text(
        "import torch\n"
        "g = torch.Generator().manual_seed(0)\n"
        "a = torch.randn(3)\n"                          # line 3: flagged
        "b = torch.randint(0, 9, (2,))\n"               # line 4: flagged
        "c = torch.rand(2, generator=g)\n"              # seeded: clean
        "d = torch.randperm(5)\n"                       # line 6: flagged
        "e = torch.zeros(2).random_(generator=g)\n"     # not torch.rand*
        "h = torch.randn(3, generator=g)\n")            # seeded: clean
    vs = [v for v in determinism.run([f]) if v.rule == "unseeded-rng"]
    assert sorted(v.line for v in vs) == [3, 4, 6]
    assert all("generator=" in v.message for v in vs)


def test_scoping_follows_the_port():
    """Inside src/repro_torch the wall clock is fine outside core/,
    kernels/ and data/, and dict order only matters in the wire
    modules; the reference's own tree is outside the port's scope."""
    assert determinism._rule_applies(
        "wall-clock", ROOT / "src/repro_torch/core/rdma.py")
    assert not determinism._rule_applies(
        "wall-clock", ROOT / "src/repro_torch/examples/allreduce_dlrm.py")
    assert not determinism._rule_applies(
        "dict-order", ROOT / "src/repro_torch/core/fused.py")
    assert determinism._rule_applies(
        "dict-order", ROOT / "src/repro/core/fused.py")


# ---------------------------------------------------------------------------
# suppressions and the baseline (as tests/test_balint.py)
# ---------------------------------------------------------------------------

def test_suppression_comments():
    raw = determinism.run([FIXTURES / "suppressed.py"])
    assert {v.rule for v in raw} == {"wall-clock", "mutable-default"}
    assert apply_suppressions(raw) == []


def test_suppression_is_rule_scoped():
    v = Violation("unseeded-rng", "tests/balint_fixtures/suppressed.py",
                  7, "synthetic")
    assert apply_suppressions([v]) == [v]


def test_baseline_partition_and_expiry():
    v_live = Violation("wall-clock", "a.py", 3, "wall-clock read")
    v_new = Violation("dict-order", "b.py", 9, "unsorted send loop")
    baseline = Baseline([
        {"rule": "wall-clock", "path": "a.py",
         "message": "wall-clock read", "reason": "deliberate"},
        {"rule": "set-iteration", "path": "gone.py",
         "message": "iteration over a set", "reason": "was deliberate"},
    ])
    active, baselined, expired = baseline.partition([v_live, v_new])
    assert active == [v_new]
    assert baselined == [v_live]
    assert [e["path"] for e in expired] == ["gone.py"]
    assert not Report(active, baselined, expired, ["determinism"]).strict_ok


def test_baseline_line_churn_immune():
    v = Violation("wall-clock", "a.py", 99, "wall-clock read")
    baseline = Baseline([{"rule": "wall-clock", "path": "a.py",
                          "message": "wall-clock read", "reason": "x"}])
    assert baseline.partition([v]) == ([], [v], [])


def test_fixture_dir_fails_strict():
    report = run_analysis(paths=[FIXTURES], passes=["determinism"],
                          baseline_path=None)
    assert not report.strict_ok
    assert len(report.violations) >= 10


def test_reporters_render():
    v = Violation("wall-clock", "a.py", 3, "wall-clock read `time.time()`")
    r = Report([v], [], [{"rule": "dict-order", "path": "b.py",
                          "message": "gone", "reason": "was deliberate"}],
               ["determinism"])
    text = render_text(r)
    assert "a.py:3" in text and "EXPIRED" in text and "FAIL" in text
    doc = json.loads(render_json(r))
    assert doc["strict_ok"] is False
    assert doc["violations"][0]["rule"] == "wall-clock"


def test_every_rule_has_a_family_and_a_contract():
    owned = set().union(*RULE_FAMILIES.values())
    assert set(RULES) <= owned
    # the reference's purity rules all stay, each with its line
    for rule in ("host-callback", "f64-promotion", "missing-donation",
                 "concretization"):
        assert rule in RULES and rule in RULE_FAMILIES["purity"]


# ---------------------------------------------------------------------------
# the port's tree: strict-clean, protocol clean, the purity inventory
# ---------------------------------------------------------------------------

def test_port_is_strict_clean_against_its_baseline():
    report = run_analysis()
    assert report.strict_ok, render_text(report)
    baseline = Baseline.load(DEFAULT_BASELINE)
    assert len(report.baselined) == len(baseline.entries)
    assert all(e["reason"] and not e["reason"].startswith("TODO")
               for e in baseline.entries)
    # every baselined finding is the purity pass's: no determinism or
    # protocol debt in the port
    assert {v.rule for v in report.baselined} <= RULE_FAMILIES["purity"]


def test_protocol_pass_clean():
    assert protocol.run() == []


def test_purity_flags_a_break_a_sync_and_float64():
    def leaky(x):
        y = x.double() * 2                    # float64 in the graph
        if float(y.sum()) > 0:                # host read: a graph break
            return y + 1
        return y

    ep = purity.EntryPoint("leaky", leaky,
                           lambda: ((torch.ones(3),), {}))
    rules = {v.rule for v in purity.check_entry(ep)}
    assert rules == {"graph-break", "host-sync", "f64-promotion"}

    def clean(x):
        return (x * 2).sum(0)
    ep = purity.EntryPoint("clean", clean, lambda: ((torch.ones(3, 2),), {}))
    assert purity.check_entry(ep) == []


# ---------------------------------------------------------------------------
# the host-sync census
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def census_doc():
    return census.run_census(device="cpu")


def test_census_ticks_are_the_benchmarks(census_doc):
    got = census_doc["census"]
    assert sorted(got) == sorted(BENCH)
    for arm, row in BENCH.items():
        assert got[arm]["ticks"] == row["ticks"], arm
        assert got[arm]["d2h"] == sum(got[arm]["sites"]["d2h"].values())
        assert got[arm]["h2d"] == sum(got[arm]["sites"]["h2d"].values())
    print({arm: (c["d2h_per_tick"], c["h2d_per_tick"],
                 BENCH[arm]["d2h_per_tick"], BENCH[arm]["h2d_per_tick"])
           for arm, c in got.items()})


def test_census_counts_the_same_twice(census_doc):
    assert census.run_census(device="cpu") == census_doc


def test_census_fused_arms_read_back_less_a_tick(census_doc):
    c = census_doc["census"]
    for arm in ("fig6", "fig10", "fig11"):
        assert 0 < c[f"{arm}_fused"]["d2h_per_tick"] < c[arm]["d2h_per_tick"]
        assert c[arm]["h2d"] > 0


def test_census_scan_vs_batched_identical():
    """The scan oracle and the batched engine read the device back once
    an RX batch each (the QPN column, the wave count), so a world
    crosses the boundary equally often with either."""
    scan = census.census_fig6(n_senders=2, message_bytes=8192,
                              engine="scan", device="cpu")
    batched = census.census_fig6(n_senders=2, message_bytes=8192,
                                 engine="batched", device="cpu")
    strip = lambda c: {k: v for k, v in c.items() if k != "sites"}  # noqa
    assert strip(scan) == strip(batched)
    assert scan["d2h"] > 0 and scan["h2d"] > 0


def test_census_counts_calls_not_values():
    """What counts: reads of device tensors and copies onto the device;
    host tensors (from numpy, or from a counted .cpu()) read nothing
    back; counting leaves torch as it found it."""
    import numpy as np
    from repro_torch.device import to_device
    before = (torch.Tensor.cpu, torch.Tensor.to, torch.as_tensor)
    with census.sync_census() as c:
        d = to_device(np.arange(4, dtype=np.int32), torch.device("cpu"))
        h = d.cpu()                    # d2h 1 (on the CPU, d itself)
        torch.from_numpy(np.zeros(2)).numpy()     # host: nothing
        int(d[0])                      # d2h 2
        d.tolist()                     # d2h 3
        torch.as_tensor(np.zeros(2)).to(torch.device("cpu"))   # h2d 2
        d.to(torch.float32)            # dtype only: nothing
    assert (c.d2h, c.h2d) == (3, 2)
    assert (torch.Tensor.cpu, torch.Tensor.to, torch.as_tensor) == before
