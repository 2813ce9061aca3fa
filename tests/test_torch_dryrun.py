"""The distributed join's dry run (``repro_torch.launch.engine_dryrun``), the
model dry run (``repro_torch.launch.dryrun``), the H100 roofline terms, the
report's dry-run, bench and query modes against the reference's, and the
engine configs."""

import dataclasses
import inspect
import json
import math
from argparse import Namespace
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import barq_engine as PC  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.launch import engine_dryrun as ED  # noqa: E402
from repro_torch.launch import report as PR  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_ranks", [8, 256])
@pytest.mark.parametrize("log2_n,cap_factor", [(12, 2.0), (16, 1.25)])
def test_dryrun_bytes_match_their_closed_forms(n_ranks, log2_n, cap_factor):
    n = 1 << log2_n
    n_local = n // n_ranks
    cap = math.ceil(n_local * cap_factor / n_ranks)
    rec = ED.account(n_local, n_local, n_ranks, cap_factor)
    c = ED.C
    assert cap == D.bucket_cap(n_local, cap_factor, n_ranks)
    assert rec["collectives"]["per_kind_bytes"]["all-to-all"] == 2 * (c + 1) * n_ranks * cap * 4
    assert rec["memory"]["argument_bytes"] == 2 * c * n // n_ranks * 4
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["per_kind_bytes"].values())
    assert rec["cost"]["bytes_per_device"] == sum(s["read"] + s["written"] for s in rec["steps"])
    link = RL.NVLINK_BYTES_PER_S if n_ranks <= 8 else RL.INTER_NODE_BYTES_PER_S
    assert rec["roofline"]["collective_s"] == rec["collectives"]["total_bytes"] / link


def test_roofline_uses_only_the_h100_constants():
    t = RL.roofline_terms(67e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    t = RL.roofline_terms(1.0, 2.0, 50e9, RL.link_bytes_per_s(512))
    assert t["dominant"] == "collective" and t["step_time_lower_bound_s"] == 1.0
    assert RL.link_bytes_per_s(8) == 450e9 and RL.link_bytes_per_s(9) == 50e9
    assert RL.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    # no TPU figure (v5e: 197 TFLOP/s, 819 GB/s HBM) is carried over
    text = inspect.getsource(RL)
    for tpu in ("197e12", "819e9", "TPU"):
        assert tpu not in text


def test_report_renders_port_records(tmp_path):
    for multi in (False, True):
        ED.run(14, 2.0, multi, str(tmp_path))
    recs = PR.load(str(tmp_path))
    assert [r["n_chips"] for r in recs] == [512, 256]  # sorted by file name
    assert all(r["compile_s"] is None for r in recs)
    assert PR.summary(recs) == ("cells ok: 2, failed: 0\n"
                                "dominant-term distribution: {'collective': 2}")
    table = PR.roofline_table(recs, "single").splitlines()
    assert len(table) == 3 and table[2].startswith("| barq-dist-join | edges_2e14_cf2.0 |")
    assert table[2].endswith("| — |")


def test_report_renders_reference_records_alike(tmp_path):
    """A record in the reference's schema renders as the reference's
    report renders it."""
    from repro.launch import report as RR

    rec = dict(arch="x", shape="s", mesh="single", status="ok", compile_s=1.5,
               roofline=dict(compute_s=2e-3, memory_s=5e-7, collective_s=0.0,
                             dominant="compute", step_time_lower_bound_s=2e-3),
               memory=dict(temp_bytes=3e9), useful_flops_ratio=0.5)
    bad = dict(arch="y", shape="t", mesh="single", status="error", error="boom")
    assert PR.roofline_table([rec, bad], "single") == RR.roofline_table([rec, bad], "single")
    assert PR.summary([rec, bad]) == RR.summary([rec, bad])


@pytest.mark.parametrize("bench", ["BENCH_PR2.json", "BENCH_PR3.json"])
def test_path_metrics_table_matches_reference(bench):
    """The bench files with per-suite lists of records and path rows."""
    from repro.launch import report as RR

    got = PR.path_metrics_table(str(ROOT / bench))
    assert got == RR.path_metrics_table(str(ROOT / bench))
    assert len(got.splitlines()) == 4


def test_query_mode_matches_reference(capsys):
    """``--query q6 --device cpu --json``: the reference's row count and
    trace summary keys."""
    from repro.launch import report as RR

    assert PR.main(["--query", "q6", "--device", "cpu", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    args = Namespace(sparql=None, query="q6", scale=0.05, engine="barq", json=True, trace=None)
    assert RR.query_report(args, None) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["rows"] == want["rows"] == 1
    assert got.keys() == want.keys()
    assert got["spans_ms"].keys() == want["spans_ms"].keys()


def test_query_mode_prints_the_telemetry_surface(capsys, tmp_path):
    trace = tmp_path / "q4.json"
    assert PR.main(["--query", "q4", "--device", "cpu", "--trace", str(trace)]) == 0
    out = capsys.readouterr().out
    for part in ("plan (EXPLAIN):", "operators (EXPLAIN ANALYZE):", "lifecycle spans:",
                 "kernel attribution:", "(barq engine, cpu): 1 rows"):
        assert part in out
    assert json.loads(trace.read_text())["traceEvents"]
    with pytest.raises(SystemExit):
        PR.main(["--query", "q99", "--device", "cpu"])


@pytest.mark.parametrize("name", ["BARQ_DEFAULT", "LEGACY_BASELINE", "MIXED_MIGRATION"])
def test_engine_configs_match_reference(name):
    from repro.configs import barq_engine as RC

    assert dataclasses.asdict(getattr(PC, name)) == dataclasses.asdict(getattr(RC, name))
    assert PC.DIST_JOIN_SHAPES == RC.DIST_JOIN_SHAPES


# the keys of the reference's dry-run record of an LM cell
# (``src/repro/launch/dryrun.py``'s ``run_cell``)
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "description", "n_chips", "lower_s",
                  "compile_s", "scan_body_extrapolated", "overrides", "memory", "cost",
                  "collectives", "roofline", "hw", "model_flops_global", "useful_flops_ratio",
                  "wall_s"}


def test_model_dry_run_record_has_the_reference_keys_and_renders(tmp_path):
    """A reduced qwen3-8b ``train_4k`` on a fake (2, 2) group: the
    reference's keys (and sub-keys), null ``compile_s`` / ``code_bytes``,
    traced layers, collectives in both directions; ``report.py`` renders it
    as it renders the reference's records."""
    from repro.launch import report as RR
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("qwen3-8b", "train_4k", False, str(tmp_path),
                          overrides=dict(global_batch=4, seq_len=32), use_reduced=True,
                          mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    assert REFERENCE_KEYS <= rec.keys()
    assert {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes"} <= rec["memory"].keys()
    assert rec["cost"].keys() == {"flops_per_device", "bytes_per_device", "global_flops"}
    assert rec["collectives"].keys() == {"per_kind_bytes", "per_kind_counts", "total_bytes"}
    assert rec["compile_s"] is None and rec["memory"]["code_bytes"] is None
    assert rec["scan_body_extrapolated"] is False and rec["n_chips"] == 4
    assert rec["collectives"]["per_kind_counts"]["all-reduce"] > 0
    assert rec["hw"]["peak_flops"] == RL.PEAK_BF16_FLOPS_PER_S
    assert rec["roofline"]["compute_s"] == rec["cost"]["flops_per_device"] / 989e12
    want_useful = 6.0 * get_reduced("qwen3-8b").param_count() * 4 * 32
    assert rec["model_flops_global"] == want_useful
    assert rec["useful_flops_ratio"] == want_useful / (rec["cost"]["flops_per_device"] * 4)
    recs = PR.load(str(tmp_path))
    # the port writes the null compile time as a dash where the reference prints None
    assert PR.roofline_table(recs, "single") == RR.roofline_table(recs, "single").replace(
        "| None |", "| — |")
    assert PR.summary(recs) == RR.summary(recs)
    assert json.loads((tmp_path / "qwen3-8b__train_4k__single.json").read_text()) == rec


def test_model_dry_run_records_a_failure(tmp_path):
    """A layout that does not divide fails the cell with the leaf named, as
    the reference records a failed compile."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("qwen3-8b", "train_4k", False, str(tmp_path),
                          overrides=dict(global_batch=4, seq_len=32), use_reduced=True,
                          mesh_shape=(1, 3))
    assert rec["status"] == "failed" and "does not divide" in rec["error"]
    assert "traceback" in rec


def get_reduced(arch_id):
    from repro_torch.configs import get_config

    return get_config(arch_id).reduced_model
