"""The harness on the CPU: the window's arithmetic, cells found by name,
the refusal without a card, the isolation from JAX, the planted faults and
a rehearsal of every cell of BENCHMARK.json at a tiny size."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from barqbench import harness as H
from barqbench import window

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# tiny sizes of each configuration for the CPU, in products
TINY = {"bsbm-7m": 300}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells():
    return [w["name"] for w in bench()["workloads"]]


def rehearse(workload, trace=False, seconds=0.1, seed=2**31 + 5):
    b = bench()
    (w,) = [c for c in b["workloads"] if c["name"] == workload]
    return H.run_cell(b, ROOT, workload, seed, seconds, trace, device="cpu",
                      products=TINY[w["config"]], log=lambda _msg: None)


# -- the window's arithmetic ---------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_closes_on_the_first_round_ending_after_the_length():
    clock = FakeClock()
    durations = iter([3.0, 3.0, 3.0, 3.0, 3.0])

    def serve(rnd):
        clock.t += next(durations)
        return list(rnd)

    rounds = iter([["a", "b"]] * 5)
    records, window_s, n = window.drive(serve, rounds, 7.0, clock)
    assert n == 3 and window_s == 9.0 and records == ["a", "b"] * 3
    clock.t = 0.0
    durations = iter([7.0, 1.0])
    records, window_s, n = window.drive(serve, iter([["x"]] * 2), 7.0, clock)
    assert n == 1 and window_s == 7.0


def test_qps_is_over_the_window_not_over_summed_latency():
    assert window.qps(12, 4.0) == 3.0
    lat = [0.1] * 12  # summed latency 1.2 s; the window held waits too
    assert window.qps(len(lat), 4.0) != len(lat) / sum(lat)


def test_p95_over_all_requests():
    lat = np.arange(1, 201) / 1000.0  # 1..200 ms
    assert window.p95_ms(lat) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert window.p95_ms(lat) == pytest.approx(190.05)
    rng = np.random.RandomState(0)
    lat = rng.exponential(0.1, 400)
    assert window.p95_ms(lat) == pytest.approx(np.sort(lat)[int(0.95 * 399)] * 1e3, rel=0.05)


def test_device_ms_per_query_is_busy_time_over_the_probed_requests():
    from barqbench import tracing

    read = H.reader("device_ms_per_query")
    t = tracing.Timeline(queries=19, window_s=20.0, busy_s=0.95, launches=1, op_s={},
                         ported_s=0.0, ported_n={}, gaps=[], attributed=1.0)
    assert read({"timeline": t}) == pytest.approx(50.0)
    assert read({"timeline": None}) is None
    assert H.reader("window_qps")({"requests": [{}] * 38, "window_s": 19.0}) == 2.0


def test_probe_sends_the_same_requests_whatever_the_seed():
    from barqbench import traffic
    from barqbench.reference import data as refdata

    mix = json.loads((BENCH / "mixes" / "explore.json").read_text())
    conf = json.loads((BENCH / "configs" / "bsbm-7m.json").read_text())
    meta = refdata.graph_for(conf, 7, TINY["bsbm-7m"]).meta
    probe = mix["probe_constants_seed"]
    a, b = (next(traffic.rounds(mix, meta, s, probe)) for s in (11, 12))
    assert sorted(r.text for r in a) == sorted(r.text for r in b)
    assert [r.text for r in a] != [r.text for r in b]
    window_round = next(traffic.rounds(mix, meta, 11))
    assert not {r.text for r in a} & {r.text for r in window_round if r.consts}


# -- cells found by name, the refusals, isolation ---------------------------------

def _copy_tree(dst: Path, with_src: bool):
    shutil.copytree(BENCH, dst / "barqbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    if with_src:
        os.symlink(ROOT / "src", dst / "src")


def _python(cwd: Path, code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_new_mix_and_metric_are_found_by_name(tmp_path):
    """A mix file, a metric file and their BENCHMARK.json entries are all a
    new cell needs; the rehearsal in a fresh process loads neither JAX nor
    the JAX package."""
    _copy_tree(tmp_path, with_src=True)
    mix = json.loads((BENCH / "mixes" / "explore.json").read_text())
    mix["queries"] = {"q2": mix["queries"]["q2"]}
    (tmp_path / "barqbench" / "mixes" / "only_q2.json").write_text(json.dumps(mix))
    (tmp_path / "barqbench" / "metrics" / "requests_seen.py").write_text(
        "def read(facts):\n    return float(len(facts['requests']))\n")
    b = bench()
    b["workloads"].append({"name": "bsbm-7m.only_q2", "config": "bsbm-7m",
                           "traffic": "only_q2", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "serving and front end",
                           "moves": "device_ms_per_query"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys, json; sys.path[:0] = ['.', 'src']\n"
        "from pathlib import Path\n"
        "from barqbench import harness as H\n"
        "b = json.loads(Path('BENCHMARK.json').read_text())\n"
        "out = H.run_cell(b, Path('.'), 'bsbm-7m.only_q2', 3, 0.2, True, device='cpu',"
        " products=300, log=lambda m: None)\n"
        "print(json.dumps([out, H.forbidden_modules()]))\n")
    res = _python(tmp_path, code)
    assert res.returncode == 0, res.stderr[-2000:]
    out, forbidden = json.loads(res.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert out["correct"] and out["attempted"] > 0
    assert out["metrics"]["requests_seen"]["value"] >= 1


def _no_result(res):
    lines = res.stdout.strip().splitlines()
    return not any(line.startswith("{") for line in lines)


def test_command_without_a_card_exits_with_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "barqbench/run.py", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0 and _no_result(res), res.stderr[-2000:]
    assert "no result" in res.stderr


def test_command_without_the_program_exits_with_no_result(tmp_path):
    _copy_tree(tmp_path, with_src=False)
    res = subprocess.run([sys.executable, "barqbench/run.py", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and _no_result(res)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(BENCH / path)}
    assert not tops & set(H.FORBIDDEN), tops
    if path.startswith("reference/"):
        assert "repro_torch" not in tops and "torch" not in tops


# -- faults planted under the timed path ---------------------------------------------

def _plant(monkeypatch, fault):
    from repro_torch.serve import query_server

    real = query_server.QueryServer.execute

    def broken(self, key, text):
        res = real(self, key, text)
        rows = res.rows
        if fault == "half" and len(rows):
            res.rows = rows[: len(rows) // 2]
        elif fault == "altered" and len(rows):
            rows = rows.copy()
            rows[-1, -1] = rows[0, 0] + 1 if rows[-1, -1] != rows[0, 0] + 1 else rows[0, 0] + 2
            res.rows = rows
        return res

    monkeypatch.setattr(query_server.QueryServer, "execute", broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("workload", cells())
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    """Half of each answer's rows left out, or one answer altered where it
    is produced: ``correct`` comes out false."""
    _plant(monkeypatch, fault)
    out = rehearse(workload)
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] > 0


# -- a rehearsal of every cell ---------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", cells())
def test_rehearsal_prints_the_contracts_line(workload, trace):
    out = rehearse(workload, trace=trace)
    line = json.loads(json.dumps(out))
    assert RESULT_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    b = bench()
    if trace:
        # on the CPU only the host-side readers find something to read
        assert {"outside_execute_ms", "store_build_s"} <= set(line["metrics"])
        assert "window_qps" in line["metrics"]
    else:
        # the device's metrics need the card; the host's are all there
        want = {m["name"] for m in b["end_to_end"] if m["source"] == "host_clock"
                and ("workloads" not in m or workload in m["workloads"])}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
