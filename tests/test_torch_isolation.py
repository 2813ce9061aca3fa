"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, runs on the card unless asked for the CPU, and refuses what it
has not ported instead of evaluating it another way; the configurations
and plan nodes it has since ported run and give the reference's rows."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                     ROOT / "kernel_sweep.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_are_found():
    assert len(PORT_FILES) > 30
    assert (ROOT / "src" / "repro_torch" / "kernels" / "join_expand.py") in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def _cpu_store():
    store, _ = repro_torch.generate_social_graph(scale=0.02, seed=1, device="cpu")
    return store


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    store = _cpu_store()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.Engine(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.QuadStore()
    from repro_torch.core.distributed import engine_group

    with pytest.raises(RuntimeError, match="CUDA"):
        engine_group()
    from repro_torch.configs import get_config
    from repro_torch.models.gnn.sampler import BARQSampler
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.lm_server import LMServer

    cfg = get_config("qwen3-8b").reduced_model
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMServer(cfg, init_params(cfg, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        BARQSampler(store, ":knows")
    from repro_torch.launch import train as LT
    from repro_torch.launch.steps import _gnn_graph_shape, build_step
    from repro_torch.models.gnn import models as GNN
    from repro_torch.models.recsys import dcn as DCN

    gs = get_config("graphsage-reddit")
    gshape = _gnn_graph_shape(gs, "full_graph_sm", gs.reduced_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        GNN.init(0, gs.reduced_model, gshape)
    with pytest.raises(RuntimeError, match="CUDA"):
        GNN.make_graph_inputs(gshape)
    with pytest.raises(RuntimeError, match="CUDA"):
        DCN.init_params(get_config("dcn-v2").reduced_model, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.run("graphsage-reddit", "full_graph_sm", 2, "unused")
    # a bundle allocates nothing: its step runs where its inputs are
    assert build_step(gs, "full_graph_sm", use_reduced=True).fn
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh

    for make in (make_smoke_mesh, make_production_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("field,value", [
    ("cardinality_feedback", "apply"),
    ("cardinality_feedback", "observe"),
])
def test_config_outside_the_slice_raises(field, value):
    """Cardinality feedback is ported: both values run a query, and a value
    the reference does not accept either raises ValueError naming the
    field."""
    store = _cpu_store()
    cfg = repro_torch.EngineConfig(**{field: value})
    res = repro_torch.Engine(store, cfg, device="cpu").execute(
        "SELECT ?a ?b { ?a :knows ?b }")
    assert res.n_rows > 0
    with pytest.raises(ValueError, match=field):
        repro_torch.Engine(store, repro_torch.EngineConfig(**{field: value + "ly"}),
                           device="cpu")


@pytest.mark.parametrize("engine", ["legacy", "mixed"])
def test_engine_values_are_accepted_and_run(engine):
    """The row engine and the mixed engine run, and give the rows of the
    default configuration."""
    store = _cpu_store()
    q = ("SELECT ?p (COUNT(?t) AS ?n) { ?p :knows ?q . ?q :hasInterest ?t . "
         "FILTER (?p != ?q) } GROUP BY ?p")
    base = repro_torch.Engine(store, device="cpu").execute(q).rows
    got = repro_torch.Engine(store, repro_torch.EngineConfig(engine=engine),
                             device="cpu").execute(q).rows
    assert len(base) > 0
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, base.tolist()))


@pytest.mark.parametrize("field,value", [
    ("spill_dir", "spill"),
    ("memory_budget", 0),
    ("memory_budget", 1 << 20),
    ("adaptive_join", "on"),
])
def test_out_of_core_config_is_accepted_and_runs(tmp_path, field, value):
    """The out-of-core and adaptive values run, and give the rows of the
    default configuration; a spill directory is left empty."""
    if field == "spill_dir":
        value = str(tmp_path / value)
        (tmp_path / "spill").mkdir()
    store = _cpu_store()
    q = ("SELECT ?p (COUNT(?t) AS ?n) { ?p :knows ?q . ?q :hasInterest ?t } GROUP BY ?p")
    base = repro_torch.Engine(store, device="cpu").execute(q).rows
    cfg = repro_torch.EngineConfig(**{field: value, "spill_dir": str(tmp_path)}
                                   if field == "memory_budget" else {field: value})
    got = repro_torch.Engine(store, cfg, device="cpu").execute(q).rows
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, base.tolist()))
    assert not list(tmp_path.rglob("*.npy"))


@pytest.mark.parametrize("field,value", [("join_strategy", "sort"), ("sip", "auto"),
                                         ("adaptive_join", "sometimes"),
                                         ("memory_budget", -1)])
def test_config_the_reference_lacks_is_refused(field, value):
    cfg = repro_torch.EngineConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        repro_torch.Engine(_cpu_store(), cfg, device="cpu")


def _path_scan_plan(PL, A):
    """A hand-built PPathScan: the row engine's `+` node, which the planner
    no longer emits."""
    return PL.PPathScan(A.TriplePattern(A.V(0), A.K(":knows"), A.V(1), A.K(":default")))


def _grace_join_plan():
    """A hand-built grace (partitioned, out-of-core) hash join, which the
    planner emits only under a memory budget."""
    from repro_torch.core import algebra as A
    from repro_torch.core import planner as PL

    def scan(pred, obj):
        return PL.PScan(A.TriplePattern(A.V(0), A.K(pred), A.V(obj), A.K(":default")), None)

    return PL.PHashJoin(scan(":knows", 1), scan(":hasInterest", 2), keys=(0,), grace=True,
                        grace_parts=8)


def _uncompilable_filter_plan(PL, A):
    """A FILTER whose expression the VM cannot compile (an unknown
    function): the interpreted expression walk evaluates it."""
    scan = PL.PScan(A.TriplePattern(A.V(0), A.K(":knows"), A.V(1), A.K(":default")), None)
    return PL.PFilter(A.Func("strlen", (A.VarRef(1),)), scan)


def _outcome(engine, plan):
    """A plan's sorted rows, or the type and message of what it raised."""
    try:
        return sorted(map(tuple, engine.execute_plan(plan).rows.tolist()))
    except Exception as e:  # the reference's refusal is the answer to match
        return type(e).__name__, str(e)


@pytest.mark.parametrize("query", [_uncompilable_filter_plan, _path_scan_plan],
                         ids=["uncompilable expression", "PPathScan"])
def test_plan_formerly_outside_the_slice_runs(query):
    """Both hand-built plans run under every engine and end as the
    reference's do: the path scan with its rows, the FILTER in the tree
    walk, which refuses an unknown function with the reference's error."""
    from repro.core import Engine as REngine
    from repro.core import EngineConfig as RConfig
    from repro.core import algebra as RA
    from repro.core import planner as RPL
    from repro.data.lsqb import generate_social_graph as ref_social_graph
    from repro_torch.core import algebra as A
    from repro_torch.core import planner as PL

    store = _cpu_store()
    ref_store, _ = ref_social_graph(scale=0.02, seed=1)
    for engine in ("barq", "legacy", "mixed"):
        want = _outcome(REngine(ref_store, RConfig(engine=engine)), query(RPL, RA))
        got = _outcome(repro_torch.Engine(store, repro_torch.EngineConfig(engine=engine),
                                          device="cpu"), query(PL, A))
        assert got == want, engine
    if query is _path_scan_plan:
        assert len(got) > 0
    else:
        assert got[0] == "ValueError"


def test_grace_join_plan_runs(tmp_path):
    """The hand-built grace hash join runs under a budget, spills, and
    gives the resident join's rows."""
    from repro_torch.core.operators.hash_join import HashJoin

    store = _cpu_store()
    plan = _grace_join_plan()
    want = repro_torch.Engine(store, device="cpu").execute_plan(
        dataclasses.replace(plan, grace=False)).rows
    engine = repro_torch.Engine(store, repro_torch.EngineConfig(
        memory_budget=1 << 10, spill_dir=str(tmp_path)), device="cpu")
    res = engine.execute_plan(plan)
    assert sorted(map(tuple, res.rows.tolist())) == sorted(map(tuple, want.tolist()))
    assert isinstance(res.root, HashJoin) and res.root.stats.extra["spill_files"] > 0
    assert res.root.stats.extra["grace_partitions"] == 8
    assert not list(tmp_path.glob("*.npy"))


def test_kernels_take_no_other_device():
    """Only CPU tensors reach the plain versions; anything else launches
    the CUDA kernel or raises."""
    from repro_torch.kernels import bloom_filter as BF
    from repro_torch.kernels import frontier_dedup as FD
    from repro_torch.kernels import gather_emit as GE
    from repro_torch.kernels import hash_join as HJ
    from repro_torch.kernels import join_expand as JE
    from repro_torch.kernels import radix_partition as RP
    from repro_torch.kernels import segment_scan as SS
    from repro_torch.kernels import sorted_search as SR

    meta = [torch.zeros(3, dtype=torch.int32, device="meta") for _ in range(4)]
    cum = torch.zeros(4, dtype=torch.int64, device="meta")
    starts = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        JE.join_expand(*meta, cum, 0, 2)
    with pytest.raises(ValueError, match="device"):
        GE.gather_emit(meta[0][None, :], None, meta[1], None, GE.EmitPlan((0,)))
    with pytest.raises(ValueError, match="device"):
        SS.segment_scan(meta[0], torch.zeros(3, dtype=torch.float64, device="meta"), "sum")
    with pytest.raises(ValueError, match="device"):
        RP.radix_partition(meta[0], 4)
    with pytest.raises(ValueError, match="device"):
        HJ.hash_build(None, meta[0], 4)
    with pytest.raises(ValueError, match="device"):
        HJ.hash_probe(starts, None, meta[0], None, meta[1])
    with pytest.raises(ValueError, match="device"):
        BF.bloom_build(meta[0])
    with pytest.raises(ValueError, match="device"):
        BF.bloom_probe(meta[0][:2], meta[1])
    with pytest.raises(ValueError, match="device"):
        SR.sorted_search(meta[0], meta[1], "left")
    with pytest.raises(ValueError, match="device"):
        FD.frontier_dedup(*meta)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
