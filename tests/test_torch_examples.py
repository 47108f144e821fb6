"""The port's examples (`examples/*_torch.py`), held against the reference.

Each example runs in process through its `main([...])` with `--device cpu`
(the kernels' plain PyTorch versions) and is compared with the reference's
own library calls, made with the arguments the reference example passes
(cited by line), on the same workloads; where the reference example is as
cheap, its printed lines too, with the wall times masked (and, on the
scenario lines, the launch note, which the port replaces by the launches it
counted). Tolerance: exact — configs, float64 metrics, counters, report
strings. `serve_photonic` is in `tests/test_torch_examples_serve.py`.
"""
import functools
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core as R
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs.base import ShapeConfig as RefShape
from repro.core.extract import workload_for as ref_workload_for
from repro.core.paper_workloads import PAPER_WORKLOADS as REF_WORKLOADS
from repro.core.paper_workloads import load as ref_load
from repro.scenarios import ScenarioGrid as RefGrid
from repro.scenarios import sweep as ref_sweep
from repro.serve import SearchService as RefService

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "arch_cosearch", "scenario_zoo", "serve_photonic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (restored after it): beside
    other test processes the default pools spin against each other; every
    result here is exact either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def example(name: str, torch_port: bool = True):
    """The example module loaded by path (`examples/<name>_torch.py`, or
    the reference's `examples/<name>.py`)."""
    stem = f"{name}_torch" if torch_port else name
    spec = importlib.util.spec_from_file_location(
        f"examples_{stem}", ROOT / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(name, argv, capsys):
    capsys.readouterr()
    out = example(name).main([*argv, "--device", "cpu"])
    return out, capsys.readouterr().out


def run_reference(name, argv, capsys, monkeypatch):
    """The reference example's stdout (its `main()` reads `sys.argv`)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    example(name, torch_port=False).main()
    return capsys.readouterr().out


_TIMES = [(re.compile(r"in \d+\.\d+s\b"), "in <t>s"),
          (re.compile(r"\d+(\.\d+)?ms\b"), "<t>ms"),
          (re.compile(r"\(\d+ ms for all"), "(<t> ms for all")]


def masked(text: str):
    """Printed lines without wall times, launch notes and the cuda
    engine's MAX_FRONT overflow notes (exact, host-refined: part of its
    output, not of the answer)."""
    lines = []
    for line in text.splitlines():
        if line.startswith("pareto kernel:"):
            continue
        if line.startswith("-- scenario:"):
            line = line.split(" (")[0]
        for pat, rep in _TIMES:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines


def nan_as_text(x):
    """`x` with every float NaN as the string "nan" (an infeasible result's
    metrics are NaN, and NaN != NaN), so that `==` compares exactly."""
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, dict):
        return {k: nan_as_text(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(nan_as_text(v) for v in x)
    return x


def cfg_tuple(c):
    return None if c is None else tuple(int(v) for v in c.as_array())


def result_dict(r):
    """`quickstart_torch._result` of a reference SearchResult."""
    return {"config": cfg_tuple(r.best_cfg), "area_mm2": r.area_mm2,
            "power_w": r.power_w, "energy_j": r.energy_j,
            "latency_s": r.latency_s, "edp": r.edp,
            "n_evaluated": r.n_evaluated,
            "n_workload_evals": r.n_workload_evals, "feasible": r.feasible}


# ---------------------------------------------------------- quickstart ---

QUICKSTART = {"deit-b": [], "bert-l": ["--workload", "bert-l"],
              "area-10": ["--area", "10"]}


@functools.lru_cache(maxsize=None)
def ref_quickstart(case):
    """`examples/quickstart.py:27-53`'s library calls."""
    argv = dict(zip(QUICKSTART[case][::2], QUICKSTART[case][1::2]))
    scores = R.observe_significance()                                # :28
    cons = R.Constraints(area_mm2=float(argv.get("--area", 50.0)),   # :33
                         power_w=5.0, energy_mj=50.0, latency_ms=10.0)
    wl = ref_load(argv.get("--workload", "deit-b"))                  # :35
    r = R.dxpta_search(wl, cons, significance=scores)                # :38
    out = {"scores": {n: (s.s_area, s.s_power) for n, s in scores.items()},
           "significant": R.significant_params(scores),              # :31
           "found": result_dict(r)}
    if r.feasible:
        ex = R.grid_search_vectorized(wl, cons)                      # :49
        out["exhaustive"] = result_dict(ex)
        out["edp_ratio"] = r.edp / ex.edp
    return out


@pytest.mark.parametrize("case", sorted(QUICKSTART))
def test_quickstart_equals_the_reference(case, capsys):
    got, text = run_port("quickstart", QUICKSTART[case], capsys)
    assert nan_as_text(got) == nan_as_text(ref_quickstart(case))
    assert got["found"]["feasible"] is (case != "area-10")
    if case == "area-10":
        assert "  NO feasible config under these constraints." in text
        assert "exhaustive" not in got


def test_quickstart_prints_the_references_lines(capsys, monkeypatch):
    _, text = run_port("quickstart", [], capsys)
    want = run_reference("quickstart", [], capsys, monkeypatch)
    assert masked(text) == masked(want)


# ------------------------------------------------------- arch_cosearch ---

@functools.lru_cache(maxsize=None)
def ref_arch_rows():
    """`examples/arch_cosearch.py:47-69`'s library calls (serve_2k, the
    50 mm^2 / 5 W box, numpy engine)."""
    shape = RefShape("serve_2k", seq_len=2048, global_batch=1,
                     kind="prefill")                                 # :50
    cons = R.Constraints(area_mm2=50.0, power_w=5.0, energy_mj=1e9,
                         latency_ms=1e9)                             # :54
    rows = {}
    for arch in ref_list_archs():                                    # :61
        wl = ref_workload_for(ref_get_config(arch), shape)
        r = R.dxpta_search(wl, cons, engine="numpy")                 # :64
        rows[arch] = (r.feasible, cfg_tuple(r.best_cfg), r.energy_j,
                      r.latency_s)
    return rows


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_arch_sweep_equals_the_references_numpy_rows(engine, capsys):
    got, _ = run_port("arch_cosearch", ["--engine", engine], capsys)
    assert got["mode"] == "archs"
    assert nan_as_text(got["rows"]) == nan_as_text(ref_arch_rows())
    assert sum(f for f, *_ in got["rows"].values()) == 8


def test_arch_sweep_prints_the_references_lines(capsys, monkeypatch):
    _, text = run_port("arch_cosearch", [], capsys)
    want = run_reference("arch_cosearch", [], capsys, monkeypatch)
    assert masked(text) == masked(want)


@functools.lru_cache(maxsize=None)
def ref_scenario_rows(pareto):
    """`examples/arch_cosearch.py:72-101`'s library calls: one batched
    `search_workloads` per box of `SCENARIOS` (`:43-44`), numpy engine."""
    wls = {name: f() for name, f in REF_WORKLOADS.items()}           # :73
    rows = {}
    for area, power in example("arch_cosearch", torch_port=False).SCENARIOS:
        cons = R.Constraints(area_mm2=area, power_w=power)           # :79
        res = R.search_workloads(
            wls, cons, engine="numpy", hierarchical=True,
            objective="pareto" if pareto else "edp")                 # :81
        for name, r in res.items():
            if pareto:
                rows[(area, power, name)] = (
                    r.feasible, [tuple(int(v) for v in row)
                                 for row in r.front],
                    {k: v.tolist() for k, v in r.metrics.items()},
                    r.n_feasible)
            else:
                rows[(area, power, name)] = (r.feasible,
                                             cfg_tuple(r.best_cfg), r.edp,
                                             r.n_feasible)
    return rows


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
@pytest.mark.parametrize("pareto", [False, True], ids=["edp", "pareto"])
def test_scenario_sweep_equals_the_references_numpy(engine, pareto, capsys):
    argv = ["--scenarios", "--engine", engine] + (["--pareto"] if pareto
                                                  else [])
    got, text = run_port("arch_cosearch", argv, capsys)
    assert got["mode"] == ("pareto" if pareto else "edp")
    want = ref_scenario_rows(pareto)
    assert got["rows"] == want
    # the 25 mm^2 / 2.5 W box admits nothing; the paper's box all five
    assert not any(got["rows"][(25.0, 2.5, n)][0] for n in REF_WORKLOADS)
    assert all(got["rows"][(50.0, 5.0, n)][0] for n in REF_WORKLOADS)
    # plain versions on the CPU: no kernel launched, and the line says so
    assert got["launches"] == {box: {} for box in
                               example("arch_cosearch").SCENARIOS}
    assert text.count("(0 kernel launches, ") == 5


def test_scenario_sweep_prints_the_references_lines(capsys, monkeypatch):
    _, text = run_port("arch_cosearch", ["--scenarios"], capsys)
    want = run_reference("arch_cosearch", ["--scenarios"], capsys,
                         monkeypatch)
    assert masked(text) == masked(want)
    assert "one launch" in want and "one launch" not in text


def test_scenario_boxes_are_the_references():
    assert example("arch_cosearch").SCENARIOS == example(
        "arch_cosearch", torch_port=False).SCENARIOS


def test_pareto_without_scenarios_is_an_argparse_error(capsys):
    with pytest.raises(SystemExit) as e:
        example("arch_cosearch").main(["--pareto", "--device", "cpu"])
    assert e.value.code == 2
    assert "--pareto requires --scenarios" in capsys.readouterr().err


def test_engine_choices_are_the_ports():
    from repro_torch.core import ENGINES
    assert sorted(ENGINES) == ["cuda", "numpy", "python", "torch"]
    with pytest.raises(SystemExit):
        example("arch_cosearch").main(["--engine", "pallas"])


# -------------------------------------------------------- scenario_zoo ---

@functools.lru_cache(maxsize=None)
def ref_zoo():
    """`examples/scenario_zoo.py:34-57`'s library calls (reduced grid,
    n_z 6, numpy engine): the cold report and the repeat sweep."""
    grid = RefGrid.zoo(kinds=("train", "prefill", "decode"),
                       seq_lens=(2048,), batches=(8,), new_tokens=(16, 64),
                       reduce=True)                                  # :34
    boxes = {"train": R.Constraints(),
             "prefill": R.Constraints(latency_ms=8.0),
             "decode": R.Constraints(latency_ms=5.0)}                # :42
    svc = RefService(n_z=6, engine="numpy")                          # :46
    report = ref_sweep(grid, boxes, service=svc)                     # :48
    again = ref_sweep(grid, boxes, service=svc)                      # :54
    return report.format(), again.stats["memo_hits"], len(again.results)


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_scenario_zoo_report_equals_the_references(engine, capsys):
    got, text = run_port("scenario_zoo", ["--engine", engine], capsys)
    report, hits, n = ref_zoo()
    assert got["report"] == report
    assert (got["memo_hits"], got["n_scenarios"]) == (hits, n) == (40, 40)
    assert report in text and "40/40 memoized" in text


def test_scenario_zoo_prints_the_references_lines(capsys, monkeypatch):
    _, text = run_port("scenario_zoo", [], capsys)
    want = run_reference("scenario_zoo", [], capsys, monkeypatch)
    assert masked(text) == masked(want)


# ------------------------------------------------ isolation and device ---

def test_examples_import_neither_jax_nor_the_reference():
    code = ("import importlib.util, sys\n"
            f"for name in {EXAMPLES!r}:\n"
            "    path = f'examples/{name}_torch.py'\n"
            "    spec = importlib.util.spec_from_file_location(name, path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(repr(bad), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["[]", "True"]


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("arch_cosearch", []),
    ("arch_cosearch", ["--scenarios", "--engine", "cuda"]),
    ("scenario_zoo", []), ("serve_photonic", [])])
def test_examples_default_to_the_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main(argv)
