"""The harness: driven by data, its result line, its refusals, and what
its runs and its reference load."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness, tiny
from perfbench.harness import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def test_benchmark_json_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in cells.values():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        wl = json.loads((ROOT / "perfbench" / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        reports = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    for m in metrics:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_config_files_state_their_departures():
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and set(f["reduced"]) <= set(f["departures"])
        assert set(f["assumed"]) <= set(f) | set(f["departures"])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_prints_the_result_line(layout, cell, trace, capsys):
    result = tiny.run_cell(layout, cell, trace=trace)
    assert result["correct"] is True and result["attempted"] >= 1
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    want = {m["name"] for m in harness.cell_metrics(layout.benchmark(), cell, bool(trace))}
    got = set(result["metrics"])
    assert got <= want
    if not trace:
        assert {"setup_s"} < got     # peak memory needs the card
    harness.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    checks = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in checks)


def test_a_new_cell_and_metric_are_files_alone(layout, tmp_path):
    extra = tmp_path / "extra"
    (extra / "workloads").mkdir(parents=True)
    (extra / "metrics").mkdir()
    wl = layout.json("workloads", "tiny.serve")
    wl["traffic"]["prompt"] = 12
    (extra / "workloads" / "tiny.serve-short.json").write_text(json.dumps(wl))
    (extra / "metrics" / "serve.batches.py").write_text(textwrap.dedent('''
        def read(obs):
            return len(obs.records)
    '''))
    bench = layout.benchmark()
    bench["workloads"].append({"name": "tiny.serve-short", "config": "tiny-moe",
                               "traffic": "serve-short", "chips": 1, "why": "shorter"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.serve" in m["workloads"]:
            m["workloads"].append("tiny.serve-short")
    bench["per_layer"].append({"name": "serve.batches", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "runtime/serve_loop.py Server.throughput_batch",
                               "moves": "long_prompt_tokens_per_s",
                               "workloads": ["tiny.serve-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    more = harness.Layout(root=tmp_path, dirs=(extra,) + tuple(layout.dirs))
    assert "tiny.serve-short" in more.workloads()
    result = tiny.run_cell(more, "tiny.serve-short", trace=1)
    assert result["correct"]
    assert result["metrics"]["serve.batches"]["value"] == result["attempted"]


_RUN_TINY = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
from perfbench import harness, tiny
lay = tiny.write(Path({tmp!r}))
for cell in ("tiny.train", "tiny.serve"):
    for trace in (0, 1):
        assert tiny.run_cell(lay, cell, trace=trace)["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_RUN_REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import torch
from perfbench.reference import lm, serve, train
cfg = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
           vocab_size=64, mlp_type="swiglu", norm_type="layernorm", norm_eps=1e-6,
           rope_fraction=0.5, rope_theta=1e4)
from perfbench import weights
w = weights.make(cfg, 1, torch.float32, "cpu")
tok = torch.randint(64, (2, 9))
train.follow(w, [(tok[:, :-1], tok[:, 1:])], cfg, dict(peak_lr=1e-3, warmup_steps=10,
             total_steps=100, min_lr_ratio=0.1, b1=0.9, b2=0.95, eps=1e-8,
             weight_decay=0.1, grad_clip_norm=1.0), 1, lm.Precision())
serve.chosen_logits(w, cfg, tok[:, :4], tok[:, 4:], [0], None, lm.Precision("fp8"))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _loaded(script: str, tmp_path) -> set:
    code = script.format(src=str(ROOT / "src"), root=str(ROOT), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={k: v for k, v in ENV.items() if k != "PYTHONPATH"},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    loaded = _loaded(_RUN_TINY, tmp_path)
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    loaded = _loaded(_RUN_REFERENCE, tmp_path)
    assert "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN + ("repro_torch",))


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "repro_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in harness.forbidden_modules()


def test_main_prints_no_result_when_jax_was_loaded(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", lambda args, t_start=None: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", sys)
    with pytest.raises(SystemExit, match="jax"):
        harness.main(["--workload", "x", "--seed", "1", "--seconds", "1"])
    assert not capsys.readouterr().out


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload", "deepseek-moe-16b.chat",
           "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in ENV.items() if k != "PYTHONPATH"}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "perfbench", bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
