"""A whole run at the tiny size on the CPU: the result line's shape, the
refusal without a card, the faults that must come out as not correct,
and the files found by name."""
import ast
import json
import os
import shutil

import pytest
import torch

from portbench import run, spec
from portbench.tests.tiny import overrides

# above 2**32; at the tiny size seed 4294967311 leaves every box of a grid row
# under 5 points, and the post-processing asserts as the reference does (PERF.md)
SEED = "4294967313"


def tiny(workload, seconds="1", trace="0"):
    return run.execute(["--workload", workload, "--seed", SEED, "--seconds", seconds,
                        "--trace", trace], allow_cpu=True, overrides=overrides)


def test_the_result_line(monkeypatch, capsys):
    real = run.execute
    monkeypatch.setattr(run, "execute", lambda argv: real(argv, allow_cpu=True,
                                                         overrides=overrides))
    assert run.main(["--workload", "xyz-train-held", "--seed", SEED, "--seconds", "1",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    # the p95 of step intervals comes from CUDA events: none on the CPU
    assert set(line["metrics"]) == {"train_scenes_per_s", "peak_reserved_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"loss1_gap", "grad_gap", "change_gap"}
    assert err.strip().splitlines()[-1] == "correct True"
    assert err.strip().splitlines()[0].startswith("check loss1_gap ")


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "xyz-grid", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("workload", ["xyz-grid", "mv-train", "xyz-train-held"])
def test_every_cell_is_correct_at_the_tiny_size(workload):
    result = tiny(workload)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "cpu"


def stale_step(make):
    """A train step that returns the model's state unchanged."""
    def factory(*a, **k):
        inner = make(*a, **k)

        def step(model, batch, *rest, **kw):
            before = {n: t.detach().clone() for n, t in model.state_dict().items()}
            out = inner(model, batch, *rest, **kw)
            model.load_state_dict(before)
            return out
        step.program = inner.program
        return step
    return factory


def half_step(make):
    """A train step that takes the mean over the first half of the batch."""
    def factory(*a, **k):
        inner = make(*a, **k)

        def step(model, batch, *rest, **kw):
            return inner(model, {key: v[:len(v) // 2] for key, v in batch.items()}, *rest, **kw)
        step.program = inner.program
        return step
    return factory


def altered_eval(make, how):
    def factory(*a, **k):
        inner = make(*a, **k)

        def step(model, batch):
            out = dict(inner(model, batch))
            if how == "token":
                out["lang_cap"] = (out["lang_cap"].long() + 1).clamp_max(63).to(
                    out["lang_cap"].dtype)
            else:
                half = out["objectness_scores"].shape[0] // 2
                for key in ("objectness_scores", "sem_cls_scores", "bbox_lo", "bbox_hi"):
                    out[key] = torch.cat([out[key][:half], torch.zeros_like(out[key][half:])])
            return out
        step.program = inner.program
        return step
    return factory


@pytest.mark.parametrize("fault", ["stale", "half"])
def test_a_faulty_train_step_is_not_correct(monkeypatch, fault):
    import spacap3d_tpu_torch.train.solver as solver

    wrap = stale_step if fault == "stale" else half_step
    monkeypatch.setattr(solver, "make_train_step", wrap(solver.make_train_step))
    result = tiny("xyz-train-held")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["token", "half", "score"])
def test_a_faulty_grid_is_not_correct(monkeypatch, fault):
    import spacap3d_tpu_torch.eval.mul_eval as mul_eval
    import spacap3d_tpu_torch.train.step as step_module

    if fault == "score":
        score = mul_eval._score_seed
        monkeypatch.setattr(mul_eval, "_score_seed",
                            lambda args: dict(score(args), rouge=score(args)["rouge"] * 0.999))
    else:
        monkeypatch.setattr(step_module, "make_eval_step",
                            altered_eval(step_module.make_eval_step, fault))
    result = tiny("xyz-grid")
    assert not result["correct"], result["checks"]


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(spec, "HERE", str(root))
    cfg = json.loads((root / "configs" / "spacap-xyz.json").read_text())
    (root / "configs" / "spacap-new.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "xyz-grid.json").read_text())
    (root / "workloads" / "new-cell.json").write_text(json.dumps(dict(wl, config="spacap-new",
                                                                        traffic="newkind")))
    (root / "traffic" / "newkind.py").write_text("def run(ctx):\n    return 'ran'\n")
    (root / "metrics" / "new_metric.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nMOVES = "eval_scenes_per_s"\nKERNELS = ()\n\n\n'
        'def read(record):\n    return 42.0\n')
    assert "spacap-new" in spec.names("configs") and "new-cell" in spec.names("workloads")
    assert spec.config(spec.workload("new-cell")["config"])["name"] == "spacap-new"
    assert spec.traffic("newkind").run(None) == "ran"
    reader = next(r for r in spec.metric_readers() if r.NAME == "new_metric")
    assert reader.read({}) == 42.0
    assert run.per_layer({})["new_metric"] == {"value": 42.0, "unit": "%"}


FORBIDDEN = {"jax", "jaxlib", "flax", "spacap3d_tpu"}
NEVER_READ = ("bench.py", "chip_smoke", "BENCH_", "MULTICHIP_")


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for path in sources():
        if path.startswith(ref):
            tops = {m.split(".")[0] for m in imports_of(path)}
            assert "spacap3d_tpu_torch" not in tops, path


def test_no_module_reads_the_jax_benchmark_files():
    for path in sources():
        if os.path.basename(path) == "test_portbench_run.py":
            continue
        tree = ast.parse(open(path).read())
        strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                   and isinstance(n.value, str)]
        for s in strings:
            assert not any(w in s for w in NEVER_READ), (path, s[:80])


def test_a_run_loads_no_jax():
    tiny("xyz-train-held")
    assert run.forbidden_modules() == []


def test_each_variant_is_judged_against_the_limits():
    result = run.execute(["--workload", "xyz-train-held", "--seed", SEED, "--seconds", "1",
                          "--trace", "0"], allow_cpu=True, overrides=overrides,
                         variants={"stale": {"fault": "stale"}})
    readings = result["readings"]
    assert readings["program"]["correct"] is True is result["correct"]
    assert readings["stale"]["correct"] is False, readings["stale"]
    assert set(result["checks"]) <= set(readings["stale"]["numbers"])


def test_restore_puts_the_weights_and_adam_back_in_place():
    restore = spec.traffic("train_loop").restore
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    x = torch.randn(8, 3)

    def step():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
        return {k: v.clone() for k, v in model.state_dict().items()}

    def addresses():
        return ([t.data_ptr() for t in model.state_dict().values()]
                + [t.data_ptr() for st in opt.state.values() for t in st.values()
                   if torch.is_tensor(t)])

    first = step()
    before = addresses()
    step()
    restore(model, opt, state0)
    assert addresses() == before
    assert all(torch.equal(v, state0[k]) for k, v in model.state_dict().items())
    again = step()
    assert all(torch.equal(again[k], first[k]) for k in first)
