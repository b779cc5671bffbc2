"""The port's hyperparameter sweep (``newsreclib_tpu_torch/sweep.py``)
against the repository's ``sweep.py`` on the CPU.

* The samplers draw exactly what the JAX sweep's draw from the same
  ``default_rng`` seed: ``sample_params``, ``grid_params`` and
  ``tpe_sample`` over the four ``hparams_search`` specs and a spec with an
  int and a linear float range, over a set of seeds and random histories.
* Replaying the committed TPU sweep (``outputs/sweep_statfix_nrms/
  sweep_results.json``) through ``tpe_sample`` trial by trial reproduces
  every trial's parameters.
* ``yaml_lite`` reads each spec as ``yaml.safe_load`` does.
* The sweep loop with a stand-in for ``train.run`` writes the JAX sweep's
  results, a failing trial included, for every spec; the port's paths lie
  under ``outputs/torch/``.
* ``demo_grid`` over ``nrms_demo`` on the CPU: each trial's value is the
  port's ``train.run`` under the same overrides, and nothing is written
  outside ``outputs/torch/`` and the data copy.
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from newsreclib_tpu_torch import sweep as tsweep
from newsreclib_tpu_torch import train as ttrain
from newsreclib_tpu_torch.config import yaml_lite
from newsreclib_tpu_torch.config.compose import compose

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's sweep.py

import sweep as jsweep  # noqa: E402

SPEC_DIR = ROOT / "newsreclib_tpu" / "configs" / "hparams_search"
SPECS = sorted(p.stem for p in SPEC_DIR.glob("*.yaml"))
# the branches no spec file takes: an int range and a linear float range
SYNTHETIC = {
    "trainer.max_epochs": {"low": 1, "high": 9},
    "model.temperature": {"low": 0.05, "high": 1.0},
    "data.batch_size": {"low": 16, "high": 64, "float": True},
    "model.optimizer.lr": {"low": 1.0e-5, "high": 1.0e-3, "log": True},
    "model.dropout_probability": {"choices": [0.1, 0.2, 0.25, 0.3]},
}
SEEDS = [0, 1, 7, 42, 2024]
COMMITTED = ROOT / "outputs" / "sweep_statfix_nrms" / "sweep_results.json"


def params_of(name):
    return SYNTHETIC if name == "synthetic" else yaml.safe_load(
        (SPEC_DIR / f"{name}.yaml").read_text())["params"]


def test_there_are_four_specs():
    assert SPECS == ["demo_grid", "nrms_random", "nrms_statfix_tpe", "nrms_tpe"]


@pytest.mark.parametrize("name", SPECS)
def test_yaml_lite_reads_each_spec_as_safe_load(name):
    text = (SPEC_DIR / f"{name}.yaml").read_text()
    assert yaml_lite.loads(text) == yaml.safe_load(text)
    lows = [s["low"] for s in yaml_lite.loads(text)["params"].values() if "low" in s]
    assert all(type(v) is float for v in lows)  # 1.0e-5 is a float, not a string


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SPECS + ["synthetic"])
def test_sample_params_matches_jax(name, seed):
    spec = params_of(name)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(12):
        want = jsweep.sample_params(spec, jrng)
        got = tsweep.sample_params(spec, trng)
        assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("name", SPECS + ["synthetic"])
def test_grid_params_matches_jax(name):
    spec = params_of(name)
    if all("choices" in s for s in spec.values()):
        assert tsweep.grid_params(spec) == jsweep.grid_params(spec)
        assert len(tsweep.grid_params(spec)) == math.prod(len(s["choices"])
                                                          for s in spec.values())
        return
    with pytest.raises(AssertionError, match="requires 'choices'"):
        jsweep.grid_params(spec)
    with pytest.raises(AssertionError, match="requires 'choices'"):
        tsweep.grid_params(spec)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SPECS + ["synthetic"])
def test_tpe_sample_matches_jax(name, seed):
    """Histories grown trial by trial from the samplers' own draws, with
    values from a second numpy stream (a quarter of them failed trials),
    in both modes and at two startup counts."""
    spec = params_of(name)
    for mode, n_startup in (("max", 4), ("min", 2)):
        jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
        values = np.random.default_rng(seed + 1000)
        history = []
        for t in range(14):
            want = jsweep.tpe_sample(spec, history, mode, jrng, n_startup=n_startup)
            got = tsweep.tpe_sample(spec, history, mode, trng, n_startup=n_startup)
            assert got == want, (mode, t)
            assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
            value = None if values.uniform() < 0.25 else float(values.uniform(0.6, 0.7))
            history.append({"trial": t, "params": got, "value": value})
        assert trng.bit_generator.state == jrng.bit_generator.state


def test_tpe_replay_reproduces_the_committed_tpu_sweep():
    """The committed round-3 TPE sweep on statfix, replayed from seed 0
    with its own values: every trial's parameters, the four startup trials
    and the six adaptive ones, in both packages."""
    spec = yaml.safe_load((SPEC_DIR / "nrms_statfix_tpe.yaml").read_text())
    committed = json.loads(COMMITTED.read_text())["trials"]
    assert len(committed) == spec["n_trials"] == 10
    for sample in (jsweep.tpe_sample, tsweep.tpe_sample):
        rng = np.random.default_rng(spec["seed"])
        history = []
        for t, trial in enumerate(committed):
            params = sample(spec["params"], history, spec["mode"], rng,
                            n_startup=spec["n_startup_trials"])
            assert params == trial["params"], (sample.__module__, t)
            history.append(trial)


def test_spec_paths_map_under_outputs_torch():
    statfix = tsweep.load_spec("nrms_statfix_tpe")
    assert statfix["output"] == "outputs/torch/sweep_statfix_nrms/sweep_results.json"
    assert statfix["overrides"]["output_dir"] == "outputs/torch/sweep_statfix_nrms"
    assert statfix["overrides"]["trainer.max_epochs"] == 2
    for name in ("demo_grid", "nrms_random", "nrms_tpe"):
        assert tsweep.load_spec(name)["output"] == "outputs/torch/sweep_results.json"
    for kept in ("/abs/outputs/x.json", "outputs/torch/x.json", "runs/x.json", "x.json"):
        assert tsweep.port_output_path(kept) == kept
    assert tsweep.port_output_path("outputs/a/b.json") == "outputs/torch/a/b.json"
    # the JAX run's files that the port must not write
    tracked = {"outputs/sweep_results.json",
               "outputs/sweep_statfix_nrms/sweep_results.json"}
    assert all((ROOT / p).exists() for p in tracked)
    assert not {tsweep.load_spec(n)["output"] for n in SPECS} & tracked


def test_trial_config_precedence_matches_jax():
    """Spec overrides, then the command line, then the trial's parameters:
    the JAX sweep's config for the same trial, but for the output
    directory, which moves under outputs/torch/ unless the command line
    names one."""
    from newsreclib_tpu.config.compose import compose as jcompose

    spec = tsweep.load_spec("nrms_statfix_tpe")
    jspec = yaml.safe_load((SPEC_DIR / "nrms_statfix_tpe.yaml").read_text())
    params = {"model.optimizer.lr": 1.2076665792328143e-05, "model.dropout_probability": 0.2}
    for cli in (["experiment=nrms_statfix_celoss"],
                ["experiment=nrms_statfix_celoss", "trainer.max_epochs=3",
                 "model.dropout_probability=0.5", "output_dir=/x/run"]):
        got = tsweep.trial_config(spec, cli, params, 3)
        fixed = [f"{k}={v}" for k, v in jspec["overrides"].items()]
        want = jcompose(str(ROOT / "newsreclib_tpu" / "configs"), "train",
                        fixed + cli + [f"{k}={v}" for k, v in params.items()])
        want["output_dir"] = os.path.join(want["output_dir"], "trial_3")
        assert got.pop("output_dir") == ("/x/run/trial_3" if len(cli) > 1 else
                                         "outputs/torch/sweep_statfix_nrms/trial_3")
        assert want.pop("output_dir") == ("/x/run/trial_3" if len(cli) > 1 else
                                          "outputs/sweep_statfix_nrms/trial_3")
        assert got == want
        assert got["trainer"]["max_epochs"] == (3 if len(cli) > 1 else 2)
        assert got["model"]["dropout_probability"] == 0.2
        assert got["model"]["optimizer"]["lr"] == params["model.optimizer.lr"]


def fake_metrics(cfg):
    """A stand-in for ``train.run``: a value from the trial's parameters;
    the trial whose lr rounds to 0.003, and every fourth TPE trial, fail."""
    lr, p = cfg["model"]["optimizer"]["lr"], cfg["model"]["dropout_probability"]
    trial = int(cfg["output_dir"].rsplit("trial_", 1)[1])
    if round(lr, 6) == 0.003 or trial % 4 == 3:
        raise RuntimeError(f"planted failure of trial {trial}")
    value = 0.7 - 0.01 * abs(math.log(lr / 1e-4)) - 0.05 * abs(p - 0.2)
    return {"val/auc": value, "val/mrr": value / 2, "val/loss": 1 - value}


@pytest.mark.parametrize("name", SPECS)
def test_sweep_loop_writes_the_jax_results(name, tmp_path, monkeypatch, caplog):
    """Both sweeps' ``main`` with ``fake_metrics`` for training: the same
    results JSON (trials, parameters, values, failures as None, best),
    written after every trial; the port's under outputs/torch/, its trials'
    output directories too, and each failure logged with its exception."""
    monkeypatch.chdir(tmp_path)
    seen = {"jax": [], "port": []}

    def fake(which):
        def run(cfg):
            seen[which].append(cfg["output_dir"])
            return fake_metrics(cfg)
        return run

    monkeypatch.setattr(jsweep.train_mod, "run", fake("jax"))
    monkeypatch.setattr(tsweep.train_mod, "run", fake("port"))
    argv = [f"hparams_search={name}", "experiment=nrms_demo"]
    monkeypatch.setattr(sys, "argv", ["sweep.py", *argv])
    jsweep.main()
    with caplog.at_level("ERROR", logger="newsreclib_tpu_torch"):
        out = tsweep.main(argv)
    spec = yaml.safe_load((SPEC_DIR / f"{name}.yaml").read_text())
    jpath = spec.get("output", "outputs/sweep_results.json")
    want = json.loads((tmp_path / jpath).read_text())
    got = json.loads((tmp_path / tsweep.port_output_path(jpath)).read_text())
    assert got == want == json.loads(json.dumps(out))
    assert set(got) == {"metric", "mode", "best", "trials"}
    failed = [t["trial"] for t in got["trials"] if t["value"] is None]
    assert failed and got["best"]["value"] is not None
    assert len(seen["port"]) == len(seen["jax"]) == len(got["trials"])
    assert all(d.startswith("outputs/torch/") for d in seen["port"])
    assert [d.replace("outputs/torch/", "outputs/") for d in seen["port"]] == seen["jax"]
    logged = [r for r in caplog.records if r.name == "newsreclib_tpu_torch" and r.exc_info]
    assert [r.getMessage() for r in logged] == [f"trial {t} failed" for t in failed]
    assert all("planted failure" in str(r.exc_info[1]) for r in logged)
    assert sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")
                  if p.is_file()) == sorted([jpath, tsweep.port_output_path(jpath)])


def demo_copy(dst: Path) -> Path:
    from tests.test_torch_port_cli import demo_copy as copy

    return copy(dst)


def test_demo_grid_sweep_on_the_cpu(tmp_path, monkeypatch):
    """``demo_grid`` over ``nrms_demo`` at one epoch on the CPU: two
    trials, each value the port's ``train.run`` under the same overrides;
    the results JSON with the JAX sweep's keys under outputs/torch/, and
    no file written outside outputs/torch/ but the ETL's caches beside
    the data copy."""
    import torch

    torch.set_num_threads(2)
    data = demo_copy(tmp_path / "data")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    tracked = ROOT / "outputs" / "sweep_results.json"
    before = tracked.read_bytes()
    cli = ["experiment=nrms_demo", "platform=cpu", "trainer.max_epochs=1",
           f"data.data_dir={data}", f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
           "trainer.limit_train_batches=6"]
    out = tsweep.main(["hparams_search=demo_grid", *cli])
    results = json.loads((work / "outputs" / "torch" / "sweep_results.json").read_text())
    assert results == json.loads(json.dumps(out))
    assert set(results) == {"metric", "mode", "best", "trials"} and results["metric"] == "val/mrr"
    assert [t["params"] for t in results["trials"]] == [{"model.optimizer.lr": 0.001},
                                                        {"model.optimizer.lr": 0.003}]
    written = sorted(p.relative_to(work).as_posix() for p in work.rglob("*") if p.is_file())
    assert written and all(p.startswith("outputs/torch/") for p in written)
    for t, trial in enumerate(results["trials"]):
        run_dir = work / "outputs" / "torch" / "nrms_mind_demo" / f"trial_{t}"
        assert (run_dir / "metrics.csv").exists() and (run_dir / "checkpoints").is_dir()
        cfg = compose(overrides=[*ttrain.DEFAULT_OVERRIDES, *cli,
                                 f"model.optimizer.lr={trial['params']['model.optimizer.lr']}",
                                 f"output_dir={tmp_path / 'again' / str(t)}"])
        again = ttrain.run(cfg)
        assert trial["value"] == again["val/mrr"]
        assert math.isfinite(trial["value"])
    best = max(results["trials"], key=lambda t: t["value"])
    assert results["best"] == best
    assert tracked.read_bytes() == before
