"""Hyperparameter search of the port (counterpart of the repository's
``sweep.py``): random, grid and TPE search over a sweep spec, each trial
composing the config with its parameters and running the port's
``train.run``; the best ``optimized_metric`` is reported.

    python -m newsreclib_tpu_torch.sweep hparams_search=nrms_random experiment=nrms_demo
    python -m newsreclib_tpu_torch.sweep hparams_search=demo_grid experiment=nrms_demo \\
        platform=cpu data.data_dir=/tmp/demo

Sweep specs are the JAX package's ``newsreclib_tpu/configs/hparams_search/
<name>.yaml`` (read with ``yaml_lite``):

    optimized_metric: val/auc
    mode: max                  # max | min
    n_trials: 20
    sampler: random            # random | grid | tpe
    seed: 0
    n_startup_trials: 5        # tpe: random trials before the Parzen fit
    output: outputs/sweep_results.json
    overrides: {trainer.max_epochs: 2}
    params:
      model.optimizer.lr: {low: 1e-5, high: 1e-3, log: true}
      model.dropout_probability: {choices: [0.1, 0.2, 0.3]}

The samplers make the JAX sweep's draws in its order from
``np.random.default_rng(seed)``: random trials all drawn up front, TPE
trials one at a time from the history so far.  A trial composes the spec's
``overrides``, then the command line, then its parameters (the later
wins), and trains in ``<output_dir>/trial_<t>``.  A trial that raises is
logged and recorded with ``value: None``, and the sweep goes on.  The
results (``metric``, ``mode``, ``best``, ``trials``) are written after
every trial.

Output paths: the JAX package's runs write under ``outputs/``, some of it
tracked (``outputs/sweep_results.json``, ``outputs/sweep_statfix_nrms/``),
so the port moves every relative path under ``outputs/`` that a spec names
(its ``output``, its ``overrides.output_dir``) and the default results
path to the same path under ``outputs/torch/`` (``port_output_path``), as
``train.py``'s default ``output_dir`` does.  Paths given on the command
line are kept as they are.

It runs on the card and raises without one; ``platform=cpu`` (or
``NEWSRECLIB_PLATFORM=cpu``) runs it on the CPU, as ``train.py``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from newsreclib_tpu_torch import train as train_mod
from newsreclib_tpu_torch.config import yaml_lite
from newsreclib_tpu_torch.config.compose import CONFIG_DIR, compose

log = logging.getLogger("newsreclib_tpu_torch")

SPEC_DIR = os.path.join(CONFIG_DIR, "hparams_search")
DEFAULT_OUTPUT = "outputs/sweep_results.json"


def sample_params(spec: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """One random draw of every parameter: a choice, a log-uniform or
    uniform float, or a uniform int (both bounds ints and no ``float``)."""
    out = {}
    for key, s in spec.items():
        if "choices" in s:
            out[key] = s["choices"][int(rng.integers(0, len(s["choices"])))]
        elif s.get("log"):
            out[key] = float(np.exp(rng.uniform(np.log(s["low"]), np.log(s["high"]))))
        elif isinstance(s.get("low"), int) and isinstance(s.get("high"), int) and not s.get("float"):
            out[key] = int(rng.integers(s["low"], s["high"] + 1))
        else:
            out[key] = float(rng.uniform(s["low"], s["high"]))
    return out


def tpe_sample(spec: Dict[str, Any], history: List[Dict[str, Any]], mode: str,
               rng: np.random.Generator, n_startup: int = 5, gamma: float = 0.25,
               n_candidates: int = 24) -> Dict[str, Any]:
    """A Tree-structured Parzen Estimator step over the completed trials of
    ``history`` (``value`` not None): ``sample_params`` until there are
    ``n_startup`` of them; then the trials are split at the gamma-quantile
    into a good and a bad set, a numeric parameter keeps, of
    ``n_candidates`` draws around the good set's points, the one of the
    largest good / bad Parzen log-density ratio (in log space where the
    spec says ``log``, clamped into the bounds, rounded for ints), and a
    choice is drawn by the ratio of its smoothed good and bad
    frequencies."""
    done = [h for h in history if h["value"] is not None]
    if len(done) < n_startup:
        return sample_params(spec, rng)
    vals = np.asarray([h["value"] for h in done], dtype=np.float64)
    order = np.argsort(vals)
    if mode == "max":
        order = order[::-1]
    n_good = max(1, int(np.ceil(gamma * len(done))))
    good = [done[i] for i in order[:n_good]]
    bad = [done[i] for i in order[n_good:]] or good

    def parzen_logpdf(x, pts, low, high):
        pts = np.asarray(pts, dtype=np.float64)
        sigma = max((high - low) / max(len(pts), 1), 1e-12)
        comp = -0.5 * ((x[:, None] - pts[None, :]) / sigma) ** 2 - np.log(sigma)
        m = comp.max(axis=1)
        return m + np.log(np.exp(comp - m[:, None]).mean(axis=1) + 1e-300)

    out: Dict[str, Any] = {}
    for key, s in spec.items():
        g_vals = [h["params"][key] for h in good]
        b_vals = [h["params"][key] for h in bad]
        if "choices" in s:
            choices = s["choices"]
            gc = np.asarray([1.0 + sum(v == c for v in g_vals) for c in choices])
            bc = np.asarray([1.0 + sum(v == c for v in b_vals) for c in choices])
            score = (gc / gc.sum()) / (bc / bc.sum())
            out[key] = choices[int(rng.choice(len(choices), p=score / score.sum()))]
            continue
        log_space = bool(s.get("log"))
        low, high = float(s["low"]), float(s["high"])
        tf = np.log if log_space else (lambda x: np.asarray(x, dtype=np.float64))
        lo, hi = float(tf(low)), float(tf(high))
        g_pts, b_pts = tf(g_vals), tf(b_vals)
        sigma = max((hi - lo) / max(len(g_pts), 1), 1e-12)
        cand = np.clip(g_pts[rng.integers(0, len(g_pts), size=n_candidates)]
                       + rng.normal(0, sigma, size=n_candidates), lo, hi)
        ei = parzen_logpdf(cand, g_pts, lo, hi) - parzen_logpdf(cand, b_pts, lo, hi)
        x = float(cand[int(np.argmax(ei))])
        x = float(np.exp(x)) if log_space else x
        x = min(max(x, low), high)  # exp(log(low)) can round just below low
        if isinstance(s.get("low"), int) and isinstance(s.get("high"), int) and not s.get("float"):
            x = int(round(x))
        out[key] = x
    return out


def grid_params(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every combination of the parameters' ``choices``, the last
    parameter varying fastest."""
    keys = list(spec)
    choice_lists = []
    for k in keys:
        s = spec[k]
        assert "choices" in s, f"grid sampler requires 'choices' for {k}"
        choice_lists.append(s["choices"])
    return [dict(zip(keys, combo)) for combo in itertools.product(*choice_lists)]


def port_output_path(path: str) -> str:
    """A relative path under ``outputs/`` -> the same path under
    ``outputs/torch/`` (module doc); any other path is kept."""
    parts = os.path.normpath(path).split(os.sep)
    if os.path.isabs(path) or parts[0] != "outputs" or parts[1:2] == ["torch"]:
        return path
    return os.path.join("outputs", "torch", *parts[1:])


def load_spec(name: str) -> Dict[str, Any]:
    """The sweep spec ``hparams_search/<name>.yaml``, its ``output`` (the
    default when it names none) and ``overrides.output_dir`` moved by
    ``port_output_path``."""
    spec = yaml_lite.load(os.path.join(SPEC_DIR, f"{name}.yaml"))
    spec["output"] = port_output_path(spec.get("output") or DEFAULT_OUTPUT)
    overrides = dict(spec.get("overrides") or {})
    if "output_dir" in overrides:
        overrides["output_dir"] = port_output_path(str(overrides["output_dir"]))
    spec["overrides"] = overrides
    return spec


def trial_config(spec: Dict[str, Any], cli: Sequence[str], params: Dict[str, Any],
                 t: int) -> Dict:
    """Trial ``t``'s config: the port's default output directory, the
    spec's overrides, the command line, then ``params``; trained in
    ``<output_dir>/trial_<t>``."""
    fixed = [f"{k}={v}" for k, v in spec["overrides"].items()]
    cfg = compose(CONFIG_DIR, "train", [*train_mod.DEFAULT_OVERRIDES, *fixed, *cli,
                                        *(f"{k}={v}" for k, v in params.items())])
    cfg["output_dir"] = os.path.join(cfg["output_dir"], f"trial_{t}")
    return cfg


def run_sweep(spec: Dict[str, Any], cli: Sequence[str]) -> Dict[str, Any]:
    """Run every trial of ``spec`` (``load_spec``) with the command-line
    overrides ``cli``; returns the results as written to
    ``spec["output"]``."""
    metric = spec["optimized_metric"]
    mode = spec.get("mode", "max")
    rng = np.random.default_rng(spec.get("seed", 0))
    sampler = spec.get("sampler", "random")
    n_trials = spec.get("n_trials", 10)
    if sampler == "grid":
        trials: List[Optional[Dict[str, Any]]] = list(grid_params(spec["params"]))
    elif sampler == "tpe":
        trials = [None] * n_trials  # sampled one at a time from the history
    else:
        trials = [sample_params(spec["params"], rng) for _ in range(n_trials)]

    results: List[Dict[str, Any]] = []
    best = None
    out: Dict[str, Any] = {}
    for t, params in enumerate(trials):
        if params is None:
            params = tpe_sample(spec["params"], results, mode, rng,
                                n_startup=spec.get("n_startup_trials", 5))
        t0 = time.time()
        try:
            value = train_mod.run(trial_config(spec, cli, params, t)).get(metric)
        except Exception:  # noqa: BLE001 -- a failed trial must not end the sweep
            log.exception("trial %d failed", t)
            value = None
        results.append({"trial": t, "params": params,
                        "value": None if value is None else float(value)})
        if value is not None and (best is None or (value > best["value"] if mode == "max"
                                                   else value < best["value"])):
            best = results[-1]
        log.info("trial %d: %s -> %s=%s (best=%s); %.1f s", t, params, metric, value,
                 best["value"] if best else None, time.time() - t0)
        # written after every trial, so an interrupted sweep keeps its history
        out = {"metric": metric, "mode": mode, "best": best, "trials": results}
        os.makedirs(os.path.dirname(spec["output"]) or ".", exist_ok=True)
        with open(spec["output"], "w") as f:
            json.dump(out, f, indent=2)
    log.info("sweep done: best %s; results in %s", best, spec["output"])
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    argv = sys.argv[1:] if argv is None else list(argv)
    name, cli = "default", []
    for ov in argv:
        if ov.startswith("hparams_search="):
            name = ov.split("=", 1)[1]
        else:
            cli.append(ov)
    return run_sweep(load_spec(name), cli)


if __name__ == "__main__":
    main()
