"""The port's Tune on the port's own cluster, on the CPU: the 14 cases of
``tests/test_tune.py`` (the three it marks ``slow`` keep the mark), the
scheduling and search decisions held to the JAX package's on the same
inputs, a trial that leases the GPU, and a sweep of tiny-Llama trainer
trials held to the JAX package's training step.

The cluster is made once for the module, with one torch thread in each of
its processes. The CPU tests run without a card, so the head is given ``{"GPU": 1}``
and the daemon hands that id out as it would a real card's.

The tiny-Llama sweep: ``Tuner(TorchTrainer(llama_train_loop, ...))`` over
two learning rates, each trial a world-1 gloo gang under fsdp rules with
selective remat, starting from the JAX package's tiny f32 params (given to
the trainer as the checkpoint it resumes from) on the same batches. Each
trial's losses are held to the JAX package's ``make_train_step`` with
``optax.adamw`` at that rate within rtol 2e-4, the bound
``test_torch_train.py`` and ``test_torch_sharded_step.py`` hold the port's
steps to (the JAX package's own bound for a sharded step against the
unsharded one).
"""

import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4, resources={"GPU": 1})
        try:
            yield
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)


def test_libraries_load_neither_torch_nor_jax():
    """Tune, Jobs, the autoscaler, the CLI and the util shims import no
    torch, no jax and nothing of ``ray_tpu``."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, ray_tpu_torch.tune, ray_tpu_torch.job, ray_tpu_torch.autoscaler, "
            "ray_tpu_torch.scripts, ray_tpu_torch.util.queue, ray_tpu_torch.util.multiprocessing; "
            "print('torch' in sys.modules, 'jax' in sys.modules, 'ray_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


# -- test_tune.py --------------------------------------------------------------


def test_generate_variants_grid_product():
    from ray_tpu_torch.tune.search import generate_variants

    vs = generate_variants(
        {"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search(["x", "y"]), "c": 7}
    )
    assert len(vs) == 6
    assert all(v["c"] == 7 for v in vs)
    assert {(v["a"], v["b"]) for v in vs} == {(a, b) for a in (1, 2, 3) for b in ("x", "y")}


def test_generate_variants_samplers_and_num_samples():
    from ray_tpu_torch.tune.search import generate_variants

    vs = generate_variants(
        {"lr": tune.loguniform(1e-4, 1e-1), "bs": tune.choice([16, 32])},
        num_samples=8,
        seed=0,
    )
    assert len(vs) == 8
    assert all(1e-4 <= v["lr"] <= 1e-1 for v in vs)
    assert all(v["bs"] in (16, 32) for v in vs)
    vs2 = generate_variants({"opt": {"lr": tune.uniform(0, 1)}, "k": 3}, seed=1)
    assert 0 <= vs2[0]["opt"]["lr"] <= 1


def test_asha_scheduler_unit():
    asha = tune.ASHAScheduler(mode="max", max_t=64, grace_period=4, reduction_factor=2)
    assert asha.on_result("a", 4, 100.0) == CONTINUE
    assert asha.on_result("b", 4, 50.0) == STOP
    assert asha.on_result("c", 4, 150.0) == CONTINUE
    asha_min = tune.ASHAScheduler(mode="min", max_t=64, grace_period=4, reduction_factor=2)
    assert asha_min.on_result("a", 4, 1.0) == CONTINUE
    assert asha_min.on_result("b", 4, 5.0) == STOP


def _objective(config):
    lr = config["lr"]
    for step in range(1, 16):
        tune.report({"score": lr * step, "step": step})
        time.sleep(0.005)


def test_grid_search_e2e(cluster):
    grid = tune.Tuner(
        _objective,
        param_space={"lr": tune.grid_search([0.1, 1.0, 5.0, 10.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=4),
        resources_per_trial={"CPU": 0.5},
    ).fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    assert best.config["lr"] == 10.0
    assert best.metrics["score"] == 10.0 * 15
    assert all(r.status == "TERMINATED" for r in grid)


def test_asha_stops_underperformers_e2e(cluster):
    asha = tune.ASHAScheduler(mode="max", max_t=16, grace_period=2, reduction_factor=2)
    lrs = [16.0, 8.0, 4.0, 2.0, 1.0, 0.5, 0.2, 0.1]
    grid = tune.Tuner(
        _objective,
        param_space={"lr": tune.grid_search(lrs)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=asha, max_concurrent_trials=2
        ),
        resources_per_trial={"CPU": 0.5},
    ).fit()
    assert len(grid) == 8
    stopped = [r for r in grid if r.status == "STOPPED"]
    assert stopped, "ASHA must early-stop underperformers"
    assert grid.get_best_result().config["lr"] == 16.0
    assert next(r for r in grid if r.config["lr"] == 16.0).status == "TERMINATED"


def test_errored_trial_reported(cluster):
    def bad(config):
        if config["x"] == 1:
            raise ValueError("boom")
        tune.report({"ok": 1})

    grid = tune.Tuner(
        bad,
        param_space={"x": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
    ).fit()
    assert len(grid.errors) == 1
    assert "boom" in grid.errors[0].error
    assert grid.get_best_result().config["x"] == 0


def test_trainer_as_trainable(cluster, tmp_path):
    """TorchTrainer launched per trial: the variant config merges into the
    train loop config."""
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    def train_fn(config):
        rt_train.report({"loss": 1.0 / config["lr"]})

    trainer = TorchTrainer(
        train_fn,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        backend_config=TorchBackendConfig(distributed=False),
        run_config=RunConfig(name="tune-trial", storage_path=str(tmp_path)),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([1.0, 2.0, 4.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.config["lr"] == 4.0
    assert best.metrics["loss"] == 0.25


def test_pbt_exploits_and_mutates(cluster):
    def trainable(config):
        ck = tune.get_checkpoint()
        step = ck["step"] if ck else 0
        score = ck["score"] if ck else 0.0
        while step < 16:
            step += 1
            score += config["lr"]
            tune.report(
                {"score": score, "lr": config["lr"]},
                checkpoint={"step": step, "score": score},
            )
            time.sleep(0.1)

    scheduler = tune.PopulationBasedTraining(
        perturbation_interval=3,
        quantile_fraction=0.5,
        hyperparam_mutations={"lr": lambda: 1.0},
        seed=7,
    )
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.1, 1.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=scheduler, max_concurrent_trials=2,
        ),
    ).fit()
    assert len(grid) == 2
    exploited = any(len({m["lr"] for m in r.metrics_history if "lr" in m}) > 1 for r in grid)
    assert exploited, [[m.get("lr") for m in r.metrics_history] for r in grid]


def test_experiment_snapshot_and_resume(cluster, tmp_path):
    """Kill-and-resume: a snapshot taken mid-sweep restores finished
    results and restarts unfinished trials from their checkpoints."""
    import shutil

    import cloudpickle

    from ray_tpu_torch.train import RunConfig

    marker = tmp_path / "slow_mode"
    marker.write_text("on")

    def trainable(config):
        ck = tune.get_checkpoint()
        start = ck["i"] if ck else 0
        import os as _os

        for i in range(start, 6):
            tune.report({"i": i, "x": config["x"], "start": start}, checkpoint={"i": i + 1})
            # a barrier, not pacing: while the marker exists the first run
            # parks after each checkpointed report, so the mid-run snapshot
            # below cannot race trial progress
            waited = 0.0
            while _os.path.exists(str(config["marker"])) and waited < 20.0:
                time.sleep(0.1)
                waited += 0.1

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3, 4]), "marker": str(marker)},
        tune_config=tune.TuneConfig(metric="x", mode="max", max_concurrent_trials=2),
        run_config=RunConfig(name="resume_exp", storage_path=str(tmp_path)),
    )
    done = threading.Event()

    def doomed():
        try:
            tuner.fit()
        except BaseException:
            pass
        finally:
            done.set()

    threading.Thread(target=doomed, daemon=True).start()
    snap = tmp_path / "resume_exp" / "tuner.pkl"
    crash_dir = tmp_path / "crash_copy"
    crash_dir.mkdir()
    copied = crash_dir / "tuner.pkl"

    def _copy_is_resumable() -> bool:
        if not snap.exists():
            return False
        shutil.copy(snap, copied)
        try:
            with open(copied, "rb") as f:
                state = cloudpickle.load(f)
        except Exception:
            return False
        return any(
            tr.status in ("PENDING", "RUNNING") and tr.last_checkpoint is not None
            for tr in state.get("trials", [])
        )

    deadline = time.time() + 90
    captured = False
    while time.time() < deadline and not captured:
        captured = _copy_is_resumable()
        if not captured:
            time.sleep(0.1)
    assert captured, "no mid-run snapshot with a checkpointed trial appeared"

    marker.unlink()
    done.wait(timeout=120)

    grid = tune.Tuner.restore(str(crash_dir), trainable).fit()
    assert len(grid) == 4
    assert sorted(r.metrics["i"] for r in grid) == [5, 5, 5, 5]
    resumed_starts = [
        m["start"] for r in grid for m in r.metrics_history if m.get("start", 0) > 0
    ]
    assert resumed_starts, "no trial resumed from a checkpoint"


def _surrogate_objective(config):
    x, y = config["x"], config["y"]
    bonus = 0.5 if config["kind"] == "good" else 0.0
    tune.report(score=-((x - 0.3) ** 2) - ((y + 0.5) ** 2) + bonus)


@pytest.mark.slow
def test_tpe_beats_random_on_surrogate(cluster):
    space = {
        "x": tune.uniform(-2.0, 2.0),
        "y": tune.uniform(-2.0, 2.0),
        "kind": tune.choice(["bad", "good"]),
    }

    def best(search_alg):
        grid = tune.Tuner(
            _surrogate_objective,
            param_space=space,
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=36, max_concurrent_trials=2,
                search_alg=search_alg,
            ),
            resources_per_trial={"CPU": 0.5},
        ).fit()
        return grid.get_best_result().metrics["score"]

    tpe = best(tune.TPESearcher(n_startup_trials=10, seed=5))
    rnd = best(tune.RandomSearch(seed=5))
    assert tpe > rnd, (tpe, rnd)
    assert tpe > 0.35


@pytest.mark.slow
def test_concurrency_limiter_bounds_inflight(cluster):
    class Spy(tune.Searcher):
        def __init__(self):
            self.live = 0
            self.max_live = 0
            self._rng = random.Random(0)

        def suggest(self, trial_id):
            self.live += 1
            self.max_live = max(self.max_live, self.live)
            return {"x": self._rng.random()}

        def on_trial_complete(self, trial_id, result):
            self.live -= 1

    spy = Spy()

    def quick(config):
        tune.report(score=config["x"])

    tune.Tuner(
        quick,
        param_space={"x": tune.uniform(0, 1)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=8, max_concurrent_trials=4,
            search_alg=tune.ConcurrencyLimiter(spy, max_concurrent=2),
        ),
        resources_per_trial={"CPU": 0.5},
    ).fit()
    assert spy.max_live <= 2, spy.max_live


def test_median_stopping_rule_stops_bad_trials(cluster):
    def trainable(config):
        for i in range(12):
            # paced so the trials' results interleave at the controller
            time.sleep(0.15)
            tune.report(score=config["level"] + i * 0.01)

    grid = tune.Tuner(
        trainable,
        param_space={"level": tune.grid_search([0.0, 0.1, 1.0, 1.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.MedianStoppingRule(grace_period=4, min_samples_required=2),
            max_concurrent_trials=4,
        ),
        resources_per_trial={"CPU": 0.5},
    ).fit()
    by_level = {r.config["level"]: r for r in grid}
    assert by_level[1.1].status == "TERMINATED"
    stopped = [lvl for lvl, r in by_level.items() if r.status == "STOPPED"]
    assert 0.0 in stopped or 0.1 in stopped, {
        k: (v.status, len(v.metrics_history)) for k, v in by_level.items()
    }


@pytest.mark.slow
def test_logger_callbacks_write_files(cluster, tmp_path):
    import csv
    import glob
    import json

    from ray_tpu_torch import train

    def trainable(config):
        for i in range(3):
            tune.report(score=config["x"] * (i + 1), training_iteration=i + 1)

    callbacks = [tune.CSVLoggerCallback(), tune.JSONLoggerCallback()]
    try:
        callbacks.append(tune.TensorBoardLoggerCallback())
        has_tb = True
    except ImportError:
        has_tb = False
    tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        resources_per_trial={"CPU": 0.5},
        run_config=train.RunConfig(name="logtest", storage_path=str(tmp_path),
                                   callbacks=callbacks),
    ).fit()
    exp = tmp_path / "logtest"
    csvs = sorted(glob.glob(str(exp / "*" / "progress.csv")))
    assert len(csvs) == 2
    rows = list(csv.DictReader(open(csvs[0])))
    assert len(rows) == 3 and "score" in rows[0]
    jsons = sorted(glob.glob(str(exp / "*" / "result.json")))
    assert len(jsons) == 2
    assert len([json.loads(line) for line in open(jsons[0])]) == 3
    assert len(glob.glob(str(exp / "*" / "params.json"))) == 2
    if has_tb:
        assert glob.glob(str(exp / "*" / "events.out.tfevents.*")), "tensorboard events missing"


def test_optuna_adapter_gated():
    try:
        import optuna  # noqa: F401

        has_optuna = True
    except ImportError:
        has_optuna = False
    if has_optuna:
        assert tune.OptunaSearch(seed=0) is not None
    else:
        with pytest.raises(ImportError, match="TPESearcher"):
            tune.OptunaSearch(seed=0)


# -- decisions against the JAX package -------------------------------------------


def _variants(t):
    from importlib import import_module

    gen = import_module(t.__name__ + ".search").generate_variants
    space = {
        "lr": t.loguniform(1e-5, 1e-1), "bs": t.choice([16, 32, 64]),
        "layers": t.grid_search([2, 4]), "opt": {"wd": t.uniform(0.0, 0.1),
                                                  "warmup": t.qrandint(0, 100, 10)},
        "seed": t.randint(0, 1000), "fixed": "adamw",
    }
    return gen(space, num_samples=5, seed=11)


def _stream(n_trials, n_iters, seed):
    """A report stream (trial, iteration, value) with the trials' reports
    interleaved at random, as a controller polling several trials sees it."""
    rng = np.random.RandomState(seed)
    left = {f"t{i}": 1 for i in range(n_trials)}
    level = {t: rng.uniform(0, 1) for t in left}
    out = []
    while left:
        t = sorted(left)[rng.randint(len(left))]
        it = left[t]
        out.append((t, it, float(level[t] + 0.1 * it + rng.normal(0, 0.05))))
        left[t] = it + 1
        if it == n_iters:
            del left[t]
    return out


def _asha(t):
    out = []
    for mode in ("max", "min"):
        asha = t.ASHAScheduler(mode=mode, max_t=27, grace_period=1, reduction_factor=3)
        out.append([asha.on_result(*r) for r in _stream(9, 27, 3)])
    return out


def _median(t):
    out = []
    for mode in ("max", "min"):
        rule = t.MedianStoppingRule(mode=mode, grace_period=3, min_samples_required=2)
        out.append([rule.on_result(*r) for r in _stream(6, 12, 4)])
    return out


def _pbt(t):
    pbt = t.PopulationBasedTraining(
        mode="max", perturbation_interval=2, quantile_fraction=0.25, seed=7,
        hyperparam_mutations={"lr": [1e-3, 1e-2, 1e-1], "momentum": None, "batch": None},
    )
    out = []
    for trial, it, value in _stream(8, 10, 5):
        decision = pbt.on_result(trial, it, value)
        out.append(decision)
        if isinstance(decision, tuple):
            out.append(pbt.explore({"lr": 1e-2, "momentum": 0.9, "batch": 32}))
        if it == 10 and trial in ("t1", "t6"):
            pbt.on_trial_complete(trial)
    return out


def _tpe(t):
    tpe = t.TPESearcher(n_startup_trials=5, seed=5)
    tpe.set_search_properties("score", "max", {
        "x": t.uniform(-2.0, 2.0), "lr": t.loguniform(1e-4, 1e-1),
        "kind": t.choice(["a", "b", "c"]), "n": t.randint(1, 9),
    })
    out = []
    for i in range(16):
        config = tpe.suggest(f"trial_{i}")
        out.append(config)
        score = -(config["x"] - 0.3) ** 2 + (0.5 if config["kind"] == "b" else 0.0)
        tpe.on_trial_complete(f"trial_{i}", {"score": score})
    return out


@pytest.mark.parametrize("decide", [_variants, _asha, _median, _pbt, _tpe],
                         ids=["generate_variants", "asha", "median_stopping", "pbt", "tpe"])
def test_decisions_match_jax_package(decide):
    """The same space, seed and report stream give the same variants,
    stops, exploits, explored configs and suggestions in both packages."""
    from ray_tpu import tune as jax_tune

    assert decide(tune) == decide(jax_tune)


# -- a trial that leases the GPU -------------------------------------------------------


def _device_trial(config):
    tune.report({"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "pid": os.getpid(), "x": config["x"]})


def test_trial_leases_the_gpu(cluster):
    """``resources_per_trial={"CPU": 1, "GPU": 1}`` reaches the daemon as a
    GPU request: each trial's actor holds GPU id 0 (the only one), so each
    later trial got it back from the one before, and the GPU is free after
    the sweep."""
    grid = tune.Tuner(
        _device_trial,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="x", mode="max", max_concurrent_trials=1),
        resources_per_trial={"CPU": 1, "GPU": 1},
    ).fit()
    seen = [r.metrics for r in grid]
    assert [m["cuda_visible_devices"] for m in seen] == ["0", "0", "0"]
    assert len({m["pid"] for m in seen}) == 3  # one actor a trial
    assert all(r.status == "TERMINATED" for r in grid)
    deadline = time.monotonic() + 10
    while rt.available_resources().get("GPU") != 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources().get("GPU") == 1


# -- the slice: a sweep of tiny-Llama trainer trials against the JAX step ----------


def test_llama_trainer_sweep_matches_jax_step(cluster, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jl
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.tools.train_llama import llama_train_loop
    from ray_tpu_torch.train import (
        Checkpoint, RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer)

    steps, local, seq, lrs = 3, 2, 16, (1e-3, 3e-3)
    rows = np.random.RandomState(7).randint(0, 256, size=(steps * local, seq + 1))
    jcfg = jl.LlamaConfig.tiny()
    jparams = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    start = Checkpoint.from_dict({
        "state": {"params": {k.replace(".", "/"): v
                             for k, v in tl.params_from_jax(jparams).items()},
                  "optimizer": {}},
        "step": 0, "losses": []})
    trainer = TorchTrainer(
        llama_train_loop,
        train_loop_config={"model": {"preset": "tiny"}, "seed": 0, "remat": "selective",
                           "batch_size": local},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        backend_config=TorchBackendConfig(platform="cpu", mesh_spec=MeshSpec(fsdp=-1),
                                          sharding="fsdp"),
        run_config=RunConfig(name="llama-sweep", storage_path=str(tmp_path)),
        datasets={"train": rd.from_numpy(rows, block_size=local)},
        resume_from_checkpoint=start,
    )
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search(list(lrs))},
        tune_config=tune.TuneConfig(metric="final_loss", mode="min", max_concurrent_trials=2),
    ).fit()
    assert all(r.status == "TERMINATED" for r in grid), [r.error for r in grid]

    jstep_losses = {}
    for lr in lrs:
        jstep = jl.make_train_step(jcfg, optax.adamw(lr), donate=False)
        state = jax.tree_util.tree_map(jnp.asarray, jparams)
        state = (state, optax.adamw(lr).init(state))
        losses = []
        for i in range(steps):
            batch = rows[local * i: local * (i + 1)]
            state, loss = jstep(state, {"tokens": jnp.asarray(batch[:, :-1], jnp.int32),
                                        "targets": jnp.asarray(batch[:, 1:], jnp.int32)})
            losses.append(float(loss))
        jstep_losses[lr] = losses
    for r in grid:
        m = r.metrics
        assert m["backend"] == "gloo" and m["world_size"] == 1 and m["steps_run"] == steps
        np.testing.assert_allclose(m["losses"], jstep_losses[r.config["lr"]], rtol=2e-4)
    best = grid.get_best_result()
    assert best.metrics["final_loss"] == min(r.metrics["final_loss"] for r in grid)
    assert best.config["lr"] == min(lrs, key=lambda lr: jstep_losses[lr][-1])
