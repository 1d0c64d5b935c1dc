"""``python -m ray_tpu_torch.tools.multi_card_smoke`` on this box: its CPU
mode (``--platform cpu --tiny``: gloo groups of four CPU processes at
``LlamaConfig.tiny`` size) runs part (a) (the collectives in a spawned group
and in ``TorchTrainer(num_workers=4)`` workers), part (b) on the reference's
4-device mesh ``(seq=2, tensor=2)`` under ``tp_rules`` with ring attention and
on GPipe over ``stage=4`` (each held to the one-process step or layer loop
by the script's own bounds), part (c) (the trainer under ddp, tp and
fsdp, each against the one-process step on the same global batches) and
part (d) (IMPALA's own 4-learner gang and the DQN and PPO gang the script
builds, each against one learner update by update, and each gang's
teardown within one deadline) and part (e) (two replicas in f32 with one
SIGKILLed, two bf16 replicas under ``serve_traffic``, disaggregated pools
in f32 and bf16). On the
card it needs four cards and refuses to run on fewer: never on fewer ranks,
never on gloo.

Each run is one subprocess of the script (its processes at one OpenMP
thread); a test passes when the script exits 0 with its last line
``{"ok": true, ...}`` and every part's line reads ok.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, tmp_path, timeout=420):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.tools.multi_card_smoke", *args,
                           "--out", str(tmp_path / "out")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return proc, lines


def _parts(lines):
    return {line["part"]: line["ok"] for line in lines if line.get("phase") == "part"}


@pytest.mark.parametrize("parts", [
    ["--part", "a"],
    ["--part", "b", "--case", "seq2-tensor2-tp-ring", "--case", "stage4-gpipe"],
    ["--part", "c"],
    ["--part", "d"],
    ["--part", "e"],
], ids=["collectives", "reference-mesh-and-gpipe", "trainer", "learner-gangs", "serving"])
def test_cpu_mode_parts_pass(parts, tmp_path):
    proc, lines = _run(["--platform", "cpu", "--tiny", *parts], tmp_path)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert lines[-1] == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}}
    asked = [p for flag, p in zip(parts, parts[1:]) if flag == "--part"]
    assert _parts(lines) == {p: True for p in asked}
    if "b" in asked:
        cases = {line["case"]: line for line in lines if line.get("phase") == "b_mesh"
                 and "case" in line}
        assert sorted(cases) == ["seq2-tensor2-tp-ring", "stage4-gpipe"]
        ring = cases["seq2-tensor2-tp-ring"]["f32"]
        assert ring["ok"] and ring["loss_max_rel"] <= 2e-4 and ring["grad_max_rel_norm"] <= 1e-5
        assert cases["stage4-gpipe"]["f32"]["forward_equal"]
    if "a" in asked:
        gang = next(line for line in lines if line.get("path") == "TorchTrainer")
        assert [w["rank"] for w in gang["workers"]] == [0, 1, 2, 3]
        assert {w["backend"] for w in gang["workers"]} == {"gloo"}
    if "c" in asked:
        runs = {line["run"]: line for line in lines if line.get("phase") == "c_trainer"}
        assert sorted(runs) == ["ddp", "fsdp-7b", "tp", "tp-f32"]
        # tp over (data=2, tensor=2): the tensor pairs gather their rows, so
        # the step sees every rank's rows, as the one-process step does
        for name in ("tp", "tp-f32"):
            assert runs[name]["mesh"]["tensor"] == 2 and runs[name]["max_rel_diff"] <= 2e-4
        assert len(runs["fsdp-7b"]["losses"]) == 8
    if "d" in asked:
        algos = {line["algo"]: line for line in lines
                 if line.get("phase") == "d_learners" and "algo" in line}
        assert sorted(algos) == ["dqn", "impala", "ppo"]
        for line in algos.values():
            assert line["stats_max_rel_diff"] <= 1e-4
            assert line["params_max_abs_diff_over_lr"] <= 0.05
        # IMPALA's own gang, built by IMPALAConfig(num_learners=4), also trained
        impala = algos["impala"]
        assert [w["rank"] for w in impala["learners"]] == [0, 1, 2, 3]
        assert impala["train"]["num_env_steps_trained"] > 0
        # each gang reports its holds before it tears down, then its teardown
        teardowns = {line["gang"]: line["teardown_s"] for line in lines
                     if line.get("phase") == "d_learners" and line.get("part") == "teardown"}
        assert sorted(teardowns) == ["dqn-ppo", "impala"]
        assert all(t <= 35.0 for t in teardowns.values()), teardowns
    if "e" in asked:
        serving = {line["part"]: line for line in lines if line.get("phase") == "e_serve"}
        assert sorted(serving) == ["disaggregated_bf16", "disaggregated_f32",
                                   "two_replicas_7b", "two_replicas_f32"]
        f32 = serving["two_replicas_f32"]
        assert f32["streams_equal"] == [True] * 8
        # the streams cut by the SIGKILL resumed on the survivor, equal
        assert f32["resumed_streams_equal"] == [True] * 8 and f32["resumes"] >= 1
        assert f32["errors"] == []
        assert serving["disaggregated_f32"]["streams_equal"] == [True] * 8
        assert serving["two_replicas_7b"]["answered"] == serving["two_replicas_7b"]["requests"]
        for name in ("disaggregated_f32", "disaggregated_bf16"):
            assert serving[name]["fallbacks"] == 0
            assert serving[name]["transfers"] >= serving[name]["handoffs"]


def test_refuses_without_cards(tmp_path):
    """No card here: the script exits non-zero before any part, printing
    no result."""
    proc, lines = _run(["--part", "a"], tmp_path, timeout=120)
    assert proc.returncode != 0
    assert lines == []
    assert "no CUDA device" in proc.stderr


def test_refuses_fewer_than_four_cards(monkeypatch, capsys):
    """With two cards the script refuses, rather than run two ranks."""
    import torch

    from ray_tpu_torch.tools import multi_card_smoke as mc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mc, "bytecode_cache", lambda: None)
    assert mc.main(["--part", "b"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "2 cards, 4 needed" in out.err
