"""Each cell's harness rehearsed at a CPU size through the program's plain
paths: the run's last line has the contract's keys, the comparison passes,
and a planted fault in the timed path turns `correct` false."""
from __future__ import annotations

import json
import types

import pytest
import torch

from portbench import cells, run

CELLS = ("gut_mcmc_train", "gut_mcmc_video", "pg_hybrid_orbit")
SEED = 2**31 + 12345


def run_small(small_cell, capsys, workload, trace=0, seconds=1.0):
    manifest, w, cfg, traffic, limits = small_cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=SEED,
                                 seconds=seconds, trace=trace, step_log=None)
    rc = run.run_cell(cells, w, cfg, traffic, limits, manifest, args,
                      torch.device("cpu"), run.process_start_time())
    out = capsys.readouterr()
    assert rc == 0
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_runs_and_is_correct(small_cell, capsys, workload, trace):
    res, err = run_small(small_cell, capsys, workload, trace)
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["correct"], err
    assert res["attempted"] > 0 and res["failed"] == 0
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    names = run.metric_names(manifest, workload, bool(trace))
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["metrics"]) <= set(names)
        assert "breakdown" in res
    else:
        assert set(res["metrics"]) == set(names)
        assert "setup_s" in res["metrics"]
    # Each number compared is printed beside its limit as the last lines
    # of standard error.
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


def test_unchanged_state_is_caught(small_cell, capsys, monkeypatch):
    """A train step that returns its state unchanged (Adam a no-op)."""
    from threedgrut_torch import optimizers
    monkeypatch.setattr(optimizers, "step",
                        lambda params, grads, state, *a, **k: state)
    res, _ = run_small(small_cell, capsys, "gut_mcmc_train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > \
        res["checks"]["change_gap"]["limit"]


def test_half_batch_is_caught(small_cell, capsys, monkeypatch):
    """Half of the image left out of the loss, the mean over the rest."""
    from threedgrut_torch.model import losses
    full = losses.total_loss

    def half(pred, gt, *a, **k):
        h = pred.shape[0] // 2
        return full(pred[:h], gt[:h], *a, **k)

    monkeypatch.setattr(losses, "total_loss", half)
    res, _ = run_small(small_cell, capsys, "gut_mcmc_train")
    assert not res["correct"]


def test_altered_frame_is_caught(small_cell, capsys, monkeypatch):
    """A fly-through frame altered where it is produced: rendered at a
    turned pose."""
    from threedgrut_torch import api
    real = api.render

    def turned(params, cam, pose, res, **kw):
        T = kw["T_to_world"].clone()
        c, s = 0.9998477, 0.0174524          # one degree about z
        R = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        T[:3] = R @ T[:3]
        from threedgrut_torch.cameras import pose_from_matrix
        kw["T_to_world"] = T
        return real(params, cam, pose_from_matrix(T), res, **kw)

    monkeypatch.setattr(api, "render", turned)
    res, _ = run_small(small_cell, capsys, "gut_mcmc_video")
    assert not res["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(small_cell, workload):
    """The reference in bfloat16 in the program's place fails a limit."""
    from portbench import check, control
    _, w, cfg, traffic, limits = small_cell(workload)
    dev = torch.device("cpu")
    if traffic["kind"] == "train":
        got = control.train_readings(cells, check, cfg, traffic, SEED, dev)
        assert not check.judge(got["half"], limits)[0]
    elif traffic["kind"] == "video":
        got = control.frame_readings(cells, check, cfg, traffic, SEED, dev)
        assert not check.judge(got["shifted"], limits)[0]
    else:
        got = control.hybrid_readings(cells, check, cfg, traffic, SEED, dev)
        assert not check.judge(got["shifted"], limits)[0]
    assert not check.judge(got["control"], limits)[0]


def test_altered_hybrid_frame_is_caught(small_cell, capsys, monkeypatch):
    """A hybrid frame altered where it is produced: its radiance halved."""
    from threedgrut_torch.playground import engine
    real = engine.Engine.render_hybrid

    def dim(self, *a, **k):
        out = real(self, *a, **k)
        return dict(out, rgb=out["rgb"] * 0.5)

    monkeypatch.setattr(engine.Engine, "render_hybrid", dim)
    res, _ = run_small(small_cell, capsys, "pg_hybrid_orbit")
    assert not res["correct"]


@pytest.mark.cuda
def test_gut_train_cell_on_the_card(small_cell, capsys):
    """The shrunk training cell through the kernels on one card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    manifest, w, cfg, traffic, limits = small_cell("gut_mcmc_train")
    args = types.SimpleNamespace(workload=w["name"], seed=SEED, seconds=1.0,
                                 trace=1, step_log=None)
    rc = run.run_cell(cells, w, cfg, traffic, limits, manifest, args,
                      torch.device("cuda", 0), run.process_start_time())
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["device"]["busy_s"] > 0
