"""Whole runs of every cell at a tiny size on the CPU (``run.py --device
cpu`` skips the look for a card): a sound run is correct; with the timed
path broken underneath, ``correct`` comes out false, once for each fault a
cell can have; and the control, the reference at the precision below the
configuration's, reads above the program on every cell."""

import json

import pytest
import torch

from perfbench import calibrate, run
from perfbench.tests.tiny import make_root

SERVE, TRAIN, TAV = "e2v-serve-feat-c4", "e2v-finetune-b10", "tav-finetune-24f512"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, capsys, seed=3000000019, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace",
                   str(trace), "--device", "cpu", "--root", root])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [SERVE, TRAIN, TAV])
def test_a_sound_run_is_correct(root, cell, capsys):
    line = _run(root, cell, capsys)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["setup_s"]["value"] > 0


def test_a_traced_run_reads_its_window(root, capsys):
    line = _run(root, TRAIN, capsys, trace=1)
    assert line["correct"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert "step_mfu.train" in line["metrics"]


def _unchanged_denoise(monkeypatch):
    from eeg2video_tpu_torch.diffusion import schedulers

    monkeypatch.setattr(schedulers.DPMSolverPPSchedule, "step",
                        lambda self, eps, i, sample, x0: (sample, x0))


def _altered_frames(monkeypatch):
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline

    call = EEG2VideoPipeline.__call__
    monkeypatch.setattr(EEG2VideoPipeline, "__call__",
                        lambda self, *a, **k: call(self, *a, **k).flip(-2))


def _altered_embeddings(monkeypatch):
    from eeg2video_tpu_torch.models.semantic import Int8SemanticPredictor

    call = Int8SemanticPredictor.__call__
    monkeypatch.setattr(Int8SemanticPredictor, "__call__",
                        lambda self, x: call(self, x) * 1.5)


def _unchanged_state(monkeypatch):
    from eeg2video_tpu_torch.train.videodiffusion import TrainState

    def apply_gradients(self):
        self.step += 1
        for n, w in self.working.items():
            w.grad = None

    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from eeg2video_tpu_torch.train import videodiffusion

    loss = videodiffusion.video_loss

    def half(unet, vae, pixels, context, cfg, **k):
        b = pixels.shape[0] // 2
        return loss(unet, vae, pixels[:b], context[:b], cfg, **k)

    monkeypatch.setattr(videodiffusion, "video_loss", half)


@pytest.mark.parametrize("cell, fault", [
    (SERVE, _unchanged_denoise), (SERVE, _altered_frames), (SERVE, _altered_embeddings),
    (TRAIN, _unchanged_state), (TRAIN, _half_batch), (TAV, _unchanged_state),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    line = _run(root, cell, capsys, seed=3000000023)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", [SERVE, TRAIN, TAV])
def test_the_control_reads_above_the_program(root, cell, capsys):
    calibrate.main(["--workload", cell, "--seconds", "1", "--seeds", "3000000029",
                    "--control", "fp8", "--control-seeds", "3000000029", "--device", "cpu",
                    "--root", root])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith('{"cell')]
    program, control = (next(x for x in lines if x["kind"] == k) for k in ("program", "fp8"))
    names = [k for k in program if k.endswith("_gap")]
    assert any(control[n] > 3 * program[n] for n in names), (program, control)
    limits = json.load(open(f"{root}/perfbench/workloads/{cell}.json"))["limits"]
    assert any(control[n] > limits[n] for n in names)
    torch.cuda.empty_cache()
