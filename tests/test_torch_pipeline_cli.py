"""The port's orchestration (eeg2video_tpu_torch) against the JAX package, on
the CPU: ``config.load_config``, ``cli.run_pipeline`` and the ``python -m
eeg2video_tpu_torch`` catalog.

Tolerances: ``load_config`` field by field, equal; the ``segment`` and
``de_psd`` stages are a gather and the same float64 numpy code on both sides
(tests/test_torch_preprocess_cli.py), so their files are bit-equal to those
of JAX's ``run_pipeline``.
"""

import argparse
import dataclasses
import importlib
import logging
import os
import pathlib

import numpy as np
import pytest

from eeg2video_tpu import config as jconfig
from eeg2video_tpu.cli import run_pipeline as jrun
from eeg2video_tpu_torch import config
from eeg2video_tpu_torch.__main__ import COMMANDS, main as catalog_main
from eeg2video_tpu_torch.cli import run_pipeline as run
from eeg2video_tpu_torch.convert.export_diffusion import WEIGHTS_NAME

from test_torch_models import capped_threads

_threads = capped_threads()

LOGGER = "eeg2video_tpu_torch.cli.run_pipeline"


# --- load_config --------------------------------------------------------------------

YAML = """
data:
  eeg_root: /data/EEG
  outputs: /out
generation:
  num_inference_steps: 50
  guidance_scale: 7.5
unet:
  block_out_channels: [32, 64]
  attention_heads: 4
train:
  learning_rate: 1.0e-4
  compute_dtype: float32
"""
OVERRIDES = ["generation.seed=7", "train.use_8bit_adam=true", "vae.layers_per_block=1",
             "data.flow_scores=/flow.npy", "unet.cross_attention_dim=16"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES])
def test_load_config_matches_jax_field_by_field(tmp_path, overrides):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    got, want = config.load_config(str(path), overrides), jconfig.load_config(str(path), overrides)
    for f in dataclasses.fields(want):
        part = lambda cfg: dataclasses.asdict(getattr(cfg, f.name))  # noqa: E731
        assert part(got) == part(want), f.name
    assert got.train.compute_dtype == "float32" and got.unet.block_out_channels == [32, 64]
    assert config.load_config() == config.Config()


@pytest.mark.parametrize("bad, name", [("train.not_a_field=1", "not_a_field"),
                                       ("nope.x=1", "nope")])
def test_load_config_refuses_an_unknown_field_by_name(bad, name):
    with pytest.raises(KeyError) as got:
        config.load_config(None, [bad])
    with pytest.raises(KeyError) as want:
        jconfig.load_config(None, [bad])
    assert str(got.value) == str(want.value) and f"'{name}'" in str(got.value)


# --- run_pipeline: the plan -----------------------------------------------------------

def _plans(tmp_path, device="cpu"):
    """The port's resolved stage table and JAX's for the same roots."""
    argv = ["--data_root", str(tmp_path / "d"), "--out_root", str(tmp_path / "o"),
            "--device", device]
    a = run.build_parser().parse_args(argv)
    ja = argparse.Namespace(data_root=a.data_root, out_root=a.out_root, sub=a.sub, vae=a.vae,
                            unet_torch=None, torch_clip=None, tokenizer=None,
                            semantic_epochs=a.semantic_epochs, seq2seq_epochs=a.seq2seq_epochs,
                            woSeq2Seq=False, woDANA=False)
    return run._stage_list(a), jrun._stage_list(ja)


def test_plan_is_jax_with_the_port_outputs_and_device(tmp_path):
    """Stage for stage the JAX plan, except: --device on every CLI that takes
    one; the .pt files the port writes where JAX writes orbax directories
    (semantic.pt, seq2seq.pt), and GLMNet's ckpt directory, which its CLI
    writes after the last epoch, where JAX declares the save_path itself; the
    fine-tune's declared diffusers weights."""
    port, jax_plan = _plans(tmp_path)
    o = str(tmp_path / "o")
    swap = {os.path.join(o, "semantic", "ckpt"): os.path.join(o, "semantic", "semantic.pt"),
            os.path.join(o, "seq2seq", "ckpt"): os.path.join(o, "seq2seq", "seq2seq.pt")}
    assert [(n, m) for n, m, _, _ in port] == [(n, m) for n, m, _, _ in jax_plan]
    for (name, mod, argv, outs), (_, _, jargv, jouts) in zip(port, jax_plan):
        jargv = [swap.get(v, v) for v in jargv]
        jouts = [swap.get(v, v) for v in jouts]
        if mod in ("extract_gif", "segment_sliding_window"):
            assert "--device" not in argv
        else:
            assert argv[-2:] == ["--device", "cpu"]
            argv = argv[:-2]
        if name == "glmnet":
            assert argv == jargv
            assert jouts == [os.path.join(o, "glmnet")]
            assert outs == [os.path.join(o, "glmnet", "ckpt")]
        elif name == "finetune":
            assert argv == jargv
            assert outs == jouts + [os.path.join(o, "tuneavideo", "unet", WEIGHTS_NAME)]
        else:
            assert (argv, outs) == (jargv, jouts), name


class _Parsed(Exception):
    pass


def test_every_stage_argv_parses_with_its_port_cli(tmp_path, monkeypatch):
    """Each stage's argv goes through the real parser of the port CLI it names
    (parse_args is stopped right after parsing, so nothing runs); every CLI
    with a --device flag gets 'cpu'."""
    port, _ = _plans(tmp_path)
    real = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    assert {n for n, _, _, _ in port} == set(run.DEFAULT_STAGES + run.OPTIONAL_STAGES)
    for name, mod, argv, _ in port:
        with pytest.raises(_Parsed) as parsed:
            importlib.import_module(f"eeg2video_tpu_torch.cli.{mod}").main(argv)
        ns = vars(parsed.value.args[0])
        assert ns.get("device", "cpu") == "cpu", (name, mod)
        assert ("device" in ns) == (mod not in ("extract_gif", "segment_sliding_window"))


def test_plan_outputs_are_what_the_consumers_read(tmp_path):
    """The declared outputs of the trainers are the files the next CLI reads:
    semantic.pt -> inference_semantic --ckpt, seq2seq.pt ->
    inference_seq2seq_v2 --ckpt, the fine-tune's directory -> generate --unet."""
    port, _ = _plans(tmp_path)
    by_mod = {m: (argv, outs) for _, m, argv, outs in port}
    flag = lambda argv, f: argv[argv.index(f) + 1]  # noqa: E731
    assert by_mod["train_semantic"][1] == [flag(by_mod["inference_semantic"][0], "--ckpt")]
    assert by_mod["train_seq2seq_v2"][1] == [flag(by_mod["inference_seq2seq_v2"][0], "--ckpt")]
    unet_dir = flag(by_mod["inference_eeg2video"][0], "--unet")
    assert by_mod["train_tuneavideo"][1] == [os.path.join(unet_dir, "ckpt"),
                                             os.path.join(unet_dir, "unet", WEIGHTS_NAME)]
    assert flag(by_mod["train_tuneavideo"][0], "--output_dir") == unet_dir


def test_unknown_stage_is_refused():
    with pytest.raises(SystemExit, match="unknown stages"):
        run.main(["--dry_run", "--stages", "nope"])


def test_a_run_without_a_card_raises_before_any_stage(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run.main(["--data_root", str(tmp_path), "--stages", "segment"])


def _logged(caplog, argv):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=LOGGER):
        run.main(["--dry_run"] + argv)
    return [line for line in caplog.text.splitlines() if "] " in line]


def test_extra_routes_by_stage_and_by_module(caplog):
    """'generate:--limit=4' reaches generate; 'semantic:--x' both of the
    composite stage's commands; 'train_semantic:--x' only the trainer."""
    lines = _logged(caplog, ["--stages", "generate", "semantic",
                             "--extra", "generate:--limit=4", "generate:--woSeq2Seq",
                             "semantic:--hidden=64", "train_semantic:--use_8bit_adam"])
    gen = [line for line in lines if "] generate:" in line]
    train = [line for line in lines if " train_semantic " in line]
    infer = [line for line in lines if " inference_semantic " in line]
    assert gen and "--limit 4" in gen[0] and "--woSeq2Seq" in gen[0]
    assert train and "--hidden 64" in train[0] and "--use_8bit_adam" in train[0]
    assert infer and "--hidden 64" in infer[0] and "--use_8bit_adam" not in infer[0]


def test_an_empty_output_dir_does_not_count(tmp_path, caplog):
    out = tmp_path / "o"
    os.makedirs(out / "generated")  # left empty by a failed generate
    argv = ["--data_root", str(tmp_path / "d"), "--out_root", str(out), "--stages", "generate"]
    assert any("[run] generate" in line for line in _logged(caplog, argv))
    (out / "generated" / "0.gif").write_bytes(b"GIF89a")
    assert any("[skip (outputs exist)] generate" in line for line in _logged(caplog, argv))


def test_segment_and_de_psd_run_on_the_cpu_like_jax_and_then_skip(tmp_path):
    """The two stages on a raw subject (7 blocks of 104,000 samples, 2
    channels) with --device cpu: the files JAX's run_pipeline writes from the
    same subject, bit for bit; a second call skips both, --force reruns."""
    raw = np.random.default_rng(0).standard_normal((7, 2, 104000)).astype(np.float32)
    files = {}
    for side, main in (("jax", jrun.main), ("port", run.main)):
        data = tmp_path / side
        os.makedirs(data / "EEG")
        np.save(data / "EEG" / "sub1.npy", raw)
        argv = ["--data_root", str(data), "--out_root", str(tmp_path / side / "out"),
                "--stages", "segment", "de_psd"] + (["--device", "cpu"] if side == "port" else [])
        assert [n for n, _ in main(argv)] == ["segment", "de_psd"]
        pre = data / "Preprocessing"
        files[side] = [np.load(pre / "Segmented_Rawf_200Hz_2s" / "sub1.npy"),
                       np.load(pre / "DE_1per2s" / "sub1.npy"),
                       np.load(pre / "PSD_1per2s" / "sub1.npy")]
    for got, want in zip(files["port"], files["jax"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert files["port"][0].shape == (7, 40, 5, 2, 400)
    assert files["port"][1].shape == (7, 40, 5, 2, 5)
    assert run.main(argv) == []
    assert len(run.main(argv + ["--force"])) == 2


# --- the catalog --------------------------------------------------------------------

def test_catalog_covers_every_cli_module():
    cli_dir = pathlib.Path(run.__file__).parent
    assert {c for c, _, _ in COMMANDS} == {p.stem for p in cli_dir.glob("*.py")} - {"__init__"}
    assert len(COMMANDS) == 20


def test_catalog_usage_and_unknown_command(capsys):
    assert catalog_main([]) == 0
    out = capsys.readouterr().out
    assert all(cmd in out for cmd, _, _ in COMMANDS)
    assert catalog_main(["not_a_command"]) == 2


def test_catalog_dispatches_to_the_port_cli():
    with pytest.raises(SystemExit) as e:
        catalog_main(["run_metrics", "--help"])
    assert e.value.code == 0


def test_catalog_dispatch_exits_0_after_a_stage_that_returns_its_results(tmp_path):
    """run_pipeline's main returns the stages it ran (a list), which is no
    exit status: the dispatcher returns 0 for it, as for None."""
    argv = ["--data_root", str(tmp_path / "d"), "--out_root", str(tmp_path / "o"),
            "--stages", "segment", "--dry_run", "--device", "cpu"]
    assert run.main(list(argv)) == []
    assert catalog_main(["run_pipeline", *argv]) == 0
