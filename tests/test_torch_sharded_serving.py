"""The port's server on a mesh (cli.serve --dp/--tp/--sp, serving.mesh) against
the port's unmeshed server and the JAX package's single-device server.

The pipeline is the tiny one of tests/test_torch_sharded_generation.py
(``UNet3DConfig.tiny()`` with cross_attention_dim 768, ``VAEConfig.tiny()``,
f32, F = 3 frames at 32x32, 2 DDIM steps), with random weights made with
numpy in the port's layout and carried to JAX by its own converters; a
small semantic MLP (hidden 16) gives rank 0 a front half. The servers run in
spawned gloo processes (``tests/_torch_dist_worker.py``, 120 s deadline):
``--tp 2`` on the plain stdin path and ``--dp 2 --coalesce`` over
``--listen`` at world 2, ``--dp 2 --tp 2`` and ``--dp 2 --sp 2`` with
``--coalesce`` at world 4; then, at world 2, an idle wait longer than the
groups' timeout, a SIGTERM drain with ``--warmup``, and a fault inside the
sharded forward. The unmeshed port server and JAX's server run meanwhile in
the pytest process on the same request lines. Tolerances: the arrays handed
to the GIF writer within 2e-5 of the unmeshed server's (float32 sums in
another order, as tests/test_torch_sharded_generation.py holds the sharded
pipeline); the GIFs within JAX's own bound of its server, a mean absolute
difference below 1.0 of 255 (tests/test_serve.py:438-446).
"""

import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import serve as jserve
from eeg2video_tpu.convert.unet_params import unet3d_params_from_torch_3d, vae_params_from_torch
from eeg2video_tpu.diffusion.pipeline import EEG2VideoPipeline as JPipeline
from eeg2video_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu_torch.cli import serve
from eeg2video_tpu_torch.data import video
from eeg2video_tpu_torch.data.video import load_gif
from eeg2video_tpu_torch.models.semantic import SemanticPredictor
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig

import _torch_dist_worker
from test_torch_models import capped_threads, random_state

_threads = capped_threads()

F = 3
SELF_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_GIF_BOUND = 1.0  # mean |a - b| of two GIFs' 0..255 frames, tests/test_serve.py:446
GROUP_TIMEOUT = 3.0  # seconds: the world's and the mesh's groups in the control spawn
IDLE = 6.0
SIZE = ["--height", "32", "--width", "32", "--video_length", str(F),
        "--num_inference_steps", "2", "--gif_encoder", "fast", "--unet", "u", "--vae", "v"]
COALESCE = ["--coalesce", "--max_batch", "2", "--coalesce_wait", "2"]
MESHES = {  # name -> (world, flags, over --listen)
    "tp2": (2, ["--tp", "2"], False),
    "dp2_listen": (2, ["--dp", "2", *COALESCE], True),
    "dp2tp2": (4, ["--dp", "2", "--tp", "2", *COALESCE], False),
    "dp2sp2": (4, ["--dp", "2", "--sp", "2", *COALESCE], False),
}
JAX_CLIPS = ["e/0.gif", "e/1.gif"]  # explicit latents: comparable with JAX's noise-free run


def _lines(tmp, out):
    d = tmp / out
    return [
        json.dumps({"cmd": "ping"}),
        json.dumps({"id": "e", "embeddings": str(tmp / "emb.npy"), "indices": [0, 1],
                    "latents": str(tmp / "lat.npy"), "out_dir": str(d / "e")}),
        # features through rank 0's semantic MLP, noise drawn on rank 0
        json.dumps({"id": "f", "features": str(tmp / "feats.npy"), "indices": [2],
                    "out_dir": str(d / "f")}),
        json.dumps({"id": "bad", "embeddings": str(tmp / "emb.npy"), "indices": [0],
                    "latents": str(tmp / "badlat.npy"), "out_dir": str(d / "bad")}),
        json.dumps({"id": "missing", "embeddings": str(tmp / "nope.npy")}),
        json.dumps({"cmd": "stats", "id": "s"}),
        json.dumps({"cmd": "shutdown"}),
    ]


def _base(tmp):
    return [*SIZE, "--device", "cpu", "--semantic_ckpt", str(tmp / "sem.pt"), "--hidden", "16"]


def _comparable(reply):
    """What two servers must agree on: ids, outcome, clip counts, GIF names,
    the stats counters."""
    keep = ("id", "ok", "clips", "bye", "ready", "requests", "errors")
    r = {k: v for k, v in reply.items() if k in keep}
    if "gifs" in reply:
        r["gifs"] = [os.path.basename(g) for g in reply["gifs"]]
    return r


def _run_stdin(monkeypatch, main, argv, lines):
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(line + "\n" for line in lines)))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    rc = main(argv)
    monkeypatch.undo()
    assert rc == 0
    return [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The files, the weights, and the spawned servers (started first, so
    that the pytest process's runs overlap them)."""
    tmp = tmp_path_factory.mktemp("sharded_serving")
    with torch.device("meta"):
        unet = random_state(UNet3DConditionModel(
            dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)), 30)
        vae = random_state(AutoencoderKL(VAEConfig.tiny()), 31)
    torch.manual_seed(32)
    torch.save(SemanticPredictor(hidden=16).state_dict(), tmp / "sem.pt")
    rng = np.random.default_rng(33)
    np.save(tmp / "emb.npy", rng.standard_normal((3, 77 * 768)).astype(np.float32))
    np.save(tmp / "feats.npy", rng.standard_normal((3, 310)).astype(np.float32))
    np.save(tmp / "lat.npy", rng.standard_normal((3, F, 4, 4, 4)).astype(np.float32))
    np.save(tmp / "badlat.npy", rng.standard_normal((3, F, 4, 8, 8)).astype(np.float32))
    base = _base(tmp)
    runs = {2: {}, 4: {}}
    for name, (world, flags, listen) in MESHES.items():
        runs[world][name] = {"argv": [*base, *flags], "lines": _lines(tmp, name),
                             "listen": listen}
    # a launcher's world without mesh flags: rank 0 serves on its own
    runs[2]["no_flags"] = {"argv": base, "lines": _lines(tmp, "no_flags")}
    request = json.dumps({"id": "e", "embeddings": str(tmp / "emb.npy"), "indices": [0, 1],
                          "latents": str(tmp / "lat.npy"), "out_dir": str(tmp / "ctl" / "e")})
    shutdown = json.dumps({"cmd": "shutdown"})
    control = {
        # the first line only after IDLE seconds, twice the groups' timeout
        "idle": {"argv": [*base, "--tp", "2"], "lines": [request, shutdown],
                 "pauses": {0: IDLE}, "mesh_timeout": GROUP_TIMEOUT},
        # warmup, then one request; SIGTERM to every rank at its second dispatch
        "drain": {"argv": [*base, "--dp", "2", *COALESCE, "--warmup"], "lines": [request],
                  "hold": True, "sigterm_at": 2, "mesh_timeout": GROUP_TIMEOUT},
    }
    fault = {"fault": {"argv": [*base, "--tp", "2"], "lines": [request, shutdown],
                       "fail_rank": 1}}
    inputs = {"unet": unet, "vae": vae}
    handles = {world: _torch_dist_worker.start("serving_cases", world,
                                               {**inputs, "runs": {world: r}}, tmp)
               for world, r in runs.items()}
    handles["control"] = _torch_dist_worker.start(
        "serving_cases", 2, {**inputs, "runs": {2: control}}, tmp / "control",
        timeout=_torch_dist_worker.datetime.timedelta(seconds=GROUP_TIMEOUT))
    handles["fault"] = _torch_dist_worker.start("serving_cases", 2,
                                                {**inputs, "runs": {2: fault}}, tmp / "fault")
    return tmp, inputs, handles


def _record(monkeypatch, module):
    seen = {}
    real = module.save_videos_grid

    def record(videos, path, **kw):
        seen[os.path.join(os.path.basename(os.path.dirname(path)), os.path.basename(path))] = \
            np.array(videos, np.float32)
        real(videos, path, **kw)

    monkeypatch.setattr(module, "save_videos_grid", record)
    return seen


@pytest.fixture(scope="module")
def references(started):
    """The unmeshed port server and JAX's single-device server on the same
    lines (plain stdin, one clip a dispatch)."""
    from eeg2video_tpu.data import video as jvideo

    tmp, inputs, _ = started
    mp = pytest.MonkeyPatch()
    try:
        seen = _record(mp, video)
        mp.setattr(serve, "load_pipeline",
                   lambda *a, **k: _torch_dist_worker._tiny_pipeline(inputs))
        port = _run_stdin(mp, serve.main, _base(tmp), _lines(tmp, "unmeshed"))
        port_seen = dict(seen)
        jcfg = dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=768)
        uparams = unet3d_params_from_torch_3d(inputs["unet"])["params"]
        vparams = vae_params_from_torch(inputs["vae"],
                                        enc_layers=VAEConfig.tiny().layers_per_block)["params"]
        jpipe = JPipeline.create(uparams, vparams, jcfg, JVAEConfig.tiny(), dtype=jnp.float32)
        _record(mp, jvideo)
        mp.setattr(jserve, "load_pipeline", lambda *a, **k: jpipe)
        jax_replies = _run_stdin(mp, jserve.main, SIZE, _lines(tmp, "jax"))
    finally:
        mp.undo()
    return port, port_seen, jax_replies


@pytest.fixture(scope="module")
def results(started, references):
    _, _, handles = started
    return {world: handles[world].join() for world in (2, 4)}


@pytest.mark.parametrize("name", list(MESHES))
def test_served_clips_on_a_mesh_match_the_unmeshed_server_and_jax(started, references,
                                                                 results, name):
    """Every reply of rank 0 is the unmeshed server's (the bad requests
    refused on rank 0 without a dispatch), every clip handed to the GIF
    writer is its clip within 2e-5, the GIFs of the explicit-latent clips are
    within JAX's bound of JAX's server, and the noise-latent clip of a
    features request (rank 0's semantic MLP and draw) matches too."""
    tmp, _, _ = started
    port, port_seen, _ = references
    world = MESHES[name][0]
    res = results[world][0][name]
    assert res["rc"] == 0
    replies = res["printed"]  # over --listen: the ready line with its port, then the replies
    assert [_comparable(r) for r in replies] == [_comparable(r) for r in port]
    by_id = {r["id"]: r for r in replies if "id" in r}
    assert by_id["e"]["ok"] and by_id["f"]["ok"] and not by_id["bad"]["ok"]
    assert by_id["s"]["requests"] == 4 and by_id["s"]["errors"] == 2
    assert sorted(res["seen"]) == sorted(port_seen) == ["e/0.gif", "e/1.gif", "f/2.gif"]
    for clip, want in port_seen.items():
        assert res["seen"][clip].shape == (1, F, 32, 32, 3)
        np.testing.assert_allclose(res["seen"][clip], want, err_msg=clip, **SELF_TOL)
    for clip in JAX_CLIPS:
        got = load_gif(str(tmp / name / clip)).astype(np.float32)
        want = load_gif(str(tmp / "jax" / clip)).astype(np.float32)
        assert got.shape == want.shape == (F, 32, 32, 3)
        assert np.abs(got - want).mean() < JAX_GIF_BOUND, clip


@pytest.mark.parametrize("name", list(MESHES))
def test_only_rank_0_prints_and_every_rank_runs_each_dispatch(results, name):
    """The followers print nothing and write no GIF, and run as many
    dispatches as rank 0 (3 clips: 3 dispatches of 1, or a dispatch of 2
    and one padded to 2 under --coalesce --max_batch 2)."""
    world = MESHES[name][0]
    ranks = [res[name] for res in results[world]]
    assert [r["rc"] for r in ranks] == [0] * world
    for r in ranks[1:]:
        assert r["printed"] == [] and r["seen"] == {}
    want = 3 if name == "tp2" else 2
    assert [r["calls"] for r in ranks] == [want] * world


def test_a_world_without_mesh_flags_is_served_by_rank_0_alone(references, results):
    """No --dp/--tp/--sp under a launcher's world of 2: as JAX serves on one
    device, rank 0 serves alone (the unmeshed server's replies and clips) and
    rank 1 returns 0 at once, without loading or printing anything."""
    port, port_seen, _ = references
    rank0, rank1 = (res["no_flags"] for res in results[2])
    assert rank0["rc"] == rank1["rc"] == 0
    assert [_comparable(r) for r in rank0["printed"]] == [_comparable(r) for r in port]
    for clip, want in port_seen.items():
        np.testing.assert_array_equal(rank0["seen"][clip], want, err_msg=clip)
    assert (rank1["printed"], rank1["seen"], rank1["calls"]) == ([], {}, 0)


def test_an_idle_server_outlives_its_groups_timeout_and_answers(started):
    """The first line arrives 6 s after start-up, twice the timeout of the
    world's group and of the mesh's groups: the follower's wait is on the
    control group, so it does not expire, and the request is answered."""
    _, _, handles = started
    control = handles["control"].join()
    rank0, rank1 = (res["idle"] for res in control)
    assert rank0["rc"] == rank1["rc"] == 0
    assert [r.get("ok") for r in rank0["printed"]] == [True, True, True]
    assert rank0["printed"][1]["clips"] == 2 and rank0["printed"][2] == {"ok": True, "bye": True}
    assert rank1["printed"] == [] and rank0["calls"] == rank1["calls"] == 2


def test_sigterm_drains_and_warmup_and_stop_reach_every_rank(started):
    """--warmup is a dispatch on every rank; SIGTERM to both ranks at their
    second dispatch: rank 0 drains (answers the queued request, then exits 0
    and stops the follower), the follower ignores the signal, finishes the
    dispatch and exits 0 on the stop."""
    _, _, handles = started
    control = handles["control"].join()
    rank0, rank1 = (res["drain"] for res in control)
    assert rank0["rc"] == rank1["rc"] == 0
    assert rank0["calls"] == rank1["calls"] == 2
    assert [r["ok"] for r in rank0["printed"]] == [True, True]  # ready line, the reply
    assert rank0["printed"][1]["clips"] == 2
    assert sorted(rank0["seen"]) == ["e/0.gif", "e/1.gif"] and rank1["printed"] == []


def test_a_fault_inside_the_sharded_forward_ends_every_rank(started):
    """Rank 1's UNet raises inside the tp forward: rank 1 ends with its error;
    rank 0's collective fails, it ends with a MeshFailure; neither hangs."""
    _, _, handles = started
    with pytest.raises(AssertionError) as err:
        handles["fault"].join()
    text = str(err.value)
    assert "exit codes [1, 1]" in text and "deadline" not in text
    assert "a fault inside the sharded forward" in text and "MeshFailure" in text


def test_mesh_flags_are_refused_as_jax_refuses_them(capsys, monkeypatch):
    """JAX's two parse-time refusals, before anything loads; a mesh larger
    than the world is refused by name and nothing carries on on one process."""
    monkeypatch.setattr(serve, "load_pipeline", lambda *a, **k: pytest.fail("loaded"))
    with pytest.raises(SystemExit):
        serve.main([*SIZE, "--device", "cpu", "--dp", "2", "--max_batch", "2"])
    assert "--dp needs --coalesce or --listen" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main([*SIZE, "--device", "cpu", "--dp", "2", "--coalesce", "--max_batch", "3"])
    assert "--max_batch 3 must be divisible by --dp 2" in capsys.readouterr().err
    with pytest.raises(ValueError, match=r"dp\*sp\*tp = 2 != 1 devices"):
        serve.main([*SIZE, "--device", "cpu", "--tp", "2"])
