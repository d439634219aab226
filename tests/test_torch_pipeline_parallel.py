"""GPipe in the port (parallel.gpipe_apply) and the semantic trainer on a mesh
(train_semantic tp / pp, cli.train_semantic --pp) against the JAX package.

The port runs in spawned gloo processes (``tests/_torch_dist_worker.py``;
60 s group timeout, 120 s deadline): gpipe_apply at (pp, n_micro) = (2, 4),
(4, 8), (4, 1), JAX's cases (tests/test_pipeline_parallel.py:41-68), each
with the head replicated and column-split; the trainer at tp = 2 (world 2),
pp = 3 (world 3, and world 4 with one rank idle) on a narrow MLP (hidden
24, 2 epochs of 6 steps at batch 4), its out_dim 96 (divisible by pp: the
head is split) and 94 (not: the head is whole). JAX runs meanwhile in the
pytest process: its gpipe_apply and sequential stack, its UNSHARDED trainer
(f32 Adam), and its pp = 3 and tp = 2 trainers on its forced CPU devices
(8-bit Adam; tp = 2 on the first two of them, where JAX's ``make_mesh``
would take all eight). Tolerances: 1e-5 against the sequential stack (the
microbatches sum a weight's gradient in another order); rtol 1e-3 / atol
1e-4 for the trained model (whole models), losses included.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eeg2video_tpu.models.semantic import SemanticPredictor as JSemantic
from eeg2video_tpu.parallel import make_mesh as jmake_mesh
from eeg2video_tpu.parallel.pipeline import gpipe_apply as jgpipe_apply
from eeg2video_tpu.train import semantic as jsem
from eeg2video_tpu_torch.cli import train_semantic as train_cli
from eeg2video_tpu_torch.convert.from_jax import semantic_state_dict_from_jax
from eeg2video_tpu_torch.train import semantic as tsem

import _torch_dist_worker
from test_torch_models import capped_threads

_threads = capped_threads()

WIDTH = 32
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
N_MICRO = {2: [4], 4: [8, 1]}
HIDDEN, OUT_DIMS = 24, (96, 94)
CFG = dict(epochs=2, batch_size=4, lr=5e-4, hidden=HIDDEN)
# (tp, pp, n_micro, 8-bit, out_dim); n_micro 8 is clamped to the batch of 4
RUNS = {
    2: [(2, 1, 8, False, 96), (2, 1, 8, True, 96)],
    3: [(1, 3, 2, False, 96), (1, 3, 8, False, 94), (1, 3, 2, True, 96), (1, 3, 8, True, 94)],
    4: [(1, 3, 2, False, 96)],
}


def _jblock(p, a):
    return jax.nn.relu(a @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The port's gpipe_apply at world 2 and 4, and JAX's and the
    sequential stack's outputs and gradients."""
    tmp = tmp_path_factory.mktemp("gpipe")
    rng = np.random.default_rng(0)
    inputs = {"w": (rng.standard_normal((4, WIDTH, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32),
              "b": (0.1 * rng.standard_normal((4, WIDTH))).astype(np.float32),
              "x": rng.standard_normal((8, WIDTH)).astype(np.float32),
              "cot": rng.standard_normal((8, WIDTH)).astype(np.float32),
              "n_micro": N_MICRO}
    handles = {world: _torch_dist_worker.start("pipeline_cases", world, inputs, tmp)
               for world in N_MICRO}
    want = {}
    for pp in N_MICRO:
        params = {"w": jnp.asarray(inputs["w"][:pp]), "b": jnp.asarray(inputs["b"][:pp])}
        mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))

        def seq(p, x):
            for i in range(pp):
                x = _jblock(jax.tree.map(lambda a: a[i], p), x)
            return x

        def value_and_grads(f):
            out = f(params, inputs["x"])
            gp, gx = jax.grad(lambda p, x: jnp.sum(f(p, x) * inputs["cot"]),
                              argnums=(0, 1))(params, jnp.asarray(inputs["x"]))
            return [np.asarray(out), np.asarray(gx), np.asarray(gp["w"]), np.asarray(gp["b"])]

        want[pp, "seq"] = value_and_grads(seq)
        for nm in N_MICRO[pp]:
            want[pp, nm] = value_and_grads(
                lambda p, x, nm=nm, mesh=mesh: jgpipe_apply(_jblock, p, x, mesh, n_micro=nm))
    return {world: h.join() for world, h in handles.items()}, want


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 8), (4, 1)])
@pytest.mark.parametrize("split", [False, True], ids=["head_whole", "head_split"])
def test_gpipe_forward_and_gradients_match_the_sequential_stack(pipeline, pp, n_micro, split):
    """Every rank's output and x gradient are the whole ones, and each
    stage's parameter gradients are its layer's in the sequential stack (and
    in JAX's gpipe_apply): the output's cotangent is counted once whether the
    ranks consume it whole (head replicated) or by columns (head split)."""
    results, want = pipeline
    seq, jpipe = want[pp, "seq"], want[pp, n_micro]
    for rank, res in enumerate(results[pp]):
        out, gx, gw, gb = res[n_micro, split]
        for got, ref in ((out, seq[0]), (gx, seq[1]), (gw, seq[2][rank]), (gb, seq[3][rank])):
            np.testing.assert_allclose(got, ref, **GRAD_TOL)
        for got, ref in ((out, jpipe[0]), (gx, jpipe[1]), (gw, jpipe[2][rank]),
                         (gb, jpipe[3][rank])):
            np.testing.assert_allclose(got, ref, **GRAD_TOL)


def test_gpipe_without_autograd_and_an_indivisible_batch(pipeline):
    results, want = pipeline
    for pp, ranks in results.items():
        for res in ranks:
            np.testing.assert_allclose(res["no_grad"], want[pp, "seq"][0], **GRAD_TOL)
            assert res["batch_error"] == "batch 7 not divisible by n_micro=2"


# --- the semantic trainer ------------------------------------------------------

def _jinit(out_dim):
    return jax.device_get(JSemantic(hidden=HIDDEN, out_dim=out_dim).init(
        jax.random.key(0), jnp.zeros((1, 310)))["params"])


@pytest.fixture(scope="module")
def semantic(tmp_path_factory):
    """The port's runs at world 2, 3 and 4, and JAX's: unsharded with f32
    Adam, at pp = 3 and tp = 2 with 8-bit Adam."""
    tmp = tmp_path_factory.mktemp("semantic")
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((24, 310)).astype(np.float32)
    text = (0.5 * rng.standard_normal((24, max(OUT_DIMS)))).astype(np.float32)
    rng_cli = np.random.default_rng(4)
    np.save(tmp / "de.npy", rng_cli.standard_normal((7, 40, 5, 2, 62, 5)).astype(np.float32))
    np.save(tmp / "text.npy", (0.5 * rng_cli.standard_normal((1400, 12))).astype(np.float32))
    cli = ["--legacy", "--features", str(tmp / "de.npy"), "--text_embeddings",
           str(tmp / "text.npy"), "--save_path", str(tmp / "cli"), "--epochs", "1",
           "--hidden", str(HIDDEN), "--pp", "3", "--device", "cpu"]
    init = {d: {k: v.numpy() for k, v in semantic_state_dict_from_jax(_jinit(d)).items()}
            for d in OUT_DIMS}
    inputs = {"eeg": eeg, "text": text, "hidden": HIDDEN, "init": init, "cfg": CFG,
              "runs": RUNS, "cli": {3: cli}}
    handles = {world: _torch_dist_worker.start("semantic_cases", world, inputs, tmp)
               for world in RUNS}
    want = {}
    for tp, pp, n_micro, eight, out_dim in {k for runs in RUNS.values() for k in runs}:
        cfg = jsem.SemanticTrainConfig(**CFG, out_dim=out_dim, use_8bit_adam=eight)
        kw = dict(tp=tp, pp=pp, n_micro=n_micro) if eight else {}
        jsem_make_mesh = jsem.make_mesh
        jsem.make_mesh = lambda dp=1, tp=1: jmake_mesh(dp=dp, tp=tp,
                                                       devices=jax.devices()[:dp * tp])
        try:
            jvars, jlosses = jsem.train_semantic(eeg, text[:, :out_dim], cfg, seed=0, **kw)
        finally:
            jsem.make_mesh = jsem_make_mesh
        want[tp, pp, n_micro, eight, out_dim] = (
            jlosses, {k: v.numpy() for k, v in
                      semantic_state_dict_from_jax(jax.device_get(jvars)).items()})
    return {world: h.join() for world, h in handles.items()}, want, tmp, inputs


@pytest.mark.parametrize("world,key", [(w, k) for w, runs in RUNS.items() for k in runs],
                         ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple)
                         else f"world{v}")
def test_train_semantic_on_a_mesh_matches_jax(semantic, world, key):
    """Losses and the returned whole state dict, on every rank of the mesh,
    against JAX's unsharded trainer (f32 Adam) or its trainer on the same
    mesh (8-bit Adam); at world 4 the rank past the pp = 3 mesh idles."""
    results, want, _, _ = semantic
    jlosses, jsd = want[key]
    tp, pp, _, _, _ = key
    active = tp * pp
    for rank, res in enumerate(results[world]):
        losses, sd, _ = res[key]
        if rank >= active:
            assert (losses, sd) == ([], None)
            continue
        assert len(losses) == 2 and losses[1] < losses[0]
        np.testing.assert_allclose(losses, jlosses, **MODEL_TOL)
        assert sd.keys() == jsd.keys()
        for name, v in jsd.items():
            assert sd[name].shape == v.shape, name
            np.testing.assert_allclose(sd[name], v, err_msg=f"rank {rank} {name}", **MODEL_TOL)


@pytest.mark.parametrize("key", [k for w in (2, 3) for k in RUNS[w] if k[3]],
                         ids=lambda k: "-".join(map(str, k)))
def test_8bit_row_scales_of_a_split_leaf_are_the_whole_leaf_s(semantic, key):
    """m's row scales after the first 8-bit step, on each rank, against the
    unsharded trainer's (whose update is JAX's bit for bit on equal gradients,
    tests/test_torch_optim.py): a column-split leaf's maxima run across its
    ranks (``Adam8bit.row_groups``), a row-split leaf holds its columns'."""
    results, _, _, inputs = semantic
    tp, pp, _, _, out_dim = key
    model = _torch_dist_worker._semantic_model(inputs, out_dim)
    ref = {}

    def first_scales(step, loss, opt):
        if step == 1:
            ref.update({n: opt.state[p]["ms"].numpy().copy()
                        for n, p in model.named_parameters()})

    tsem.train_semantic(inputs["eeg"], inputs["text"][:, :out_dim],
                        tsem.SemanticTrainConfig(**CFG, out_dim=out_dim, use_8bit_adam=True),
                        seed=0, model=model, device="cpu", on_step=first_scales)
    for rank, res in enumerate(results[tp * pp]):
        scales = res[key][2]
        assert {"fc0.weight", "out.weight", "out.bias"} <= scales.keys()
        for name, got in scales.items():
            want = ref[name]
            if got.shape != want.shape:  # a row split: this rank's columns
                want = np.split(want, tp, axis=1)[rank]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"{rank} {name}")


def test_train_semantic_cli_pp_3_writes_from_rank_0_only(semantic):
    """cli.train_semantic --legacy --pp 3 (n_micro 8 by default, batch 32): every
    rank trains, rank 0 alone writes semantic.pt and scaler.npz, and the
    checkpoint is the whole standard state dict."""
    import torch

    results, _, tmp, _ = semantic
    assert [res["cli"] for res in results[3]] == [0, 0, 0]
    assert results[3][0]["written"] == [str(tmp / "cli" / "semantic.pt"),
                                        str(tmp / "cli" / "scaler.npz")]
    assert results[3][1]["written"] == results[3][2]["written"] == []
    sd = torch.load(tmp / "cli" / "semantic.pt")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "fc0.weight": (HIDDEN, 310), "fc0.bias": (HIDDEN,),
        **{f"fc{i}.{leaf}": (HIDDEN, HIDDEN)[:2 if leaf == "weight" else 1]
           for i in (1, 2, 3) for leaf in ("weight", "bias")},
        "out.weight": (12, HIDDEN), "out.bias": (12,)}


def test_n_micro_8_alone_runs_and_is_ignored_at_pp_1():
    """JAX's default n_micro (8) without pp: accepted and ignored, by the
    trainer and the CLI's parser."""
    rng = np.random.default_rng(5)
    eeg, text = rng.standard_normal((8, 310)).astype(np.float32), rng.standard_normal(
        (8, 6)).astype(np.float32)
    cfg = tsem.SemanticTrainConfig(epochs=1, batch_size=4, hidden=8, out_dim=6)
    sd8, losses8 = tsem.train_semantic(eeg, text, cfg, n_micro=8, device="cpu")
    sd1, losses1 = tsem.train_semantic(eeg, text, cfg, n_micro=1, device="cpu")
    assert losses8 == losses1
    assert all(np.array_equal(sd8[k].numpy(), sd1[k].numpy()) for k in sd1)
    args = train_cli.build_parser().parse_args(["--n_micro", "8"])
    assert (args.tp, args.pp, args.n_micro) == (1, 1, 8)
    assert train_cli.build_parser().parse_args([]).n_micro == 8


@pytest.mark.parametrize("n_micro,batch,want", [(8, 32, 8), (64, 32, 32), (5, 32, 4),
                                                (3, 4, 2), (7, 6, 6)])
def test_n_micro_is_clamped_as_jax_clamps_it(n_micro, batch, want):
    assert tsem.micro_batches(n_micro, batch) == want


@pytest.mark.parametrize("bad", [0, -1])
def test_n_micro_below_1_is_refused_with_jax_s_message(bad):
    with pytest.raises(ValueError, match=f"n_micro must be >= 1, got {bad}"):
        tsem.micro_batches(bad, 32)


def test_semantic_tp_rules_are_jax_s():
    """The port's rules against JAX's PartitionSpecs on the flax layout:
    JAX's column split P(None, "tp") is torch's dim 0, its row split dim 1,
    a bias follows its layer's output split."""
    from jax.sharding import PartitionSpec as P

    from eeg2video_tpu.models.semantic import semantic_sharding_rules

    class Key:
        def __init__(self, key):
            self.key = key

    for layer in ("fc0", "fc1", "fc2", "fc3", "fc4", "out"):
        for leaf, jleaf in (("weight", "kernel"), ("bias", "bias")):
            spec = semantic_sharding_rules((Key(layer), Key(jleaf)))
            ours = tsem.semantic_tp_rules(f"{layer}.{leaf}")
            if spec == P() or all(s is None for s in spec):
                assert ours is None, (layer, leaf)
            elif leaf == "bias":
                assert ours == (0, "tp"), (layer, leaf)
            else:  # flax (in, out) dim d is torch dim 1 - d
                assert ours == (1 - list(spec).index("tp"), "tp"), (layer, leaf)
