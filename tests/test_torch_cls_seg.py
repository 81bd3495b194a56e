"""Port parity: the PointNet++ classifier and segmenter of
``pwclonet_pylidarslam_torch`` and their trainer against the JAX reference
on the CPU, at tiny channel plans (those of ``tests/test_cls_seg.py``), on
the same numpy inputs and the same weights (``models/convert.py``).

- eval logits, and train-mode logits, loss, gradients and new running
  statistics;
- one optimizer step of the trainer against optax;
- the staircase schedules, the Flax tree of the full-width MSG classifier
  and SSG segmenter, and ``train_net_torch.py model=cls|semseg``.

The classifier's head normalises over the B rows of the batch. At B=2
every output of its BatchNorm is ±1 whatever its input, so the gradient
that reaches every stage below it is rounding noise in the reference
itself: its float32 gradient there differs from the one it gives for the
same inputs in float64 by 100 % of its size. The reference's ``PointMLP``
normalises in float32 whatever the input's type, so it cannot be held in
float64 either; the classifier is compared at B=8, where its own float32
gradients are well-conditioned (the segmenter's normalise over B·N rows:
B=2).

Dropout cannot draw the same masks in the two frameworks, so wherever both
sides run in train mode it is made the identity on both: the Flax ``apply``
runs under an interceptor that returns ``nn.Dropout``'s input, and the
port's rate is set to 0. Every reference computation is traced once, in a
module-scoped fixture."""

import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_net_torch
from pwclonet_pylidarslam_torch.data.shapes import SHAPE_CLASSES
from pwclonet_pylidarslam_torch.models import cls_seg as tcs
from pwclonet_pylidarslam_torch.models import load_flax_variables
from pwclonet_pylidarslam_torch.models.convert import flatten_variables, flax_variables
from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats
from pwclonet_pylidarslam_torch.train import cls_seg as ttrain
from pwclonet_pylidarslam_tpu.models import cls_seg as jcs
from pwclonet_pylidarslam_tpu.train import cls_seg as jtrain

TINY_CLS = (
    (32, (0.5, 1.0), (8, 16), ((16, 32), (16, 32))),
    (8, (1.0,), (8,), ((32, 64),)),
    (None, (None,), (None,), ((64, 128),)),
)
TINY_SEM = (
    (32, (0.5,), (8,), ((16, 32),)),
    (8, (1.0,), (8,), ((32, 64),)),
)
# (reference model, port model factory, points per cloud, input channels, labels shape)
MODELS = {
    "cls": (jcs.PointNet2Classification(num_classes=5, stages=tuple(jcs.SAStage(*s) for s in TINY_CLS),
                                        head=(32, 16)),
            lambda: tcs.PointNet2Classification(5, tuple(tcs.SAStage(*s) for s in TINY_CLS),
                                                head=(32, 16), device="cpu"),
            96, 3, (8,)),
    "seg": (jcs.PointNet2Segmentation(num_classes=4, stages=tuple(jcs.SAStage(*s) for s in TINY_SEM),
                                      fp_width=32, head_width=16),
            lambda: tcs.PointNet2Segmentation(4, tuple(tcs.SAStage(*s) for s in TINY_SEM),
                                              fp_width=32, head_width=16, in_channels=6,
                                              device="cpu"),
            96, 9, (2, 96)),
}
# float32, the same formulas in other reduction orders: logits and losses
# absolute + relative; running statistics as in tests/test_torch_train.py
ATOL, RTOL = 1e-5, 1e-4
STATS_TOL = dict(atol=1e-5, rtol=5e-6)
GRAD_RTOL = 1e-4  # of the largest gradient of the tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: with several test workers on one machine, torch's
    thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _f32(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _inputs(name):
    _, _, n, c, labels = MODELS[name]
    r = np.random.default_rng(3)
    points = r.uniform(-1.0, 1.0, size=(labels[0], n, c)).astype(np.float32)
    return points, r.integers(0, 4, size=labels).astype(np.int32)


def _split(points):
    return points[..., :3], (points[..., 3:] if points.shape[-1] > 3 else None)


@pytest.fixture(scope="module")
def reference():
    """Per model: float32 variables (running statistics moved off their
    initial values), the eval logits, the train-mode logits / loss / new
    statistics / gradients, and one reference train step
    (``train/cls_seg.py::cls_seg_train_step``) from the same state."""
    out = {}
    for name, (jmodel, _, _, _, _) in MODELS.items():
        points, labels = _inputs(name)
        xyz, feat = _split(points)
        variables = _f32(jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                     xyz, feat, train=False))
        rng = np.random.default_rng(9)
        stats = jax.tree.map(lambda v: (v + np.abs(rng.normal(size=v.shape)) * 0.3)
                             .astype(np.float32), variables["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": stats}
        res = {"variables": variables, "points": points, "labels": labels}
        res["eval"] = np.asarray(jax.jit(lambda v, x, f: jmodel.apply(v, x, f, train=False))(
            variables, xyz, feat))

        def loss_fn(params, x, f):
            logits, mutated = jmodel.apply({"params": params, "batch_stats": stats}, x, f,
                                           train=True, bn_momentum=0.5, mutable=["batch_stats"])
            loss, _ = jtrain._ce_and_accuracy(logits, jnp.asarray(labels))
            return loss, (logits, mutated["batch_stats"])

        with nn.intercept_methods(_no_dropout):
            (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(variables["params"], xyz, feat)
        res["train"] = {"loss": float(loss), "logits": np.asarray(logits),
                        "new_stats": flatten_variables({"batch_stats": new_stats}),
                        "grads": flatten_variables({"params": grads})}
        # one step of the reference trainer (its BatchNorm momentum at step 0
        # is 0.5, as above, so its gradients are the ones above)
        cfg = jtrain.ClsSegTrainConfig(batch_size=len(points),
                                       weight_decay=1e-2 if name == "seg" else 0.0)
        state = jtrain.ClsSegTrainState(variables["params"], stats,
                                        jtrain.make_optimizer(cfg).init(variables["params"]),
                                        jnp.zeros((), jnp.int32))
        with nn.intercept_methods(_no_dropout):
            new_state, log = jax.jit(lambda s, b, k: jtrain.cls_seg_train_step(
                jmodel, cfg, s, b, k))(state, {"points": points, "labels": labels},
                                       jax.random.key(0))
        res["step"] = {"config": cfg, "log": jax.tree.map(np.asarray, log),
                       "new": flatten_variables(jax.tree.map(np.asarray, {
                           "params": new_state.params, "batch_stats": new_state.batch_stats}))}
        out[name] = res
    return out


def _port(name, reference):
    model = load_flax_variables(MODELS[name][1](), reference[name]["variables"])
    model.dropout = 0.0
    return model


def _tensors(points):
    return _split(torch.from_numpy(np.array(points)))


def _flax_grad(ref_grads: dict, key: str) -> np.ndarray:
    """The reference's gradient of the torch parameter ``key``, in torch's layout."""
    *parents, leaf = key.split(".")
    if parents[-1] == "Dense_0" and leaf == "weight":
        return ref_grads["params/" + "/".join(parents) + "/kernel"].T
    return ref_grads["params/" + key.replace(".", "/")]


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_reference(reference, name):
    model = _port(name, reference)
    with torch.no_grad():
        logits = model(*_tensors(reference[name]["points"]), train=False)
    np.testing.assert_allclose(logits.numpy(), reference[name]["eval"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_forward_and_gradients_match_reference(reference, name):
    ref = reference[name]["train"]
    model = _port(name, reference)
    logits = model(*_tensors(reference[name]["points"]), train=True, bn_momentum=0.5)
    loss, _ = ttrain.ce_and_accuracy(logits, torch.from_numpy(reference[name]["labels"]))
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=ATOL, rtol=RTOL)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for key, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), _flax_grad(ref["grads"], key),
                                   atol=GRAD_RTOL * scale, rtol=0, err_msg=key)
    commit_batch_stats(model)
    buffers = dict(model.named_buffers())
    for path, new in ref["new_stats"].items():
        np.testing.assert_allclose(buffers[path[len("batch_stats/"):].replace("/", ".")].numpy(),
                                   new, err_msg=path, **STATS_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_one_optimizer_step_matches_optax(reference, name):
    """``cls_seg_train_step`` from the reference's state (Adam for the
    classifier, AdamW for the segmenter) against the reference's step:
    parameters, running statistics, and the step's learning rate and
    BatchNorm momentum.

    Adam's first update is ``-lr · g / (|g| + eps)`` (plus ``lr · wd · p``
    for AdamW): ±lr wherever |g| is well above eps, whatever its size. So it
    is held to 1e-4 of lr where the reference's gradient is larger than the
    gradients' tolerance above (its sign is then the port's), and to 2 lr,
    the width of the update, elsewhere; plus two float32 ulp of the
    parameter, to which the new value rounds (AdamW's decay, too, is applied
    in another order: torch scales the parameter first)."""
    ref = reference[name]["step"]
    jc = ref["config"]
    cfg = ttrain.ClsSegTrainConfig(batch_size=jc.batch_size, weight_decay=jc.weight_decay)
    model = _port(name, reference)
    before = flatten_variables(flax_variables(model))  # copies
    state = ttrain.create_cls_seg_state(model, cfg, seed=0)
    assert isinstance(state.optimizer, torch.optim.AdamW if cfg.weight_decay else torch.optim.Adam)
    log = ttrain.cls_seg_train_step(cfg, state, {"points": reference[name]["points"],
                                                 "labels": reference[name]["labels"]})
    assert state.step == 1
    np.testing.assert_allclose(log["loss"].item(), float(ref["log"]["loss"]), atol=ATOL, rtol=RTOL)
    assert log["lr"] == pytest.approx(float(ref["log"]["lr"]), rel=1e-12)
    assert log["bn_momentum"] == pytest.approx(float(ref["log"]["bn_momentum"]), rel=1e-12)
    got = flatten_variables(flax_variables(model))
    assert got.keys() == ref["new"].keys()
    grads = reference[name]["train"]["grads"]
    sure = GRAD_RTOL * max(np.abs(g).max() for g in grads.values())
    lr = log["lr"]
    for path, want in ref["new"].items():
        if path.startswith("batch_stats/"):
            np.testing.assert_allclose(got[path], want, err_msg=path, **STATS_TOL)
            continue
        du, dw = got[path] - before[path], want - before[path]
        # and the new parameter rounds to its float32 ulp on either side
        ulps = 2 * np.spacing(np.abs(before[path]).astype(np.float32))
        tol = np.where(np.abs(grads[path]) > sure, 1e-4 * lr, 2 * lr) + ulps
        bad = np.abs(du - dw) > tol
        assert not bad.any(), (path, du[bad], dw[bad], grads[path][bad], sure)
        assert np.abs(du).max() <= lr * (1 + 1e-3) + lr * cfg.weight_decay * np.abs(before[path]).max()


def test_eval_step_uses_running_statistics(reference):
    model = _port("seg", reference)
    state = ttrain.create_cls_seg_state(model, ttrain.ClsSegTrainConfig(batch_size=2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ev = ttrain.cls_seg_eval_step(state, {"points": reference["seg"]["points"],
                                          "labels": reference["seg"]["labels"]})
    logits = torch.from_numpy(np.array(reference["seg"]["eval"]))
    want, acc = ttrain.ce_and_accuracy(logits, torch.from_numpy(reference["seg"]["labels"]))
    np.testing.assert_allclose(float(ev["loss"]), float(want), atol=ATOL, rtol=RTOL)
    assert float(ev["accuracy"]) == float(acc)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("recipe", ["cls", "semseg"])
def test_staircase_schedules_match_reference(recipe):
    kw = dict(lr_decay=0.7, decay_step=2e4) if recipe == "cls" else dict(lr_decay=0.5,
                                                                         decay_step=3e5)
    ours, theirs = ttrain.ClsSegTrainConfig(**kw), jtrain.ClsSegTrainConfig(**kw)
    for examples in (0, 19_999, 20_000, 299_999, 300_000, 1_000_000, 10**9):
        assert ttrain.lr_at(ours, examples) == pytest.approx(
            float(jtrain.lr_at(theirs, examples)), rel=1e-12)
        assert ttrain.bn_momentum_at(ours, examples) == pytest.approx(
            float(jtrain.bn_momentum_at(theirs, examples)), rel=1e-12)
    assert ttrain.lr_at(ours, 10**9) == ttrain.LR_CLIP == jtrain.LR_CLIP
    assert ttrain.bn_momentum_at(ours, 10**9) == ttrain.BNM_CLIP == jtrain.BNM_CLIP


def test_dropout_draws_from_the_generator(reference):
    """Train-mode dropout: two calls from one generator state agree to the
    bit, another state gives other masks; eval mode has none."""
    model = _port("cls", reference)
    model.dropout = 0.5
    x = _tensors(reference["cls"]["points"])
    runs = [model(*x, train=True, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    commit_batch_stats(model)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("name,in_channels", [("cls", None), ("seg", 6)])
def test_full_width_flax_trees_load(name, in_channels):
    """The full-width CLS_MSG classifier and SEM_SSG segmenter: every leaf of
    the reference's variable tree (shapes from ``jax.eval_shape``, values
    random) lands in the port, and ``flax_variables`` gives the tree back."""
    if name == "cls":
        jmodel = jcs.PointNet2Classification(num_classes=40, stages=jcs.CLS_MSG)
        port = tcs.PointNet2Classification(40, tcs.CLS_MSG, device="cpu")
    else:
        jmodel = jcs.PointNet2Segmentation(num_classes=13)
        port = tcs.PointNet2Segmentation(13, in_channels=in_channels, device="cpu")
    c = 3 + (in_channels or 0)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                            jnp.zeros((1, 256, 3), jnp.float32),
                            None if in_channels is None else jnp.zeros((1, 256, c - 3),
                                                                       jnp.float32),
                            train=False))
    r = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: r.normal(size=s.shape).astype(np.float32), shapes)
    flat = flatten_variables(tree)
    load_flax_variables(port, tree)
    n_torch = len(list(port.parameters())) + len(list(port.buffers()))
    assert n_torch == len(flat)
    back = flatten_variables(flax_variables(port))
    assert back.keys() == flat.keys()
    for path, want in flat.items():
        np.testing.assert_array_equal(back[path], want, err_msg=path)


@pytest.mark.parametrize("model,points", [("cls", 64), ("semseg", 128)])
def test_train_net_torch_trains_cls_and_semseg(tmp_path, capsys, model, points):
    """One tiny epoch on procedural data on the CPU; the pickle holds the
    reference's layout (``train_net.py``) and loads into the port."""
    argv = ["do_train=true", f"model={model}", "dataset=synthetic", "device=cpu",
            f"num_points={points}", "batch_size=4" if model == "cls" else "batch_size=2",
            "synthetic_batches=2", "num_epochs=1", f"log_dir={tmp_path}"]
    assert train_net_torch.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("epoch 0: loss=") and "eval_acc=" in line
    loss = float(line.split("loss=")[1].split()[0])
    assert np.isfinite(loss)
    with open(tmp_path / "cls_seg_state.pkl", "rb") as f:
        tree = pickle.load(f)
    assert set(tree) == {"params", "batch_stats"}
    if model == "cls":
        port = tcs.PointNet2Classification(len(SHAPE_CLASSES), device="cpu")
        jmodel, c = jcs.PointNet2Classification(num_classes=len(SHAPE_CLASSES)), 3
    else:
        port = tcs.PointNet2Segmentation(4, in_channels=6, device="cpu")
        jmodel, c = jcs.PointNet2Segmentation(num_classes=4), 9
    load_flax_variables(port, tree)  # every leaf lands, nothing is left unset
    want = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, points, 3), jnp.float32),
        None if c == 3 else jnp.zeros((1, points, c - 3), jnp.float32), train=False))
    want = jax.tree.map(lambda x: np.broadcast_to(np.float32(0), x.shape), want)
    assert {k: v.shape for k, v in flatten_variables(tree).items()} == {
        k: v.shape for k, v in flatten_variables(want).items()}

