"""Port parity: training of PWCLO-Net in ``pwclonet_pylidarslam_torch``
against the Flax/optax reference, at a small config on the CPU: train-mode
BatchNorm, the loss, the schedules, one forward + backward of the whole
network, one optimizer step, ``estimate_batch_stats``, and the port's own
guarantees (NaN guard, dropout, K-step blocks, the train-state converter).

Dropout cannot draw the same masks in the two frameworks, so wherever both
sides run in train mode it is made the identity on both: the Flax ``apply``
runs under an interceptor that returns ``nn.Dropout``'s input, and the
port's rate is set to 0."""

import copy
import importlib.util
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.models import PWCLONetConfig, load_flax_train_state
from pwclonet_pylidarslam_torch.models import load_flax_variables
from pwclonet_pylidarslam_torch.models.convert import _trainable_key, flatten_variables
from pwclonet_pylidarslam_torch.models.layers import PointMLP, commit_batch_stats
from pwclonet_pylidarslam_torch.models.pwclonet import PoseCalculator
from pwclonet_pylidarslam_torch.train import losses as tlosses
from pwclonet_pylidarslam_torch.train import state as tstate
from pwclonet_pylidarslam_tpu.models import PWCLONetConfig as JPWCLONetConfig
from pwclonet_pylidarslam_tpu.models.layers import PointMLP as JPointMLP
from pwclonet_pylidarslam_tpu.train import losses as jlosses
from pwclonet_pylidarslam_tpu.train import state as jstate

_spec = importlib.util.spec_from_file_location(
    "export_flax_checkpoint",
    Path(__file__).resolve().parents[1] / "tools" / "export_flax_checkpoint.py")
export_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(export_tool)

SMALL = dict(num_points=128, sa_npoints=(32, 16, 8, 4), sa_nsamples=(8, 8, 4, 4))
J_CFG = jstate.TrainConfig(model=JPWCLONetConfig(**SMALL), total_steps=50)
T_CFG = tstate.TrainConfig(model=PWCLONetConfig(**SMALL), total_steps=50)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _batches(k, b=2, n=128, seed=0):
    """``k`` batches of random clouds and their slightly moved copies."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x1 = (r.normal(size=(b, n, 3)) * 8).astype(np.float32)
        yaw = r.normal(size=b) * 0.03
        rot = np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                        for a in yaw]).astype(np.float32)
        t = (r.normal(size=(b, 1, 3)) * 0.2).astype(np.float32)
        x2 = (np.einsum("bij,bnj->bni", rot, x1) + t).astype(np.float32)
        q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
        gt = np.concatenate([t[:, 0], q], -1).astype(np.float32)
        out.append({"xyz1": x1, "xyz2": x2, "gt_params": gt})
    return out


def _port_state(tree):
    """The port's train state on the CPU holding the reference's ``tree``,
    dropout off."""
    state = load_flax_train_state(tstate.create_train_state(T_CFG, seed=0, device="cpu"), tree)
    for m in state.model.modules():
        if isinstance(m, PoseCalculator):
            m.dropout_rate = 0.0
    return state


@pytest.fixture(scope="module")
def reference():
    """The reference's seed-0 train state, one batch, and what one of its
    train steps (dropout the identity) makes of them: loss, gradients, new
    batch statistics and the whole new state."""
    model, state = jstate.create_train_state(J_CFG, jax.random.key(0))
    state = _f32(state)
    batch = _batches(1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        (pred, _aux), mutated = model.apply(
            {"params": trainable["net"], "batch_stats": state.batch_stats},
            jbatch["xyz1"], jbatch["xyz2"], train=True, bn_momentum=0.5,
            rngs={"dropout": jax.random.key(1)}, mutable=["batch_stats"])
        loss, _ = jlosses.pwclonet_loss(trainable["loss"], pred, jbatch["gt_params"], J_CFG.loss)
        return loss, mutated["batch_stats"]

    with nn.intercept_methods(_no_dropout):
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            {"net": state.params, "loss": state.loss_params})
        new_state, log = jax.jit(
            lambda s, b, r: jstate.train_step(model, J_CFG, s, b, r))(
                state, jbatch, jax.random.key(1))
    return {
        "model": model, "state": state, "tree": export_tool.train_state_to_tree(state),
        "batch": batch, "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
        "new_stats": jax.tree.map(np.asarray, new_stats), "log": jax.tree.map(np.asarray, log),
        "new_tree": export_tool.train_state_to_tree(new_state),
    }


# ---- train-mode BatchNorm ----------------------------------------------------


@pytest.mark.parametrize("momentum", [0.5, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_mlp_train_mode(rng, dtype, momentum):
    x = rng.normal(size=(2, 12, 8, 11)).astype(np.float32)
    jmod = JPointMLP((16, 8, 32), dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    vs = _f32(jmod.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False))
    stats = {k: (np.asarray(v) + np.abs(rng.normal(size=v.shape)) * 0.3).astype(np.float32)
             for k, v in vs["batch_stats"].items()}
    vs = {"params": jax.tree.map(np.asarray, vs["params"]), "batch_stats": stats}
    ref, mutated = jmod.apply(vs, jnp.asarray(x), train=True, bn_momentum=momentum, maxpool=True,
                              mutable=["batch_stats"])
    mod = load_flax_variables(
        PointMLP(11, (16, 8, 32), dtype=torch.bfloat16 if dtype == "bfloat16" else None), vs)
    out = mod(torch.from_numpy(x), train=True, bn_momentum=momentum, maxpool=True)
    tol = dict(atol=2e-2, rtol=0) if dtype == "bfloat16" else dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    # nothing is written before the commit; then the buffers hold the new statistics
    for name, old in stats.items():
        np.testing.assert_array_equal(getattr(mod, name).numpy(), old)
    commit_batch_stats(mod)
    assert not mod.pending
    for name, new in mutated["batch_stats"].items():
        np.testing.assert_allclose(getattr(mod, name).numpy(), np.asarray(new), atol=1e-6)
        assert np.abs(np.asarray(new) - stats[name]).max() > 1e-4


def test_point_mlp_second_call_updates_the_pending_statistics(rng):
    """Two train-mode calls before one commit (the siamese pyramid) chain
    their updates, as two mutable Flax calls do."""
    x1 = torch.from_numpy(rng.normal(size=(2, 20, 5)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(2, 20, 5)).astype(np.float32) * 2 + 1)
    once, twice = PointMLP(5, (7,)), PointMLP(5, (7,))
    twice.load_state_dict(once.state_dict())
    once(x1, train=True, bn_momentum=0.3)
    commit_batch_stats(once)
    once(x2, train=True, bn_momentum=0.3)
    commit_batch_stats(once)
    twice(x1, train=True, bn_momentum=0.3)
    twice(x2, train=True, bn_momentum=0.3)
    commit_batch_stats(twice)
    torch.testing.assert_close(twice.mean_0, once.mean_0, rtol=0, atol=0)
    torch.testing.assert_close(twice.var_0, once.var_0, rtol=0, atol=0)
    # kept where the caller says so, without reading the flag on the host
    before = twice.var_0.clone()
    twice(x1, train=True, bn_momentum=0.3)
    commit_batch_stats(twice, keep=torch.tensor(False))
    assert torch.equal(twice.var_0, before) and not twice.pending


# ---- loss and schedules --------------------------------------------------------


@pytest.mark.parametrize("with_exp_weights", [True, False])
def test_pwclonet_loss_matches_reference(rng, with_exp_weights):
    pred = rng.normal(size=(3, 4, 7)).astype(np.float32)
    gt = rng.normal(size=(3, 7)).astype(np.float32)
    gt[:, 3:] /= np.linalg.norm(gt[:, 3:], axis=-1, keepdims=True)
    s = np.array([0.3, -2.1], np.float32)
    j_loss, j_log = jlosses.pwclonet_loss(
        {"s_param": jnp.asarray(s)}, jnp.asarray(pred), jnp.asarray(gt),
        jlosses.PWCLONetLossConfig(with_exp_weights=with_exp_weights))
    t_loss, t_log = tlosses.pwclonet_loss(
        {"s_param": torch.from_numpy(s)}, torch.from_numpy(pred), torch.from_numpy(gt),
        tlosses.PWCLONetLossConfig(with_exp_weights=with_exp_weights))
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-6, rtol=1e-6)
    assert set(t_log) == set(j_log)
    for key, value in j_log.items():
        np.testing.assert_allclose(float(t_log[key]), float(value), atol=1e-6, rtol=1e-6,
                                   err_msg=key)
    assert tlosses.LEVEL_WEIGHTS == jlosses.LEVEL_WEIGHTS
    init = tlosses.init_loss_params()["s_param"]
    np.testing.assert_array_equal(init.detach().numpy(),
                                  np.asarray(jlosses.init_loss_params()["s_param"]))
    assert init.requires_grad


@pytest.mark.parametrize("warmup", [0, 50])
def test_schedules_match_reference(warmup):
    kw = dict(learning_rate=4e-3, lr_min=1e-6, total_steps=1000, warmup_steps=warmup,
              bn_decay_steps=100)
    j_lr, j_bn = jstate.make_schedules(jstate.TrainConfig(**kw))
    t_cfg = tstate.TrainConfig(**kw)
    for step in (0, 1, max(warmup - 1, 0), warmup, 500, 1000, 1010):
        np.testing.assert_allclose(float(tstate.learning_rate(t_cfg, step)), float(j_lr(step)),
                                   rtol=1e-6, err_msg=f"lr at {step}")
        np.testing.assert_allclose(tstate.bn_momentum(t_cfg, step), float(j_bn(step)),
                                   rtol=1e-6, err_msg=f"bn momentum at {step}")
    assert tstate.bn_momentum(t_cfg, 10_000) == t_cfg.bn_momentum_min
    # the optimizer reads the rate from its count of updates, a tensor
    np.testing.assert_allclose(float(tstate.learning_rate(t_cfg, torch.tensor(500))),
                               float(j_lr(500)), rtol=1e-6)


# ---- the whole network: forward + backward, one optimizer step ------------------


def test_train_forward_backward_matches_flax(reference):
    state = _port_state(reference["tree"])
    loss, log, grads = tstate.loss_and_grads(T_CFG, state, reference["batch"])
    np.testing.assert_allclose(float(loss), reference["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(log["loss"]), reference["loss"], rtol=1e-5)

    ref_grads = flatten_variables(reference["grads"])
    assert len(ref_grads) == len(grads)
    for path, want in ref_grads.items():
        key, transpose = _trainable_key(path)
        want = want.T if transpose else want
        np.testing.assert_allclose(grads[key].numpy(), want, rtol=0,
                                   atol=1e-4 + 1e-3 * np.abs(want).max(), err_msg=key)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-2

    commit_batch_stats(state.model)
    buffers = dict(state.model.named_buffers())
    ref_stats = flatten_variables(reference["new_stats"])
    assert len(ref_stats) == len(buffers)
    for path, want in ref_stats.items():
        # variances of the raw-coordinate encodings reach ~50, where one
        # float32 ulp is 4e-6: atol 1e-5 alone would ask for 2 ulps
        np.testing.assert_allclose(buffers[path.replace("/", ".")].numpy(), want, atol=1e-5,
                                   rtol=5e-6, err_msg=path)


def test_fused_eval_and_train_take_the_unfused_graph(reference):
    """``fused_eval=True`` is ignored in train mode, as in the reference."""
    fused_cfg = tstate.TrainConfig(model=PWCLONetConfig(**SMALL, fused_eval=True), total_steps=50)
    fused = load_flax_train_state(tstate.create_train_state(fused_cfg, 0, "cpu"), reference["tree"])
    plain = _port_state(reference["tree"])
    for m in fused.model.modules():
        if isinstance(m, PoseCalculator):
            m.dropout_rate = 0.0
    loss_f, _, grads_f = tstate.loss_and_grads(fused_cfg, fused, reference["batch"])
    loss_p, _, grads_p = tstate.loss_and_grads(T_CFG, plain, reference["batch"])
    assert torch.equal(loss_f, loss_p)
    assert all(torch.equal(grads_f[k], grads_p[k]) for k in grads_p)


def test_one_optimizer_step_matches_optax(reference):
    state = _port_state(reference["tree"])
    before = {k: v.detach().clone() for k, v in state.trainable().items()}
    log = tstate.train_step(T_CFG, state, reference["batch"])
    np.testing.assert_allclose(float(log["loss"]), float(reference["log"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(log["grad_norm"]), float(reference["log"]["grad_norm"]),
                               rtol=1e-3)
    assert not bool(log["skipped_nonfinite"])
    new = reference["new_tree"]
    assert state.step == int(new["step"]) == 1
    assert int(state.optimizer.count) == int(new["opt_state"]["count"]) == 1

    opt = state.optimizer.state_dict()
    after = state.trainable()
    new_params = {"net": new["params"], "loss": new["loss_params"]}
    old_params = {"net": reference["tree"]["params"], "loss": reference["tree"]["loss_params"]}
    grads = flatten_variables(reference["grads"])
    compared = 0
    for path, want in flatten_variables(new_params).items():
        key, transpose = _trainable_key(path)
        fix = (lambda a: a.T) if transpose else (lambda a: a)
        # Adam's first update is -lr * g / (|g| + 1e-8), about -lr * sign(g):
        # its slope in g is 1e-8 * lr / g^2, so where |g| is of the size of the
        # gradients' own disagreement (held to atol 1e-4 above) the update
        # follows that noise. Compare it where |g| > 1e-4; there an error of
        # 1e-4 in g moves the update by 1e-7
        mask = np.abs(fix(grads[path])) > 1e-4
        ref_update = fix(want) - fix(flatten_variables(old_params)[path])
        update = (after[key].detach() - before[key]).numpy()
        np.testing.assert_allclose(update[mask], ref_update[mask], atol=1e-6, rtol=0, err_msg=key)
        compared += int(mask.sum())
        for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            moment = fix(flatten_variables(new["opt_state"][theirs])[path])
            np.testing.assert_allclose(opt[ours][key].numpy(), moment, rtol=0,
                                       atol=1e-7 + 1e-3 * np.abs(moment).max(),
                                       err_msg=f"{ours} {key}")
    assert compared > 10_000


def test_estimate_batch_stats_matches_reference(reference):
    batches = _batches(3, seed=5)
    block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    with nn.intercept_methods(_no_dropout):
        new = jax.jit(lambda s, b, r: jstate.estimate_batch_stats(reference["model"], s, b, r))(
            reference["state"], {k: jnp.asarray(v) for k, v in block.items()}, jax.random.key(3))
    state = _port_state(reference["tree"])
    weights = {k: v.detach().clone() for k, v in state.trainable().items()}
    tstate.estimate_batch_stats(state, block)
    buffers = dict(state.model.named_buffers())
    for path, want in flatten_variables(jax.tree.map(np.asarray, new.batch_stats)).items():
        np.testing.assert_allclose(buffers[path.replace("/", ".")].numpy(), want, atol=1e-5,
                                   rtol=5e-6, err_msg=path)
    assert all(torch.equal(v, weights[k]) for k, v in state.trainable().items())
    assert state.step == 0


# ---- the port's own guarantees ---------------------------------------------------


def _snapshot(state):
    snap = copy.deepcopy(state.state_dict())
    snap.pop("generator")
    return snap


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_nan_batch_leaves_the_state_untouched():
    state = tstate.create_train_state(T_CFG, seed=3, device="cpu")
    good, bad = _batches(2, seed=7)
    tstate.train_step(T_CFG, state, good)  # moments and statistics away from their init
    before = _snapshot(state)
    bad["gt_params"][0, 1] = np.nan
    log = tstate.train_step(T_CFG, state, bad)
    assert bool(log["skipped_nonfinite"]) and not np.isfinite(float(log["loss"]))
    after = _snapshot(state)
    assert after.pop("step") == before.pop("step") + 1 == 2
    _assert_same(after, before)  # parameters, statistics, s_param, moments, update count
    assert not any(m.pending for m in state.model.modules() if isinstance(m, PointMLP))
    log = tstate.train_step(T_CFG, state, good)
    assert not bool(log["skipped_nonfinite"]) and np.isfinite(float(log["grad_norm"]))
    assert int(state.optimizer.count) == 2 and state.step == 3
    assert not torch.equal(state.optimizer.exp_avg, before["optimizer"]["exp_avg"]["loss.s_param"])


def test_fused_eval_follows_a_train_step():
    """The in-place update and the statistics' commit move the tensors'
    versions, so a fused model refolds: after a train step its eval forward
    is the unfused model's on the new weights, not the old fold's."""
    from pwclonet_pylidarslam_torch.models import PWCLONet

    fused_cfg = tstate.TrainConfig(model=PWCLONetConfig(**SMALL, fused_eval=True), total_steps=50)
    state = tstate.create_train_state(fused_cfg, seed=2, device="cpu")
    batch = _batches(1, seed=13)[0]
    before, _ = tstate.eval_step(fused_cfg, state, batch)  # folds the initial weights
    tstate.train_step(fused_cfg, state, batch)
    after, _ = tstate.eval_step(fused_cfg, state, batch)
    plain = PWCLONet(PWCLONetConfig(**SMALL), device="cpu")
    plain.load_state_dict(state.model.state_dict())
    with torch.inference_mode():
        want, _ = plain(torch.from_numpy(batch["xyz1"]), torch.from_numpy(batch["xyz2"]))
    torch.testing.assert_close(after, want, atol=1e-4, rtol=1e-3)
    assert float((after - before).abs().max()) > 1e-2


def test_dropout_is_seeded_and_scaled():
    head = PoseCalculator(16, hidden=64, generator=torch.Generator().manual_seed(0))
    ones = torch.ones(4, 64)
    g = torch.Generator().manual_seed(5)
    first, second = head._dropout(ones, True, g), head._dropout(ones, True, g)
    assert set(first.unique().tolist()) == {0.0, 2.0}  # kept entries scaled by 1 / (1 - 0.5)
    assert not torch.equal(first, second)  # the two branches draw different masks
    assert torch.equal(head._dropout(ones, False, g), ones)
    feats, mask = torch.randn(2, 8, 16), torch.softmax(torch.randn(2, 8, 16), dim=1)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        runs.append(head(feats, mask, train=True, generator=gen))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    q_eval, t_eval = head(feats, mask, train=False)
    assert not torch.equal(runs[0][1], t_eval)
    torch.testing.assert_close(torch.linalg.norm(q_eval, dim=-1), torch.ones(2))


def test_train_steps_equals_iterated_train_step():
    batches = _batches(3, seed=11)
    block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    blocked = tstate.create_train_state(T_CFG, seed=1, device="cpu")
    stepped = tstate.create_train_state(T_CFG, seed=1, device="cpu")
    logs = tstate.train_steps(T_CFG, blocked, block)
    assert logs["loss"].shape == (3,) and blocked.step == 3
    singles = [tstate.train_step(T_CFG, stepped, b) for b in batches]
    for key, values in logs.items():
        assert torch.equal(values, torch.stack([s[key] for s in singles])), key
    _assert_same(_snapshot(blocked), _snapshot(stepped))  # the same program: bit-equal
    assert float(logs["loss"][0]) != float(logs["loss"][1])


def test_train_state_converter_lands_every_leaf(reference):
    tree = reference["new_tree"]  # after one step: moments and count away from zero
    state = load_flax_train_state(tstate.create_train_state(T_CFG, seed=9, device="cpu"), tree)
    named = state.trainable()
    n_trainable = len(flatten_variables(tree["params"])) + 1
    assert len(named) == n_trainable
    opt = state.optimizer.state_dict()
    assert len(opt["exp_avg"]) == len(opt["exp_avg_sq"]) == n_trainable
    assert state.step == 1 and int(opt["count"]) == 1
    np.testing.assert_array_equal(state.loss_params["s_param"].detach().numpy(),
                                  tree["loss_params"]["s_param"])
    head = "PoseWarpRefinement_2/PoseCalculator_0/LinearHead_2/Dense_0/kernel"
    key = "net.PoseWarpRefinement_2.PoseCalculator_0.LinearHead_2.Dense_0.weight"
    np.testing.assert_array_equal(named[key].detach().numpy(),
                                  flatten_variables(tree["params"])[head].T)
    np.testing.assert_array_equal(opt["exp_avg"][key].numpy(),
                                  flatten_variables(tree["opt_state"]["mu"])[f"net/{head}"].T)
    np.testing.assert_array_equal(
        opt["exp_avg_sq"]["net.SetConv_0.PointMLP_0.kernel_0"].numpy(),
        tree["opt_state"]["nu"]["net"]["SetConv_0"]["PointMLP_0"]["kernel_0"])
    np.testing.assert_array_equal(opt["exp_avg"]["loss.s_param"].numpy(),
                                  tree["opt_state"]["mu"]["loss"]["s_param"])
    assert float(opt["exp_avg_sq"][key].abs().max()) > 0

    fresh = tstate.create_train_state(T_CFG, seed=9, device="cpu")
    missing = copy.deepcopy(tree)
    del missing["opt_state"]["mu"]["net"]["CostVolume_0"]["PointMLP_3"]["bias_0"]
    with pytest.raises(KeyError, match="CostVolume_0.PointMLP_3.bias_0"):
        load_flax_train_state(fresh, missing)
    missing = copy.deepcopy(tree)
    del missing["loss_params"]["s_param"]
    with pytest.raises(KeyError, match="s_param"):
        load_flax_train_state(fresh, missing)
    misshapen = copy.deepcopy(tree)
    misshapen["opt_state"]["nu"]["net"]["SetConv_1"]["PointMLP_0"]["scale_0"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_train_state(fresh, misshapen)
