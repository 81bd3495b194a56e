"""The learning gate of the port: the fast-lane recipe of the reference's
``tests/test_deep_odometry_accuracy.py`` run by ``pwclonet_pylidarslam_torch``
on the CPU, from the reference's seed-0 initial state carried across.

The dropout masks are the port's own, so this is another draw of the recipe
than the reference's seed-0 run (ratio 0.20): the bar is the upper end of
the reference's cross-seed spread, 0.20-0.38 (``docs/deep_gate_spread.json``).
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.train.fast_lane import SMALL, run_fast_lane_recipe
from pwclonet_pylidarslam_tpu.models import PWCLONetConfig as JPWCLONetConfig
from pwclonet_pylidarslam_tpu.train import state as jstate


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread (the synthetic caster's among
    them): with several test workers on one machine, torch's thread pool
    per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_spec = importlib.util.spec_from_file_location(
    "export_flax_checkpoint",
    Path(__file__).resolve().parents[1] / "tools" / "export_flax_checkpoint.py")
export_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(export_tool)


def test_trained_pwclonet_beats_untrained_on_heldout_world():
    j_model = JPWCLONetConfig(num_points=SMALL.num_points, sa_npoints=SMALL.sa_npoints,
                              sa_nsamples=SMALL.sa_nsamples)
    _, j_state = jstate.create_train_state(jstate.TrainConfig(model=j_model), jax.random.key(0))
    tree = export_tool.train_state_to_tree(j_state)
    r = run_fast_lane_recipe(device="cpu", epochs=40, init_tree=tree)
    print(f"fast-lane recipe on the CPU: ratio {r['ratio']:.4f}, ATEs {r['ates']}, "
          f"untrained {r['untrained_ate']:.4f}, losses {r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}")
    assert r["steps"] == 240 and len(r["losses"]) == 40
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0], r["losses"]
    assert r["finite"]
    # absolute: relative-pose RMSE under 0.40 x the per-frame travel
    assert r["ratio"] < 0.40, (r["ates"], r["travel"])
    # secondary: clearly beats the untrained net (whose ATE is about the travel)
    assert r["ates"][0] < 0.6 * r["untrained_ate"], (r["ates"][0], r["untrained_ate"])
