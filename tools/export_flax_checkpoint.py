#!/usr/bin/env python
"""Write a reference (JAX) trainer's orbax checkpoint as one ``.npz`` of numpy
leaves that the PyTorch port loads without JAX.

    python tools/export_flax_checkpoint.py --log_dir ./train_out \
        --num_points 8192 --out ./train_out/state.npz [--step N]

The checkpoint is restored through ``PWCLONetTrainer.load_checkpoint`` of
``pwclonet_pylidarslam_tpu`` (the model config is rebuilt from
``--num_points`` by ``scaled_model_config``, as ``train_net.py`` does), and
the whole train state goes into the file under flattened paths:
``params/...``, ``batch_stats/...``, ``loss_params/s_param``,
``opt_state/count``, ``opt_state/mu/{net,loss}/...``,
``opt_state/nu/{net,loss}/...`` and ``step``. In the port,
``models/convert.py::load_flax_npz`` reads the file back into a tree;
``load_flax_variables`` takes its ``params`` and ``batch_stats`` for
inference (``PWCLONetOdometry`` accepts the tree as it is) and
``load_flax_train_state`` the whole of it to go on training.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def train_state_to_tree(state) -> Dict:
    """A reference ``TrainState`` as nested dicts of numpy arrays."""
    import jax

    adam = next(s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    to_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {
        "params": to_numpy(state.params),
        "batch_stats": to_numpy(state.batch_stats),
        "loss_params": to_numpy(state.loss_params),
        "opt_state": {"count": np.asarray(adam.count), "mu": to_numpy(adam.mu),
                      "nu": to_numpy(adam.nu)},
        "step": np.asarray(state.step),
    }


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, child in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(child, dict):
            flat.update(flatten_tree(child, path))
        else:
            flat[path] = np.asarray(child)
    return flat


def export_train_state(state, out_path) -> int:
    """Write ``state`` to ``out_path`` (``.npz``); returns the number of leaves."""
    flat = flatten_tree(train_state_to_tree(state))
    np.savez(out_path, **flat)
    return len(flat)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log_dir", required=True, help="the reference trainer's log_dir")
    parser.add_argument("--num_points", type=int, default=8192)
    parser.add_argument("--step", type=int, default=None, help="default: the latest checkpoint")
    parser.add_argument("--out", required=True, help="the .npz to write")
    args = parser.parse_args(argv)

    from pwclonet_pylidarslam_tpu.models import scaled_model_config
    from pwclonet_pylidarslam_tpu.train.state import TrainConfig
    from pwclonet_pylidarslam_tpu.train.trainer import PWCLONetTrainer, TrainerConfig

    trainer = PWCLONetTrainer(TrainerConfig(
        train=TrainConfig(model=scaled_model_config(args.num_points)), log_dir=args.log_dir))
    trainer.load_checkpoint(args.step)
    n = export_train_state(trainer.state, args.out)
    print(f"wrote {n} leaves of step {int(trainer.state.step)} to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
