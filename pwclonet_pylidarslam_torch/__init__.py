"""PyTorch + CUDA port of ``pwclonet_pylidarslam_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its layout
(``core/``, ``ops/``, ``models/``, ``train/``, ``slam/``, ``evaluation/``,
``data/``, ``utils/``) so each counterpart sits at the same path. It imports
torch and numpy, never JAX or the JAX package. Layout is channel-last ``(B, N, C)`` and indices are
int32 at the public functions, as in the reference.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On CUDA tensors the point ops launch the hand-written kernels of ``csrc/``;
on CPU tensors they run the plain PyTorch versions the kernels are held to.
Every module of the JAX package has its counterpart here (see ROADMAP.md).
"""

from pwclonet_pylidarslam_torch.device import resolve_device

__all__ = ["resolve_device"]
