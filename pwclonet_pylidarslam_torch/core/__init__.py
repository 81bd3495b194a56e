"""SO(3) and SE(3) math in PyTorch."""
