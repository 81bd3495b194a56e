"""Synthetic LiDAR sequences (numpy)."""
