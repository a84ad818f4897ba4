"""Checkpoint and resume of the SLAM state."""
