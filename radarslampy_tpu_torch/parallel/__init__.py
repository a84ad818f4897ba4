"""The distributed back-end on torch.distributed (see mesh.py)."""
