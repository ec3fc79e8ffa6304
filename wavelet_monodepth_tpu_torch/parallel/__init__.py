"""Data-parallel training over torch.distributed (`mesh.py`)."""
