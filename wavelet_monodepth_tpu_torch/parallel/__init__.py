"""Multi-rank execution over torch.distributed: data-parallel training
and height-banded (spatial) inference (`mesh.py`, `spatial_hints.py`)."""
