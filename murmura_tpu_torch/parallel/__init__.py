"""Param-axis sharding over a ``torch.distributed`` group: the layout and
collectives (mesh.py) and the launcher of the ranks (launch.py)."""
