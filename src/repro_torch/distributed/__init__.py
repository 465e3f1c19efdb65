# Mesh helpers of the port: ("data", "model") process groups over torch.distributed.
from .mesh import AXES, Mesh, default_mesh, make_mesh  # noqa: F401
