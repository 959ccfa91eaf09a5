from .recompute import recompute, recompute_sequential  # noqa: F401
# the reference's fleet namespace re-exports the mesh (A10, PR 17)
from ..mesh import ProcessMesh, set_mesh  # noqa: F401
