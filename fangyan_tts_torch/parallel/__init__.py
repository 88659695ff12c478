"""Multi-process parallelism over a dp x fsdp x tp mesh
(fangyan_tts_tpu/parallel/): the mesh (mesh.py), the placement rules and
the sharding of modules (sharding.py), the explicit collectives of the
sharded forwards and steps (comm.py), a process launcher for tests and
scripts (launch.py) and a one-step dry run (dryrun.py).

Parameters stay plain local tensors, sliced by the port's own rules: the
CUDA kernels take plain tensors, the rules pick a dim for each parameter,
and the train steps take their gradients with their own grads_of.
"""

from .mesh import AXES, Mesh, local_mesh, make_mesh
from .sharding import batch_pspec, gather_module, param_pspec, placement_tree, shard_module

__all__ = ["AXES", "Mesh", "batch_pspec", "gather_module", "local_mesh", "make_mesh", "param_pspec",
           "placement_tree", "shard_module"]
