from atray.dist.mesh import (
    make_device_mesh,
    render_sharded,
    trace_sharded,
)
from atray.dist.train import make_train_step
from atray.dist.treelet import (
    build_treelet_accels,
    build_treelet_parts,
    build_treelets,
    render_treelet,
)
