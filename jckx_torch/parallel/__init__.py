from jckx_torch.parallel.mesh import (  # noqa: F401
    A13B,
    DATA_AXIS,
    MODEL_AXIS,
    LocalMesh,
    ProcessMesh,
    check_mesh,
    local_batch_size,
    make_mesh,
    parse_mesh_axes,
    parse_mesh_shape,
    process_mesh,
)
