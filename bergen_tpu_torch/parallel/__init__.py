from bergen_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    get_mesh,
    init,
    rank,
    world_size,
)
