from mirage_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_count,
    batch_rank,
    init_distributed,
    local_batch,
    make_mesh,
)
