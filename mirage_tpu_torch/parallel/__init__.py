from mirage_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ServeMesh,
    batch_count,
    batch_rank,
    init_distributed,
    local_batch,
    make_mesh,
    make_serve_mesh,
)
from mirage_tpu_torch.parallel.pp import (  # noqa: F401
    is_pp,
    pp_encoder_apply,
    pp_grad_kind,
    pp_param_specs,
)
