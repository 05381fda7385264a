"""Multi-device parallel layer: the mesh, sharded match and composite, and
multi-process runs on torch.distributed (the torch counterpart of
`emosaic_tpu/parallel/`)."""

from emosaic_tpu_torch.parallel.distributed import (  # noqa: F401
    fetch,
    init_distributed,
    is_multiprocess,
)
from emosaic_tpu_torch.parallel.lut import sharded_build_l1_lut  # noqa: F401
from emosaic_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from emosaic_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_l1_argmin,
    sharded_l1_argmin_ring,
    sharded_l1_topk,
    sharded_l1_topk_adaptive,
    sharded_mosaic_step,
)
