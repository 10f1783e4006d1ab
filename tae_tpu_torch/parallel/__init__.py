"""Multi-process training (counterpart of ``tae_tpu/parallel``): the
``(data, fsdp, tensor)`` mesh over ``torch.distributed``, each block split
over ``tensor`` and FSDP2 placement on the ``data`` × ``fsdp`` half."""

from tae_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    initialize_distributed,
    is_main_process,
    make_mesh,
)
from tae_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_slice,
    constrain_batch,
    param_placements,
    shard_model,
)
from tae_tpu_torch.parallel.tensor import split_model_  # noqa: F401
