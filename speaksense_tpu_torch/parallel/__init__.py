"""Multi-GPU serving: the counterpart of `speaksense_tpu/parallel`.

A (dp, tp) mesh of ranks, one process per GPU: the model tensor-parallel
over tp (Megatron layout, `mesh.py`), the slot pool's rows over dp, data
parallel across hosts (`multihost.py`), and the followers that run the
leader's device calls on their shards (`workers.py`).
"""

from speaksense_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_shardings,
    cache_shardings,
    pool_state_shardings,
    shard_params,
    shard_pool_state,
)
from speaksense_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    local_serving_mesh,
)
