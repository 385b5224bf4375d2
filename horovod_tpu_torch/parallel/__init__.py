"""Model parallelism over the rank mesh.

Counterpart of ``horovod_tpu/parallel``: the data-parallel exchange lives
in ``collectives`` / ``optim``; this package adds the model-parallel
axes -- tensor (:mod:`.tp`), sequence (:mod:`.sequence`: ring attention,
Ulysses), pipeline (:mod:`.pipeline`) and expert (:mod:`.moe`)
parallelism -- as functions every rank of a :mod:`.mesh` mesh runs on
its own shard, with the collectives on the sets of the named axes.
"""

from .mesh import (  # noqa: F401
    DATA_AXIS, DCN_AXIS, DP_AXIS, EP_AXIS, FLAT_AXES, HIER_AXES, HVD_AXIS,
    ICI_AXIS, MODEL_AXIS, MODEL_PARALLEL_AXES, PARALLEL_AXES, PIPE_AXIS,
    PP_AXIS, SP_AXIS, THREED_AXES, TP_AXIS, RankMesh, axis_set,
    build_3d_mesh, build_mesh, build_parallel_mesh, current_mesh, data_axes,
    mesh_axes, mesh_size, model_axes,
)
from .tp import (  # noqa: F401
    column_parallel, copy_to_tp, gather_tp_params, reduce_from_tp,
    row_parallel, shard_params, shard_tp_params, tp_mlp, tp_param_specs,
)
from .sequence import ring_attention, ulysses_attention  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_apply, split_microbatches, stack_stage_params,
)
from .moe import (  # noqa: F401
    init_moe_params, moe_ffn, resolve_moe_compression,
)
