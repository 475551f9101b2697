"""Parallelism beyond data parallelism (counterpart of
``horovod_tpu/parallel``): sequence parallelism by ring attention and by
Ulysses, LM training over a (dp, sp) grid of processes, Megatron tensor
parallelism over a (dp, tp) grid, the 3D (dp, tp, sp) hybrid, Switch MoE
over a (dp, ep) grid, the GPipe pipeline over a pp axis, and the two-level
(host, cross-host) allreduce."""

from .hierarchical import (  # noqa: F401
    hierarchical_allreduce,
    make_hierarchical_allreduce,
    make_two_level_mesh,
)

from .ring_attention import (  # noqa: F401
    make_ring_attention,
    reference_attention,
    ring_attention,
)
from .sp_training import (  # noqa: F401
    make_dp_sp_mesh,
    make_sp_forward,
    make_sp_train_step,
    replicate_to_mesh,
    sp_model,
)
from .sequence import (  # noqa: F401
    heads_to_seq,
    make_ulysses_attention,
    seq_to_heads,
    ulysses_attention,
)
from .tensor import (  # noqa: F401
    make_2d_mesh,
    make_dp_tp_mesh,
    make_tp_train_step,
    plain_attention,
    shard_batch_dp,
    shard_params_tp,
    shard_state_dict_tp,
    tp_param_shardings,
    tp_param_spec,
)
from .hybrid import (  # noqa: F401
    hybrid_model,
    make_dp_tp_sp_mesh,
    make_hybrid_train_step,
    shard_data_hybrid,
    shard_opt_state_hybrid,
    shard_params_hybrid,
)
from .expert import (  # noqa: F401
    MoEMLP,
    make_dp_ep_mesh,
    make_ep_train_step,
    shard_params_ep,
)
from .pipeline import (  # noqa: F401
    make_pipeline_fn,
    make_pp_mesh,
    make_pp_train_step,
    shard_stage_params,
    stack_stage_params,
)
