"""Parallelism beyond data parallelism (counterpart of
``horovod_tpu/parallel``): sequence parallelism by ring attention and by
Ulysses, and LM training over a (dp, sp) grid of processes."""

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
