"""Evaluation and training steps, the device mesh, ZeRO and FSDP, pipeline,
expert and sequence (time-sharded) parallelism."""

from .dist import initialize  # noqa: F401
from .evaluate import make_eval_step, sharded_accuracy_step  # noqa: F401
from .mesh import (batch_sharding, global_batch, make_mesh,  # noqa: F401
                   model_shardings, place_model, sharded_apply)
from .moe import (expert_sharding, moe_apply,  # noqa: F401
                  mstrn_expert_apply, mstrn_expert_params,
                  mstrn_expert_spec, trn_expert_forward)
from .pipeline import (pipeline_apply, pipeline_apply_stages,  # noqa: F401
                       sequential_apply, stack_block_params, stage_sharding)
from .seq import seq_parallel  # noqa: F401
from .train import make_train_step  # noqa: F401
from .zero import (sharded_size_bytes, tree_axis_shardings,  # noqa: F401
                   zero_init)
