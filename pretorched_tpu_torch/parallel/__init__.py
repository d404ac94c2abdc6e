"""Evaluation and training steps, the device mesh, ZeRO and FSDP."""

from .dist import initialize  # noqa: F401
from .evaluate import make_eval_step, sharded_accuracy_step  # noqa: F401
from .mesh import (batch_sharding, global_batch, make_mesh,  # noqa: F401
                   model_shardings, place_model)
from .train import make_train_step  # noqa: F401
from .zero import (sharded_size_bytes, tree_axis_shardings,  # noqa: F401
                   zero_init)
