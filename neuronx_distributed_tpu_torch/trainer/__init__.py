"""Training (counterpart of ``neuronx_distributed_tpu/trainer``): the train
step (``trainer.py``), the loop with its callbacks (``loop.py``),
checkpoints (``checkpoint.py``), the fault injector (``faults.py``) and the
data sources (``data.py``). The JAX package's ``TrainingConfig``,
``neuronx_distributed_tpu_config``, ``initialize_parallel_model``,
``initialize_parallel_optimizer`` and ``shard_batch`` set up a mesh; they
come with multi-GPU training (ROADMAP item 9)."""

from neuronx_distributed_tpu_torch.trainer.loop import (
    Callback,
    CheckpointCallback,
    HooksCallback,
    MetricsLogger,
    ProgressBar,
    ThroughputMeter,
    Trainer,
    TrainerHalted,
    TrainerHealth,
)
from neuronx_distributed_tpu_torch.trainer.trainer import (
    AnomalyGuardConfig,
    OptimizerConfig,
    TrainState,
    build_train_step,
    create_train_state,
    init_anomaly_guard_state,
    make_optimizer,
)

__all__ = [
    "AnomalyGuardConfig",
    "Callback",
    "CheckpointCallback",
    "HooksCallback",
    "MetricsLogger",
    "OptimizerConfig",
    "ProgressBar",
    "ThroughputMeter",
    "TrainState",
    "Trainer",
    "TrainerHalted",
    "TrainerHealth",
    "build_train_step",
    "create_train_state",
    "init_anomaly_guard_state",
    "make_optimizer",
]
