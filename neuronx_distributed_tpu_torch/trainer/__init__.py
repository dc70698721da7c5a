"""Training (counterpart of ``neuronx_distributed_tpu/trainer``): the public
names of the JAX ``trainer/__init__.py`` that this port has so far."""

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
    "OptimizerConfig",
    "TrainState",
    "build_train_step",
    "create_train_state",
    "init_anomaly_guard_state",
    "make_optimizer",
]
