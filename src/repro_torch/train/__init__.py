from repro_torch.train.trainer import (
    StragglerMonitor,
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
    train_gemm_div,
)

__all__ = [
    "StragglerMonitor",
    "Trainer",
    "TrainerConfig",
    "init_train_state",
    "make_train_step",
    "train_gemm_div",
]
