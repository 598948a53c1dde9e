from .trainer import (  # noqa: F401
    TrainConfig,
    cross_entropy_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from .checkpoint import (  # noqa: F401
    latest_step,
    restore_train_state,
    save_train_state,
)
