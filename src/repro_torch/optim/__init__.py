from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = [
    "Optimizer", "sgd", "momentum", "adam",
    "constant", "cosine_decay", "linear_warmup", "warmup_cosine",
]
