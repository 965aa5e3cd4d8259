from repro_torch.train.optim import AdamWConfig, init_state, apply_updates
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)
