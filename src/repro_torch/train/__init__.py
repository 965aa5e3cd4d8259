from repro_torch.train.optim import AdamWConfig, init_state, apply_updates
from repro_torch.train.train_step import (DPState, TrainState,
                                          compressed_psum, init_train_state,
                                          make_dp_shard_map_step,
                                          make_train_step)
