from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.clip import (clip_array_by_norm, clip_by_global_norm,
                                    global_norm)
from repro_torch.optim.schedule import constant, step_decay
from repro_torch.optim.sgd import SGDState, sgd_momentum

__all__ = ["AdamWState", "adamw", "SGDState", "sgd_momentum",
           "clip_array_by_norm", "clip_by_global_norm", "global_norm",
           "constant", "step_decay"]
