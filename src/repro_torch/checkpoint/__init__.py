from repro_torch.checkpoint.ckpt import (latest_experiment_cycle,
                                         latest_step, load_experiment,
                                         restore_checkpoint,
                                         save_checkpoint, save_experiment)

__all__ = ["latest_experiment_cycle", "latest_step", "load_experiment",
           "restore_checkpoint", "save_checkpoint", "save_experiment"]
