"""Checkpoints of nested NamedTuples of tensors (PyTorch port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,  # noqa
                                               CheckpointError,
                                               committed_steps, latest_step,
                                               restore_checkpoint,
                                               restore_latest,
                                               restore_sim_state,
                                               save_checkpoint,
                                               save_sim_state)
