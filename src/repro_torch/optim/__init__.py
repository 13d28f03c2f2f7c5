"""Optimizer, LR schedule and gradient compression of the PyTorch port
(counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa
from repro_torch.optim.compress import ef_init, ef_int8_compress  # noqa
from repro_torch.optim.schedule import cosine_schedule  # noqa
