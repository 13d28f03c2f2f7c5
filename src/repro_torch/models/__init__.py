"""The LM stack of the PyTorch port: every config of ``repro_torch.configs``."""
from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.plan import Plan  # noqa: F401
