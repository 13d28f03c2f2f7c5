"""The training data pipeline of the PyTorch port (counterpart of
``repro.data``)."""
from repro_torch.data.pipeline import Cursor, DataPipeline  # noqa: F401
