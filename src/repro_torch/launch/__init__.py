"""Entry points of the PyTorch port (counterpart of ``repro.launch``)."""
